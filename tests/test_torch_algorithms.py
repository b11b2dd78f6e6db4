"""Port parity: the paper's simulator and the algorithm hooks,
``repro_torch.core.algorithms.simulate`` / ``core.algo`` against the JAX
package's on the CPU.

Setup: the §5.1 logistic problem at n = 8, M = 64, d = 10, full gradients
(the stochastic index streams differ by construction, ROADMAP C.3), ring,
40 steps, ``eval_every=5``, every algorithm on both backends (the
reference's fused path runs its Pallas kernel in interpret mode, as its
own tests run it).  Tolerances, with their reasons:

* loss rtol 2e-6 and consensus rtol 5e-6 + atol 1e-12: fp32 einsums and
  mixing sums in another order, over 40 steps (measured: loss 4.5e-7,
  consensus 1.1e-6 relative).  The atol covers the global rounds, where
  the port's consensus is exactly 0.0 and the reference's is rounding
  noise (at most 3.5e-16);
* int8 gossip + EF and the int8 collective (gossip_pga, hier_pga): the
  codes are equal on equal inputs; loss rtol 2e-6, consensus rtol 5e-5
  (measured: loss 3.6e-7, consensus 8.0e-6 relative);
* Gossip-AGA's ``H_history``: equal exactly;
* hier_pga on the fused backend: the reference's fused simulator path
  passes no ``n_pods`` to its kernel, so its pod rounds average over all
  nodes (a reference fault, ROADMAP C.4); the port does the same and is
  held to that trajectory;
* SlowMo's ``post_round`` and GT's ``pre_update`` on random trees: rtol
  1e-6, atol 1e-7 (fp32 elementwise arithmetic in the same order);
* push-sum runs (gossip_pga over the ring, with and without a fault
  schedule): loss rtol 1e-5, the per-step mass and the final weight atol
  1e-5 (the de-biased read ``Σx/Σw`` adds a division and two sums in
  another order; ``tests/test_torch_faults.py`` holds the rest);
* the push-sum weight slot (``node_scalar``): bitwise.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DistConfig as JDist
from repro.core import algo as jalgo
from repro.core import schedule as jsched
from repro.core import simulate as jsim
from repro.data import make_logistic_problem as jproblem
from repro_torch import interop
from repro_torch.configs.base import DataConfig, DistConfig, TrainConfig
from repro_torch.configs.pga_lm_100m import reduced_config
from repro_torch.core import algo as talgo
from repro_torch.core import simulate as tsim
from repro_torch.core.algorithms import Decentralized
from repro_torch.core.schedule import make_schedule
from repro_torch.data import make_logistic_problem as tproblem

torch.set_num_threads(2)

ALGORITHMS = ("parallel", "gossip", "local", "gossip_pga", "gossip_aga",
              "slowmo", "hier_pga", "gt_pga")
N, M, D, STEPS, EVAL = 8, 64, 10, 40, 5
INT8_EF = dict(compression="int8", error_feedback=True,
               global_compression="int8")


@pytest.fixture(scope="module")
def problems():
    return (jproblem(n=N, M=M, d=D, seed=0),
            tproblem(n=N, M=M, d=D, seed=0, device="cpu"))


def _kwargs(algorithm, backend, **extra):
    kw = dict(algorithm=algorithm, n=N, steps=STEPS, lr=0.2, H=8,
              topology="ring", eval_every=EVAL, backend=backend,
              slowmo_beta=0.5, slowmo_lr=0.7, **extra)
    if algorithm == "hier_pga":
        kw["aga_kwargs"] = {"n_pods": 2, "hier_h_pod": 3}
    if algorithm == "gossip_aga":
        kw["aga_kwargs"] = {"aga_h_init": 2, "aga_warmup": 10}
    return kw


def _run_pair(problems, algorithm, backend, ref_backend=None, **extra):
    jp, tp = problems
    want = jsim(grad_fn=jp.grad_fn(0), loss_fn=jp.loss_fn(),
                x0=jnp.zeros(D),
                **_kwargs(algorithm, ref_backend or backend, **extra))
    got = tsim(grad_fn=tp.grad_fn(0), loss_fn=tp.loss_fn(),
               x0=torch.zeros(D), device="cpu",
               **_kwargs(algorithm, backend, **extra))
    return want, got


def _eval_phases(algorithm, got):
    """The phase of each eval step, replayed through the port's schedule
    fed the run's own losses as ``simulate`` feeds them."""
    sched = make_schedule(DistConfig(algorithm=algorithm, H=8,
                                     **_kwargs(algorithm, "reference").get(
                                         "aga_kwargs", {})))
    losses = dict(zip(got["iteration"].tolist(), got["loss"].tolist()))
    phases, last = {}, None
    for k in range(STEPS):
        phases[k] = sched.advance(k)
        last = losses.get(k, last)
        if last is not None:
            sched.observe_loss(k, last)
    return [phases[k] for k in got["iteration"].tolist()]


@pytest.mark.parametrize("backend", ("reference", "pallas"))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_simulate_matches_reference(problems, algorithm, backend):
    want, got = _run_pair(problems, algorithm, backend)
    np.testing.assert_array_equal(got["iteration"], want["iteration"])
    assert len(got["loss"]) == len(range(0, STEPS, EVAL)) + 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-6)
    np.testing.assert_allclose(got["consensus"], want["consensus"],
                               rtol=5e-6, atol=1e-12)
    if algorithm == "gossip_aga":
        assert got["H_history"].tolist() == want["H_history"].tolist()
        assert len(set(got["H_history"].tolist())) > 1   # the period moved
    else:
        assert "H_history" not in got


@pytest.mark.parametrize("backend", ("reference", "pallas"))
@pytest.mark.parametrize("algorithm", ("gossip_pga", "hier_pga"))
def test_compressed_simulate_matches_reference(problems, algorithm,
                                               backend):
    want, got = _run_pair(problems, algorithm, backend, **INT8_EF)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-6)
    np.testing.assert_allclose(got["consensus"], want["consensus"],
                               rtol=5e-5)
    # the compensated collective keeps each node's own residual
    assert (got["consensus"] > 0).all()


@pytest.mark.parametrize("backend", ("reference", "pallas"))
@pytest.mark.parametrize("algorithm", ("parallel", "local", "gossip_pga",
                                       "gossip_aga", "hier_pga", "gt_pga"))
def test_consensus_exactly_zero_after_global_rounds(problems, algorithm,
                                                    backend):
    _, tp = problems
    got = tsim(grad_fn=tp.grad_fn(0), loss_fn=tp.loss_fn(),
               x0=torch.zeros(D), device="cpu",
               **_kwargs(algorithm, backend))
    phases = _eval_phases(algorithm, got)
    on_global = [c for c, ph in zip(got["consensus"], phases)
                 if ph == "global"]
    assert on_global, phases
    assert all(c == 0.0 for c in on_global), (phases, got["consensus"])
    # the fused path's pod rounds average over all nodes, as the
    # reference's do (ROADMAP C.4)
    mixing = ("gossip",) if backend == "pallas" else ("gossip", "pod_avg")
    assert all(c > 0.0 for c, ph in zip(got["consensus"], phases)
               if ph in mixing)
    assert all(c == 0.0 for c, ph in zip(got["consensus"], phases)
               if ph == "pod_avg" and backend == "pallas")


def test_fused_pod_round_averages_all_nodes_as_the_reference(problems):
    """The fused simulator path passes no ``n_pods`` to its kernel, as
    the reference's does, so hier_pga's pod rounds there average over all
    nodes (a reference fault kept for parity, ROADMAP C.4); the
    ``backend="reference"`` path averages per pod."""
    jp, tp = problems
    kw = _kwargs("hier_pga", "pallas")
    fused = tsim(grad_fn=tp.grad_fn(0), loss_fn=tp.loss_fn(),
                 x0=torch.zeros(D), device="cpu", **kw)
    plain = tsim(grad_fn=tp.grad_fn(0), loss_fn=tp.loss_fn(),
                 x0=torch.zeros(D), device="cpu",
                 **_kwargs("hier_pga", "reference"))
    ref_fused = jsim(grad_fn=jp.grad_fn(0), loss_fn=jp.loss_fn(),
                     x0=jnp.zeros(D), **kw)
    phases = _eval_phases("hier_pga", fused)
    pod = [i for i, ph in enumerate(phases) if ph == "pod_avg"]
    assert pod
    for i in pod:
        assert fused["consensus"][i] == 0.0
        assert ref_fused["consensus"][i] < 1e-12
        assert plain["consensus"][i] > 1e-6


def test_unported_options_raise_after_the_reference_checks(problems):
    jp, tp = problems
    kw0 = _kwargs("gossip_pga", "reference")
    jbase = dict(grad_fn=jp.grad_fn(0), loss_fn=jp.loss_fn(),
                 x0=jnp.zeros(D), **kw0)
    tbase = dict(grad_fn=tp.grad_fn(0), loss_fn=tp.loss_fn(),
                 x0=torch.zeros(D), device="cpu", **kw0)
    faults = types.SimpleNamespace(n_nodes=N)
    # the reference's own argument checks come first, with its messages
    for kw, match in ((dict(fault_schedule=faults), "requires push_sum"),
                      (dict(fault_schedule=types.SimpleNamespace(n_nodes=3),
                            push_sum=True), "built for 3 nodes")):
        with pytest.raises(ValueError, match=match):
            jsim(**jbase, **kw)
        with pytest.raises(ValueError, match=match):
            tsim(**tbase, **kw)
    # telemetry (ROADMAP A.6, ported): the run is the same with a hub,
    # which gets the reference's step records
    from repro import obs as jobs
    from repro_torch import obs
    tel, jtel = obs.Telemetry(), jobs.Telemetry()
    tel.sinks.append(obs.RingSink())
    jtel.sinks.append(jobs.RingSink())
    with_tel = tsim(**tbase, telemetry=tel)
    np.testing.assert_array_equal(with_tel["loss"], tsim(**tbase)["loss"])
    jsim(**jbase, telemetry=jtel)
    assert [(r["step"], r["phase"]) for r in tel.ring().records("step")] \
        == [(r["step"], r["phase"]) for r in jtel.ring().records("step")]
    # overlap (ROADMAP A.5, ported): the port runs what the reference
    # runs, to its trajectory, and refuses push-sum with it as it does
    jo = jsim(**jbase, overlap=True)
    to = tsim(**tbase, overlap=True)
    np.testing.assert_allclose(to["loss"], jo["loss"], rtol=2e-6)
    with pytest.raises(ValueError) as want:
        jsim(**{**jbase, "topology": "directed_ring"}, overlap=True,
             push_sum=True)
    with pytest.raises(ValueError) as got:
        tsim(**{**tbase, "topology": "directed_ring"}, overlap=True,
             push_sum=True)
    assert str(got.value) == str(want.value)
    # push-sum and faults (ROADMAP A.4, ported): the port runs what the
    # reference runs, to its trajectory
    from repro.core.faults import FaultSchedule as JFaults
    from repro_torch.core.faults import FaultSchedule as TFaults
    sched = dict(n_nodes=N, drops={6: (2, 5)}, rejoins={17: (2, 5)}, seed=1)
    for jfs, tfs in ((None, None), (JFaults(**sched), TFaults(**sched))):
        jo = jsim(**jbase, push_sum=True, fault_schedule=jfs)
        to = tsim(**tbase, push_sum=True, fault_schedule=tfs)
        np.testing.assert_allclose(to["loss"], jo["loss"], rtol=1e-5)
        for key in ("mass", "push_weight"):
            np.testing.assert_allclose(to[key], jo[key], rtol=0, atol=1e-5)


def test_simulate_defaults_to_the_card(problems):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, tp = problems
    kw = _kwargs("gossip", "reference")
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        tsim(grad_fn=tp.grad_fn(0), loss_fn=tp.loss_fn(),
             x0=torch.zeros(D), **kw)


def _random_tree(rng, lead=()):
    return {"w": rng.standard_normal(lead + (3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(lead + (7,)).astype(np.float32)}}


def _assert_trees(jtree, ttree, rtol=1e-6, atol=1e-7):
    jl = jax.tree.leaves(jax.device_get(jtree))
    tl = jax.tree.leaves(interop.to_numpy(ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


@pytest.mark.parametrize("lr", (0.05, 0.3))
def test_slowmo_post_round_matches_reference(lr):
    rng = np.random.default_rng(0)
    half = _random_tree(rng, (4,))
    extras = {"slow_params": _random_tree(rng), "slow_u": _random_tree(rng)}
    kw = dict(algorithm="slowmo", slowmo_beta=0.5, slowmo_lr=0.7)
    jctx = jalgo.StepContext(dist=JDist(**kw), n_nodes=4,
                             lr=jnp.float32(lr))
    tctx = talgo.StepContext(dist=DistConfig(**kw), n_nodes=4, lr=lr)
    for phase in ("slowmo", "gossip"):
        jp, je = jalgo.get_algorithm("slowmo").post_round(
            jax.tree.map(jnp.asarray, extras),
            {"params": jax.tree.map(jnp.asarray, half)}, phase, jctx)
        tp, te = talgo.get_algorithm("slowmo").post_round(
            interop.from_numpy(extras, "cpu"),
            {"params": interop.from_numpy(half, "cpu")}, phase, tctx)
        _assert_trees(jp, tp)
        _assert_trees(je, te)


def test_gt_pre_update_and_tracker_absorption_match_reference():
    rng = np.random.default_rng(1)
    extras = {"gt_tracker": _random_tree(rng, (4,)),
              "gt_prev_grad": _random_tree(rng, (4,))}
    grads = _random_tree(rng, (4,))
    ja, ta = jalgo.get_algorithm("gt_pga"), talgo.get_algorithm("gt_pga")
    jup, je = ja.pre_update(jax.tree.map(jnp.asarray, extras),
                            jax.tree.map(jnp.asarray, grads))
    tup, te = ta.pre_update(interop.from_numpy(extras, "cpu"),
                            interop.from_numpy(grads, "cpu"))
    _assert_trees(jup, tup)
    _assert_trees(je, te)
    assert ta.payload_names() == ja.payload_names() == ("gt_tracker",)
    assert ta.transforms_grads and ja.transforms_grads
    mixed = {"params": _random_tree(rng, (4,)),
             "gt_tracker": _random_tree(rng, (4,))}
    jx, je2 = ja.post_round(je, jax.tree.map(jnp.asarray, mixed), "gossip",
                            None)
    tx, te2 = ta.post_round(te, interop.from_numpy(mixed, "cpu"), "gossip",
                            None)
    _assert_trees(jx, tx)
    _assert_trees(je2, te2)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_registry_matches_reference(algorithm):
    ta, ja = talgo.get_algorithm(algorithm), jalgo.get_algorithm(algorithm)
    assert ta.phases == ja.phases
    assert ta.owned_phases == ja.owned_phases
    assert ta.transforms_grads == ja.transforms_grads
    assert ta.payload_names() == ja.payload_names()
    assert [(s.name, s.kind, s.init, s.payload) for s in ta.slots] == \
        [(s.name, s.kind, s.init, s.payload) for s in ja.slots]
    for ef in (False, True):
        kw = dict(algorithm=algorithm, comm_error_feedback=ef,
                  comm_compression="int8" if ef else "none")
        assert [s.name for s in talgo.state_slots(DistConfig(**kw))] == \
            [s.name for s in jalgo.state_slots(JDist(**kw))]
        params = _random_tree(np.random.default_rng(2), (4,))
        want = jalgo.init_extras(JDist(**kw),
                                 jax.tree.map(jnp.asarray, params), 4)
        got = talgo.init_extras(DistConfig(**kw),
                                interop.from_numpy(params, "cpu"), 4)
        assert sorted(got) == sorted(want)
        _assert_trees(want, got, rtol=0)
    assert talgo.algorithm_names() == jalgo.algorithm_names()
    assert talgo.known_slot_names() == jalgo.known_slot_names()


def test_row0_slot_is_a_copy_of_node_zero():
    params = {"w": torch.arange(12.0).reshape(4, 3)}
    slot = talgo.ExtraSlot("anchor", kind="unstacked", init="row0")
    got = slot.init_value(params, 4)
    assert torch.equal(got["w"], params["w"][0])
    params["w"][0] += 1.0
    assert torch.equal(got["w"], torch.arange(3.0))
    # the push-sum weight's kind (ROADMAP A.4, ported): an (n, 1) float32
    # column, zeros or ones, as the reference's
    for init in ("zeros", "ones"):
        got = talgo.ExtraSlot("w8", kind="node_scalar",
                              init=init).init_value(params, 4)
        want = jalgo.ExtraSlot("w8", kind="node_scalar",
                               init=init).init_value(params, 4)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _Lazy:
    """A loss observation that counts its host reads."""
    reads = 0

    def __init__(self, value):
        self.value = value

    def item(self):
        _Lazy.reads += 1
        return self.value


def test_aga_reads_a_lazy_loss_only_at_period_boundaries():
    sched = make_schedule(DistConfig(algorithm="gossip_aga", aga_h_init=3,
                                     aga_warmup=2, aga_h_max=5))
    _Lazy.reads = 0
    boundaries = 0
    for k in range(30):
        phase = sched.advance(k)
        boundaries += phase == "global"
        # one read per period boundary, none on the steps between
        assert _Lazy.reads == boundaries, k
        sched.observe_loss(k, _Lazy(1.0 / (k + 1)))
    assert boundaries == len(sched.history) > 3
    assert len(set(sched.history)) > 1
    before = _Lazy.reads
    state = sched.state_dict()
    assert _Lazy.reads == before + 1 and state["F_last"] == 1.0 / 30


def test_aga_state_round_trips_and_matches_reference():
    kw = dict(algorithm="gossip_aga", aga_h_init=2, aga_warmup=6,
              aga_h_max=9)
    ts, js = make_schedule(DistConfig(**kw)), jsched.make_schedule(JDist(**kw))
    losses = 2.0 / (1.0 + np.arange(40.0))
    for k in range(20):
        assert ts.peek_phase(k) == js.peek_phase(k)
        assert ts.advance(k) == js.advance(k)
        ts.observe_loss(k, torch.tensor(losses[k], dtype=torch.float32))
        js.observe_loss(k, jnp.asarray(losses[k], jnp.float32))
    state = ts.state_dict()
    assert state == js.state_dict()
    resumed = make_schedule(DistConfig(**kw))
    resumed.load_state_dict(state)
    for k in range(20, 40):
        assert resumed.advance(k) == js.advance(k) == ts.advance(k)
        for s in (resumed, ts):
            s.observe_loss(k, float(losses[k]))
        js.observe_loss(k, float(losses[k]))
    assert resumed.history == ts.history == js.history
    assert resumed.current_H == js.current_H


def test_decentralized_rounds_and_phases():
    dist = DistConfig(algorithm="hier_pga", topology="ring", H=4,
                      hier_h_pod=2, n_pods=2)
    algo = Decentralized(dist, 4)
    assert [algo.phase(k) for k in range(4)] == \
        ["gossip", "pod_avg", "gossip", "global"]
    assert Decentralized(dist, 1).advance(0) == "none"
    x = {"w": torch.arange(8.0).reshape(4, 2)}
    pod = algo.communicate(x, "pod_avg", 0)
    assert torch.equal(pod["w"], torch.tensor([[1.0, 2.0], [1.0, 2.0],
                                               [5.0, 6.0], [5.0, 6.0]]))
    glob = algo.communicate(x, "slowmo", 0)
    assert torch.equal(glob["w"], torch.full((4, 2), 3.0) +
                       torch.tensor([0.0, 1.0]))


def test_hier_pga_pods_must_divide_the_nodes():
    for cfg in (DistConfig, JDist):
        dist = cfg(algorithm="hier_pga", n_pods=3)
        with pytest.raises(ValueError, match="n_pods=3 does not divide"):
            dist.validate_nodes(4)
        dist.validate_nodes(6)
    DistConfig(algorithm="gossip_pga", n_pods=3).validate_nodes(4)


def test_logistic_data_kind_is_refused_by_the_trainer_config():
    """The reference's Trainer ignores ``DataConfig.kind`` and trains on
    the LM stream; the port refuses a logistic kind (ROADMAP C.3)."""
    tcfg = TrainConfig(model=reduced_config(),
                       data=DataConfig(kind="logistic"))
    with pytest.raises(ValueError, match="LM-only.*simulate"):
        tcfg.validate()


@pytest.mark.parametrize("compressed", (False, True))
@pytest.mark.parametrize("backend", ("reference", "pallas"))
def test_joint_payload_tree_rides_communicate(backend, compressed):
    """GT-PGA's joint round tree ``{"params", "gt_tracker"}`` through
    ``communicate`` on both backends, uncompressed and with int8 gossip +
    EF and the int8 collective, every phase (pod_avg included), against
    the JAX package's ``communicate`` on the same tree: the codes are equal
    on equal inputs, so rtol 1e-6, atol 1e-6 (measured: 1.1e-7 on an EF
    element near zero)."""
    from repro.compress import make_compressor as jmake
    from repro.core import mixing as jmix
    from repro_torch.compress import make_compressor as tmake
    from repro_torch.core import mixing as tmix

    rng = np.random.default_rng(3)
    joint = {"params": _random_tree(rng, (4,)),
             "gt_tracker": _random_tree(rng, (4,))}
    ef = jax.tree.map(lambda a: 0.01 * a, _random_tree(rng, (4,)))
    ef = {"params": ef, "gt_tracker": jax.tree.map(np.negative, ef)}
    names = ("int8", "int8") if compressed else ("none", "none")
    jspec = jmix.CommSpec(topology="ring", n_nodes=4, n_pods=2,
                          backend=backend, compressor=jmake(names[0]),
                          global_compressor=jmake(names[1])).validate()
    tspec = tmix.CommSpec(topology="ring", n_nodes=4, n_pods=2,
                          backend=backend, compressor=tmake(names[0]),
                          global_compressor=tmake(names[1])).validate()
    for phase in ("gossip", "pod_avg", "global"):
        kw = dict(ef_state=ef, seed=7) if compressed else {}
        want = jmix.communicate(
            jax.tree.map(jnp.asarray, joint), jspec, phase=phase, step=1,
            **{k: jax.tree.map(jnp.asarray, v) if k == "ef_state" else v
               for k, v in kw.items()})
        got = tmix.communicate(
            interop.from_numpy(joint, "cpu"), tspec, phase=phase, step=1,
            **{k: interop.from_numpy(v, "cpu") if k == "ef_state" else v
               for k, v in kw.items()})
        if compressed:
            (want, want_ef), (got, got_ef) = want, got
            _assert_trees(want_ef, got_ef, rtol=1e-6, atol=1e-6)
        assert sorted(got) == ["gt_tracker", "params"]
        _assert_trees(want, got, rtol=1e-6, atol=1e-6)
