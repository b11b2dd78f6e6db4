"""Port parity: fault injection (``repro_torch.core.faults``), the push-sum
topology matrices, ``simulate(push_sum=, fault_schedule=)`` and the
``Trainer(fault_schedule=)`` vs the JAX reference on the CPU.

Tolerances, with their reasons:
* bitwise: ``push_sum_matrix`` and ``global_push_matrix`` (the same numpy
  float64 arithmetic), every query of ``FaultSchedule`` (numpy's Philox
  streams), ``parse_fault_events``, the counters, and in the Trainer the
  rows of a dropped node (params and optimizer state, frozen while it is
  down) and ``w`` after a full-participation global round (snapped to
  ones);
* the mass ``Σw``: within 1e-3·n of n at every step of the seeded sweep
  (the reference's own bound); 1e-2 in the acceptance scenario, as the
  reference's test;
* ``simulate``: loss rtol 1e-5 (the reference's own cross-backend
  tolerance), mass atol 1e-5 and the final weight atol 1e-6 against the
  JAX ``backend="reference"`` run; the final consensus < 1e-6 in both
  (measured: loss 1.7e-7 relative, mass 2.9e-6);
* the Trainer (reduced pga-lm-100m at fp32 compute, SGD): params rtol
  1e-5, atol 1e-7 (``tests/test_torch_train.py``'s SGD tolerance: the
  forward and backward sum in another order), ``push_weight`` and the
  per-step mass atol 1e-6, loss and consensus rtol 1e-5; the consensus
  also atol 1e-10, since after a full-participation global round the
  de-biased rows differ by rounding only (the round is a dense ``1/n``
  W, each row summed in its own order: measured 7.2e-12 in the
  reference, 8.3e-12 in the port).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.configs import pga_lm_100m as jarch
from repro.core import faults as jfaults
from repro.core import topology as jtopo
from repro.core.algorithms import simulate as jsim
from repro.train.trainer import Trainer as JTrainer
from repro_torch import interop
from repro_torch.configs import base as tcfg_mod
from repro_torch.configs import pga_lm_100m as tarch
from repro_torch.core import faults as tfaults
from repro_torch.core import mixing as tmix
from repro_torch.core import topology as ttopo
from repro_torch.core.algorithms import simulate as tsim
from repro_torch.train import Trainer as TTrainer
from repro_torch.train.state import init_push_weight

torch.set_num_threads(2)

DIRECTED = list(ttopo.DIRECTED_TOPOLOGIES)


# ---------------------------------------------------------------------------
# Matrices and schedules, bitwise
# ---------------------------------------------------------------------------
def _out_weights(n, seed):
    rng = np.random.default_rng(seed)
    return [{0: 0.25, int(rng.integers(1, n)): 0.5, int(rng.integers(1, n)):
             0.25} for _ in range(n)]


@pytest.mark.parametrize("t", DIRECTED + ["ring", "one_peer_exp"])
@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("variant", ["full", "mask", "out_weights"])
def test_push_sum_matrix_bitwise(t, n, variant):
    active = np.ones(n, dtype=bool)
    ow = None
    if variant != "full":
        active[[0, n // 2 + 1]] = False
    if variant == "out_weights":
        ow = _out_weights(n, n)
    for step in range(3):
        want = jtopo.push_sum_matrix(t, n, step=step, active=active,
                                     out_weights=ow)
        got = ttopo.push_sum_matrix(t, n, step=step, active=active,
                                    out_weights=ow)
        np.testing.assert_array_equal(got, want)
        assert ttopo.is_column_stochastic(got)
    if variant == "full":
        np.testing.assert_array_equal(
            ttopo.push_sum_matrix(t, n, step=1),
            ttopo.mixing_matrix(t, n, step=1))


@pytest.mark.parametrize("n", [4, 8, 16])
def test_global_push_matrix_bitwise(n):
    active = np.ones(n, dtype=bool)
    np.testing.assert_array_equal(ttopo.global_push_matrix(n),
                                  jtopo.global_push_matrix(n))
    active[[1, n - 1]] = False
    np.testing.assert_array_equal(ttopo.global_push_matrix(n, active),
                                  jtopo.global_push_matrix(n, active))
    np.testing.assert_array_equal(
        ttopo.global_push_matrix(n, np.zeros(n, dtype=bool)), np.eye(n))
    for bad in (np.ones(n + 1, dtype=bool),):
        with pytest.raises(ValueError, match="active mask shape"):
            ttopo.push_sum_matrix("directed_ring", n, active=bad)
    assert ttopo.DIRECTED_TOPOLOGIES == jtopo.DIRECTED_TOPOLOGIES


def _schedules(n, mode, seed):
    kw = dict(n_nodes=n, drops={2: (1, n - 1), 5: (0,)},
              rejoins={4: (1,), 9: (0, n - 1)}, resample=mode, seed=seed)
    return jfaults.FaultSchedule(**kw), tfaults.FaultSchedule(**kw)


@pytest.mark.parametrize("mode", ["none", "hop", "peer"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_fault_schedule_queries_bitwise(mode, n):
    js, ts = _schedules(n, mode, seed=11 + n)
    for t in DIRECTED + ["one_peer_exp"]:
        assert ts.hop_superset(t) == js.hop_superset(t)
    for step in (0, 2, 3, 4, 7, 9, 12, 3):
        np.testing.assert_array_equal(ts.active_mask(step),
                                      js.active_mask(step))
        assert ts.out_weights(step) == js.out_weights(step)
        assert ts.events_before(step) == js.events_before(step)
        for t in DIRECTED:
            np.testing.assert_array_equal(ts.matrix(t, step),
                                          js.matrix(t, step))
        np.testing.assert_array_equal(
            ts.matrix("one_peer_exp", step, shift_step=step % 2),
            js.matrix("one_peer_exp", step, shift_step=step % 2))


def test_advance_state_dict_roundtrip():
    js, ts = _schedules(8, "peer", seed=3)
    for k in range(11):
        np.testing.assert_array_equal(ts.advance(k), js.advance(k))
    assert ts.state_dict() == js.state_dict() == {
        "steps_seen": 11, "drops_applied": 3, "rejoins_applied": 3}
    fresh = tfaults.FaultSchedule(n_nodes=8)
    fresh.load_state_dict(ts.state_dict())
    assert fresh.state_dict() == ts.state_dict()
    fresh.load_state_dict({})
    assert fresh.state_dict() == {"steps_seen": 0, "drops_applied": 0,
                                  "rejoins_applied": 0}


@pytest.mark.parametrize("spec", ["", "40:3,5;90:0", "7:2;7:1",
                                  " 3:1 ; ;8:2,2,0", "5:"])
def test_parse_fault_events_as_reference(spec):
    assert tfaults.parse_fault_events(spec) == \
        jfaults.parse_fault_events(spec)


def test_fault_schedule_validates_as_reference():
    for kw, match in ((dict(resample="bogus"), "resample"),
                      (dict(drops={0: (7,)}), "outside")):
        for mod in (jfaults, tfaults):
            with pytest.raises(ValueError, match=match):
                mod.FaultSchedule(n_nodes=4, **kw)
    assert tfaults.RESAMPLE_MODES == jfaults.RESAMPLE_MODES


# ---------------------------------------------------------------------------
# Mass conservation: the reference's seeded sweep, on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_mass_conserved_every_step_seeded_sweep(backend):
    """``tests/test_faults.py``'s sweep over (topology, n, drop pattern,
    resample mode), every round through the port's push-sum round."""
    rng = np.random.default_rng(123)
    for t in DIRECTED:
        for n in (4, 8, 16):
            for mode in ("none", "hop", "peer"):
                drops, rejoins = {}, {}
                for step in rng.choice(12, size=3, replace=False):
                    ids = rng.choice(n, size=rng.integers(1, max(2, n // 4)
                                                          + 1),
                                     replace=False)
                    drops[int(step)] = tuple(int(i) for i in ids)
                    rejoins[int(step) + 4] = drops[int(step)]
                fs = tfaults.FaultSchedule(n_nodes=n, drops=drops,
                                           rejoins=rejoins, resample=mode,
                                           seed=int(rng.integers(100)))
                x = torch.from_numpy(rng.standard_normal((n, 5)).astype(
                    np.float32))
                w = init_push_weight(n)
                for k in range(16):
                    W = fs.matrix(t, k)
                    assert ttopo.is_column_stochastic(W)
                    x, w = tmix.communicate_push_sum(
                        x, w, W=W, n_nodes=n, backend=backend)
                    mass = float(torch.sum(w))
                    assert abs(mass - n) < 1e-3 * n, (t, n, k, mass)


# ---------------------------------------------------------------------------
# simulate: the acceptance scenario and the resampling runs
# ---------------------------------------------------------------------------
def _quadratic(d=6, m=48):
    """The reference tests' least squares, its A and b drawn with numpy:
    0.5·mean((A x − b)²) and its full gradient, in both packages."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((m, d)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)

    def jloss(x):
        return 0.5 * jnp.mean((Aj @ x - bj) ** 2)

    def jgrad(xs, key, k):
        return jax.vmap(jax.grad(jloss))(xs)

    def tloss(x):
        return 0.5 * torch.mean((At @ x - bt) ** 2)

    def tgrad(xs, generator, k):
        return (xs @ At.T - bt) @ At / m

    return (jloss, jgrad), (tloss, tgrad), d


def _sim_pair(backend, schedule_kw, **kw):
    (jloss, jgrad), (tloss, tgrad), d = _quadratic()
    common = dict(algorithm="gossip_pga", lr=0.05, push_sum=True, **kw)
    j = jsim(grad_fn=jgrad, loss_fn=jloss, x0=jnp.zeros(d),
             backend="reference",
             fault_schedule=jfaults.FaultSchedule(**schedule_kw), **common)
    tfs = tfaults.FaultSchedule(**schedule_kw)
    t = tsim(grad_fn=tgrad, loss_fn=tloss, x0=torch.zeros(d),
             backend=backend, fault_schedule=tfs, device="cpu", **common)
    return j, t, tfs


def _assert_sim(j, t, n):
    np.testing.assert_array_equal(t["iteration"], j["iteration"])
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
    np.testing.assert_allclose(t["mass"], j["mass"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t["push_weight"], j["push_weight"], rtol=0,
                               atol=1e-6)
    assert t["mass"].shape == j["mass"].shape
    np.testing.assert_allclose(t["mass"], float(n), atol=1e-2)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_simulate_acceptance_scenario_matches_reference(backend):
    """``tests/test_faults.py``'s acceptance scenario: 16 nodes over
    directed_exp, nodes 3 and 11 dropped at step 12 and rejoined at 28,
    64 steps, H = 8."""
    j, t, fs = _sim_pair(
        backend, dict(n_nodes=16, drops={12: (3, 11)}, rejoins={28: (3, 11)},
                      seed=0),
        n=16, steps=64, topology="directed_exp", H=8, eval_every=8)
    _assert_sim(j, t, 16)
    assert t["consensus"][-1] < 1e-6 and j["consensus"][-1] < 1e-6
    assert fs.state_dict() == {"steps_seen": 64, "drops_applied": 2,
                               "rejoins_applied": 2}
    # step 63 is a full-participation global round: w snapped to ones
    np.testing.assert_array_equal(t["push_weight"], np.ones((16, 1)))


@pytest.mark.parametrize("mode", ["hop", "peer"])
def test_simulate_resampling_matches_reference(mode):
    j, t, _ = _sim_pair("pallas", dict(n_nodes=8, resample=mode, seed=5),
                        n=8, steps=48, topology="directed_exp", H=4,
                        eval_every=8)
    _assert_sim(j, t, 8)
    assert t["consensus"][-1] < 1e-5
    assert t["loss"][-1] < t["loss"][0]


def test_simulate_compressed_push_sum_matches_reference():
    """int8 gossip with error feedback under push-sum: the weight mixed
    exactly outside the codec, so the mass stays n."""
    (jloss, jgrad), (tloss, tgrad), d = _quadratic()
    kw = dict(algorithm="gossip_pga", n=8, steps=30, lr=0.05,
              topology="directed_exp", H=4, push_sum=True,
              compression="int8", error_feedback=True, eval_every=5)
    j = jsim(grad_fn=jgrad, loss_fn=jloss, x0=jnp.zeros(d), **kw)
    t = tsim(grad_fn=tgrad, loss_fn=tloss, x0=torch.zeros(d),
             backend="pallas", device="cpu", **kw)
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
    np.testing.assert_allclose(t["mass"], 8.0, atol=1e-3)


# ---------------------------------------------------------------------------
# The Trainer: drop node 1 at step 2, rejoin it at 4
# ---------------------------------------------------------------------------
def _trainer_configs():
    dist = dict(algorithm="gossip_pga", topology="directed_exp", H=2,
                comm_backend="pallas", push_sum=True)
    opt = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
    common = dict(global_batch=8, seq_len=32, log_every=1)
    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(**dist), optimizer=jcfg.OptimizerConfig(**opt),
        **common)
    tt = tcfg_mod.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg_mod.DistConfig(**dist),
        optimizer=tcfg_mod.OptimizerConfig(**opt), **common)
    return jt, tt


def _faults(mod):
    return mod.FaultSchedule(n_nodes=4, drops={2: (1,)}, rejoins={4: (1,)},
                             seed=0)


def _rows(tree, i):
    return [np.array(lf[i]) for lf in jax.tree.leaves(tree)
            if np.ndim(lf) and np.shape(lf)[0] == 4]


def test_trainer_drop_rejoin_matches_reference():
    n, steps = 4, 6
    jt, tt = _trainer_configs()
    jtr = JTrainer(jt, n_nodes=n, with_consensus=True,
                   fault_schedule=_faults(jfaults))
    ttr = TTrainer(tt, n_nodes=n, with_consensus=True,
                   fault_schedule=_faults(tfaults), device="cpu")
    jst = jtr.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree.map(lambda p: np.asarray(p[0]),
                        jax.device_get(jst.params))
    tst = ttr.init_state(params=interop.from_numpy(row0, "cpu"))
    assert sorted(tst.extras) == sorted(jst.extras) == ["push_weight"]
    jrows, trows = [], []
    for _ in range(steps):
        jst = jtr.run(jst, steps=1, log_every=1)
        tst = ttr.run(tst, steps=1, log_every=1)
        jh = jax.device_get((jst.params, jst.opt_state))
        th = interop.to_numpy((tst.params, tst.opt_state))
        jrows.append(_rows(jh, 1))
        trows.append(_rows(th, 1))
    phases = ["gossip", "global"] * 3
    assert [r["phase"] for r in ttr.history] == \
        [r["phase"] for r in jtr.history] == phases
    for jr, tr in zip(jtr.history, ttr.history):
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-5)
        np.testing.assert_allclose(tr["consensus"], jr["consensus"],
                                   rtol=1e-5, atol=1e-10)
        np.testing.assert_allclose(tr["mass"], jr["mass"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(tr["mass"], 4.0, rtol=0, atol=1e-5)
    # node 1 is down at steps 2 and 3: its params and momentum rows stay
    # bitwise those after step 1, in both packages
    for rows in (jrows, trows):
        for k in (2, 3):
            for a, b in zip(rows[k], rows[1]):
                np.testing.assert_array_equal(a, b)
        assert any(not np.array_equal(a, b)
                   for a, b in zip(rows[4], rows[1]))
    for a, b in zip(jax.tree.leaves(jax.device_get(jst.params)),
                    jax.tree.leaves(interop.to_numpy(tst.params))):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
    # step 5 is a full-participation global round: w bitwise ones
    np.testing.assert_array_equal(tst.push_weight.numpy(), np.ones((n, 1)))
    np.testing.assert_array_equal(np.asarray(jst.push_weight),
                                  np.ones((n, 1)))
    assert ttr.fault_schedule.state_dict() == \
        jtr.fault_schedule.state_dict()


def test_trainer_fault_checks_as_reference():
    jt, tt = _trainer_configs()
    no_push = dict(push_sum=False, topology="ring")
    for mod, cfg, trainer, kw in (
            (jfaults, jt, JTrainer, {}),
            (tfaults, tt, TTrainer, dict(device="cpu"))):
        plain = cfg.replace(dist=dataclasses.replace(cfg.dist, **no_push)) \
            if hasattr(cfg, "replace") else dataclasses.replace(
                cfg, dist=dataclasses.replace(cfg.dist, **no_push))
        with pytest.raises(ValueError, match="requires DistConfig.push_sum"):
            trainer(plain, n_nodes=4, fault_schedule=_faults(mod), **kw)
        with pytest.raises(ValueError, match="built for 4 nodes"):
            trainer(cfg, n_nodes=8, fault_schedule=_faults(mod), **kw)
