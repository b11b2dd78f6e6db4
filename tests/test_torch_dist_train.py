"""Port parity: the Trainer on a rank mesh (one ``torch.distributed`` rank
per node shard) on the CPU.

Reduced pga-lm-100m at fp32, 8 nodes on 4 gloo ranks (2 nodes a rank),
4 steps, every rank's Trainer holding only its 2 nodes.  Four ranks are
spawned once for the module (:func:`runs`); each runs every case and its
results are saved, then the parametrised tests compare them.

Held to, with the tolerances and their reasons:
* the JAX Trainer without a mesh (Gossip-PGA H = 2 over one_peer_exp,
  SGD, the fused consensus residual), from the same weights: params rtol
  1e-5, atol 1e-7 and the loss rtol 1e-5, as ``tests/test_torch_sharded.py``
  holds the one-process sharded Trainer (the forward and backward sum in
  another order); the consensus of the gossip steps rtol 1e-4, the
  tolerance of the round's residual in that suite (a sum of squared
  differences of nearly equal rows: the params' last-bit differences
  grow in it; 1.09e-5 seen here, the one-process Trainer's as well);
  consensus exactly 0.0 after every global step;
* the port's one-process sharded Trainer (every shard in one process) on
  the same weights: params within atol 1e-7, rtol 1e-6 and the losses
  within rtol 1e-6.  Not bitwise: the rounds are (``tests/
  test_torch_dist_mixing.py``), but the CPU's GEMMs may block a batch of
  2 nodes otherwise than one of 8 and this process runs 2 threads, a
  rank 1 (3.0e-8 the largest params gap measured, with a forward and
  backward on the reduced model; the clipped case's joint gradient norm
  is besides the fold of the ranks' partial sums);
* every registered algorithm runs (parallel, gossip, local, gossip_pga,
  gossip_aga, hier_pga, gt_pga, slowmo, as many steps as show their
  phases, Gossip-PGA the 4-step case above: against the one-process
  Trainer as above; SlowMo's momentum ``(anchor − x̄)/lr`` within its
  anchor's bound over lr, as ``tests/test_torch_trainer_algos.py`` holds
  it; checkpoints are ``tests/test_torch_dist_ckpt.py``'s).  Push-sum
  over directed_exp
  runs with a fault schedule (nodes 2 and 5, on two ranks, down at steps
  1–2, their rows frozen there): against the one-process
  Trainer as above, and the mass Σw (a fold of the ranks' sums) within
  8e-5 of 8.

JAX is imported inside the tests, never at module top: a spawned rank
imports this module to find its worker and must load no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import base as tcfg
from repro_torch.configs import pga_lm_100m as tarch
from repro_torch.core.algo import algorithm_names
from repro_torch.core.mesh import make_mesh, run_ranks
from repro_torch.train import Trainer

torch.set_num_threads(2)

K, N, STEPS = 4, 8, 4
DIST = dict(algorithm="gossip_pga", topology="one_peer_exp", H=2,
            comm_backend="pallas")
OPT = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
COMMON = dict(global_batch=8, seq_len=8, log_every=1)
# each algorithm's run is as long as its phases need: 2 steps show
# gossip (or none) and global; Hier-PGA's pod round needs H = 4 and 4
# steps (gossip, pod_avg, gossip, global)
ALGO_KW = {"hier_pga": dict(H=4, n_pods=2, hier_h_pod=2),
           "gossip_aga": dict(aga_h_init=2, aga_warmup=1)}
ALGO_STEPS = {"hier_pga": 4}
PUSH = dict(topology="directed_exp", push_sum=True)
FAULTS = dict(drops={1: (2, 5)}, rejoins={3: (2, 5)})
# cases: (name, DistConfig overrides, OptimizerConfig overrides, extra,
# steps)
CASES = ([("pga", {}, {}, {}, STEPS),
          ("clip", {}, dict(grad_clip=0.05), {}, STEPS),
          ("compressed", dict(comm_compression="int8",
                              comm_global_compression="int8",
                              comm_error_feedback=True), {}, {}, STEPS),
          ("overlap", dict(comm_overlap=True), {}, {}, STEPS),
          ("overlap_int8", dict(comm_overlap=True, comm_compression="int8",
                                comm_error_feedback=True), {}, {}, STEPS)]
         + [(f"algo-{a}", dict(algorithm=a, **ALGO_KW.get(a, {})), {}, {},
             ALGO_STEPS.get(a, 2))
            for a in algorithm_names() if a != DIST["algorithm"]]
         + [("push_faults", PUSH, {}, {}, STEPS)])


def _config(dist_kw, opt_kw, extra):
    return tcfg.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg.DistConfig(**{**DIST, **dist_kw}),
        optimizer=tcfg.OptimizerConfig(**{**OPT, **opt_kw}), **COMMON,
        **extra)


def _run(case, mesh, row0):
    """``(params leaves, [(phase, loss, consensus, mass), slots])`` of one
    case's steps on ``mesh``; ``slots``: SlowMo's ``(anchor, momentum)``
    leaves."""
    from repro_torch.core.faults import FaultSchedule
    name, dist_kw, opt_kw, extra, steps = case
    faults = (FaultSchedule(n_nodes=N, **FAULTS) if name == "push_faults"
              else None)
    tr = Trainer(_config(dist_kw, opt_kw, extra), N, mesh=mesh,
                 with_consensus=True, fault_schedule=faults, device="cpu")
    st = tr.init_state(params=interop.from_numpy(row0, "cpu"))
    st = tr.run(st, steps=steps, log_every=1)
    from repro_torch.tree import tree_leaves
    slots = tuple([p.clone() for p in tree_leaves(st.extras[s])]
                  for s in ("slow_params", "slow_u") if s in st.extras)
    return ([p.clone() for p in tree_leaves(st.params)],
            [(h["phase"], h["loss"], h["consensus"], h.get("mass"))
             for h in tr.history], slots)


OVERLAPPED = ("overlap", "overlap_int8")


def _serial_runs(mesh, row0):
    """The overlapped cases with the apply gathering its own halo (the
    serial overlap: ``mixing.issue_round`` made the identity)."""
    from repro_torch.core import mixing
    real = mixing.issue_round
    mixing.issue_round = lambda round_state, spec, *, step: round_state
    try:
        return {c[0]: _run(c, mesh, row0) for c in CASES
                if c[0] in OVERLAPPED}
    finally:
        mixing.issue_round = real


def _failed_step(mesh, row0):
    """The overlapped Trainer's gossip step 2 fails in its loss, after it
    issued its halo (a batch without its targets); the Trainer then runs
    steps 2 and 3.  Returns ``(what the step raised, final params)``."""
    case = next(c for c in CASES if c[0] == "overlap")
    tr = Trainer(_config(*case[1:4]), N, mesh=mesh, with_consensus=True,
                 device="cpu")
    st = tr.run(tr.init_state(params=interop.from_numpy(row0, "cpu")),
                steps=2, log_every=1)
    k = st.step
    phase = tr.schedule.peek_phase(k)
    step_fn = tr._get_step_fn(phase, tr.schedule.gossip_shift_step(
        k, tr.period), buf_shift=tr._buf_shift)
    bad = {key: v for key, v in tr.device_batch(k).items()
           if key != "targets"}
    try:
        step_fn(st, bad, tr.lr_fn(k), tr._comm_buf)
        raised = None
    except KeyError as e:
        raised = (phase, str(e))
    st = tr.run(st, steps=2, log_every=1)
    from repro_torch.tree import tree_leaves
    return raised, [p.clone() for p in tree_leaves(st.params)]


def _rank_worker(rank: int, row0):
    import torch.distributed as dist
    mesh = make_mesh((K,), ("data",), device="cpu", group=dist.group.WORLD)
    out = {case[0]: _run(case, mesh, row0) for case in CASES}
    out["serial"] = _serial_runs(mesh, row0)
    out["failed_step"] = _failed_step(mesh, row0)
    return out


@pytest.fixture(scope="module")
def runs():
    """``{"jax", "local", "ranks"}``: the JAX Trainer without a mesh
    (Gossip-PGA) from its initial replica, the one-process sharded
    Trainer (4 shards in this process) and the 4 ranks, each case from
    that replica.  The ranks run while this process computes the other
    two."""
    import threading

    import jax

    from repro.configs import base as jcfg
    from repro.configs import pga_lm_100m as jarch
    from repro.train.trainer import Trainer as JTrainer

    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(**DIST), optimizer=jcfg.OptimizerConfig(**OPT),
        **COMMON)
    jtr = JTrainer(jt, n_nodes=N, with_consensus=True)
    jst = jtr.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree.map(lambda p: np.asarray(p[0]),
                        jax.device_get(jst.params))
    box = {}

    def spawn():
        try:
            box["ranks"] = run_ranks(_rank_worker, K, args=(row0,),
                                     timeout_s=150)
        except BaseException as e:             # re-raised below
            box["error"] = e

    th = threading.Thread(target=spawn)
    th.start()
    try:
        jst = jtr.run(jst, steps=STEPS, log_every=1)
        out = {"jax": (jax.tree.leaves(jax.device_get(jst.params)),
                       jtr.history)}
        mesh = make_mesh((K,), ("data",), device="cpu")
        out["local"] = {case[0]: _run(case, mesh, row0) for case in CASES}
        out["local_serial"] = _serial_runs(mesh, row0)
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    out["ranks"] = box["ranks"]
    return out


def _rank_params(ranks, name):
    """Every rank's params, concatenated over the ranks per leaf."""
    leaves = ranks[0][name][0]
    return [torch.cat([ranks[r][name][0][i] for r in range(K)])
            for i in range(len(leaves))]


def test_rank_trainer_matches_jax_trainer(runs):
    """Params after 4 steps (gossip, global, gossip, global), the loss of
    every step and the consensus of the gossip steps against the JAX
    Trainer; consensus exactly 0.0 after every global step on every
    rank."""
    want_params, want_hist = runs["jax"]
    ranks = runs["ranks"]
    for r in range(K):
        hist = ranks[r]["pga"][1]
        assert [h[0] for h in hist] == ["gossip", "global", "gossip",
                                        "global"]
        for (phase, loss, cons, _), jr in zip(hist, want_hist):
            np.testing.assert_allclose(loss, jr["loss"], rtol=1e-5)
            if phase == "global":
                assert cons == 0.0
            else:
                np.testing.assert_allclose(cons, jr["consensus"],
                                           rtol=1e-4)
    for got, want in zip(_rank_params(ranks, "pga"), want_params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_rank_trainer_is_the_one_process_trainer(runs, name):
    """Each rank's params are its rows of the one-process sharded
    Trainer's within atol 1e-7, rtol 1e-6, and every rank logs the same
    phases and losses (rtol 1e-6) as the one-process Trainer; SlowMo's
    slots are whole on every rank, the anchor within atol 1e-7, rtol 1e-6
    and the momentum within the anchor's bound over lr."""
    ranks = runs["ranks"]
    want_params, want_hist, want_slots = runs["local"][name]
    for r in range(K):
        slots = ranks[r][name][2]
        assert len(slots) == len(want_slots)
        if want_slots:
            (anchor, mom), (w_anchor, w_mom) = slots, want_slots
            for g, w in zip(anchor, w_anchor):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                           atol=1e-7)
            for g, w, a in zip(mom, w_mom, w_anchor):
                bound = (1e-7 + 1e-6 * float(a.abs().max())) / OPT["lr"]
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                           atol=bound)
    got = _rank_params(ranks, name)
    for g, w in zip(got, want_params):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)
    for r in range(K):
        hist = ranks[r][name][1]
        assert [h[0] for h in hist] == [h[0] for h in want_hist]
        np.testing.assert_allclose([h[1] for h in hist],
                                   [h[1] for h in want_hist], rtol=1e-6)


@pytest.mark.parametrize("name", OVERLAPPED)
@pytest.mark.parametrize("where", ("ranks", "local"))
def test_issued_overlap_is_the_serial_overlap_bitwise(runs, name, where):
    """The overlapped Trainer issues its gossip steps' halo before the
    forward (``mixing.issue_round``; on the ranks an exchange in flight
    on its own group): params, phases, losses and consensus bitwise the
    serial overlap's (the apply gathering the halo itself), dense and
    int8 + EF, on every rank and in one process."""
    pairs = ([(runs["ranks"][r][name], runs["ranks"][r]["serial"][name])
              for r in range(K)] if where == "ranks" else
             [(runs["local"][name], runs["local_serial"][name])])
    for (params, hist, _), (want_params, want_hist, _) in pairs:
        assert hist == want_hist
        for g, w in zip(params, want_params):
            assert torch.equal(g, w)


def test_rank_step_failing_after_its_issue_drains_the_halo(runs):
    """A gossip step that raises in its forward, after issuing its halo,
    drains the exchange on every rank: the Trainer then runs on, and its
    params after 4 steps are bitwise the uninterrupted run's."""
    for r in range(K):
        raised, params = runs["ranks"][r]["failed_step"]
        assert raised == ("gossip", "'targets'")
        for g, w in zip(params, runs["ranks"][r]["overlap"][0]):
            assert torch.equal(g, w)


def test_rank_trainer_clip_engages(runs):
    """The clipped case's joint norm scales the step: its params differ
    from the unclipped run's."""
    clipped = _rank_params(runs["ranks"], "clip")
    plain = _rank_params(runs["ranks"], "pga")
    assert any(not torch.equal(a, b) for a, b in zip(clipped, plain))


def test_every_registered_algorithm_is_covered():
    """Gossip-PGA is the "pga" case; every other algorithm has its own."""
    assert {c[0] for c in CASES} >= {f"algo-{a}" for a in algorithm_names()
                                     if a != DIST["algorithm"]} | {"pga"}


def test_rank_trainer_consensus_is_zero_after_global_steps(runs):
    """The uncompressed cases' global steps leave every node on the same
    bits on every rank (the fused residual and, for the overlapped and
    the payload-carrying runs, the consensus of the rank mesh's pairwise
    mean)."""
    for name in ("pga", "clip", "overlap", "algo-parallel", "algo-local",
                 "algo-gt_pga", "algo-gossip_aga"):
        for r in range(K):
            for phase, _, cons, _ in runs["ranks"][r][name][1]:
                if phase == "global":
                    assert cons == 0.0, (name, r)


def test_rank_push_sum_keeps_the_mass(runs):
    """Σw, the fold of the ranks' sums, stays within 8e-5 of n on every
    step and rank (the mass gate of the one-process push-sum paths)."""
    for r in range(K):
        for rec in runs["ranks"][r]["push_faults"][1]:
            assert abs(rec[3] - N) <= 8e-5, (r, rec)


def test_rank_algorithm_runs_show_their_phases(runs):
    """Each algorithm case ran every round kind of its own: Hier-PGA's
    pod round among them."""
    want = {"algo-parallel": ["global", "global"],
            "algo-gossip": ["gossip", "gossip"],
            "algo-local": ["none", "global"],
            "algo-gossip_aga": ["gossip", "global"],
            "algo-gt_pga": ["gossip", "global"],
            "algo-hier_pga": ["gossip", "pod_avg", "gossip", "global"],
            "algo-slowmo": ["gossip", "slowmo"]}
    for name, phases in want.items():
        for r in range(K):
            assert [h[0] for h in runs["ranks"][r][name][1]] == phases
