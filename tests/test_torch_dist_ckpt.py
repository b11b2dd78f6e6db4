"""Port parity: SlowMo and checkpoints on rank meshes (one
``torch.distributed`` rank per block) on the CPU.

Reduced pga-lm-100m at fp32, SGD, 4 gloo ranks spawned once for the
module (:func:`runs`); each runs every case and its results are saved,
then the parametrised tests compare them.  The one-process meshes and the
JAX references are computed here while the ranks run.

SlowMo (H = 2 over one_peer_exp, β 0.5, α 0.7; 4 steps: gossip, slowmo,
gossip, slowmo, the second outer step with a nonzero slow momentum), on
``(4,)`` ranks at n = 8, on ``(data=2, model=2)`` ranks at n = 4 and, with
``comm_overlap=True``, on ``(4,)`` ranks.  Held to:
* the one-process Trainer on the same mesh shape: params, optimizer state
  and the anchor within atol 1e-7, rtol 1e-6 and the losses within rtol
  1e-6, the bounds of ``tests/test_torch_dist_train.py`` (the CPU's GEMMs
  may block a batch of 2 nodes otherwise than one of 8 or 4, and this
  process runs 2 threads, a rank 1); the momentum ``(anchor − x̄)/lr``
  within each leaf's anchor bound over lr, as
  ``tests/test_torch_trainer_algos.py`` holds it (1.5e-7 seen at
  ``(data=2, model=2)``: one ulp of x̄ near 1e-2, times 1/lr = 20);
* the JAX SlowMo Trainer without a mesh: the bounds of the SlowMo case of
  ``tests/test_torch_trainer_algos.py`` (params and the anchor rtol 1e-5,
  atol 1e-7; losses rtol 1e-5; the momentum each leaf's anchor bound
  over lr), the gossip steps' consensus rtol 1e-4 (the rank runs' bound
  in ``tests/test_torch_dist_train.py``: a sum of squared differences of
  nearly equal rows);
* ``slow_params`` and ``slow_u`` bitwise equal on every rank, the
  consensus exactly 0.0 after every slowmo step.

Checkpoints on ``(4,)`` ranks, n = 8, ``ckpt_every=2``, 4 steps, five
cases: Gossip-PGA with int8 gossip + int8 collective + EF; SlowMo (its
unstacked slots); push-sum over directed_exp with nodes 2 and 5 down at
steps 1-2 (the faults sidecar); Gossip-AGA (the schedule sidecar);
Gossip-PGA with ``comm_overlap=True`` (a resume re-primes the buffer: a
flush).  Each case's step-2 file:
* ``np.load`` of it is the ranks' state after step 2, gathered, bitwise
  (and the step-4 file the final state);
* the reference's ``restore_checkpoint`` reads it onto a JAX template with
  the same arrays, bitwise;
* fresh rank Trainers restore it and run steps 2-3: bitwise the
  uninterrupted rank run (params, optimizer state, extras, fault counters
  and the AGA schedule);
* the one-process ``(4,)`` Trainer restores it bitwise and runs on within
  the rank-mesh bounds above of the resumed ranks;
* restored on ``(data=2, model=2)`` ranks (4 node shards to 2) it runs on
  within atol 1e-7, rtol 1e-6 of the resumed ``(4,)`` ranks.
A JAX-written checkpoint restores onto the ranks, every rank's rows
bitwise the JAX arrays' rows; a template of another n raises
``ValueError``.

JAX is imported inside the tests, never at module top: a spawned rank
imports this module to find its worker and must load no JAX.
"""
import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.configs import base as tcfg
from repro_torch.configs import pga_lm_100m as tarch
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.mesh import make_mesh, run_ranks
from repro_torch.train import Trainer

torch.set_num_threads(2)

K, N, N2 = 4, 8, 4                      # ranks, nodes on (4,), on (2, 2)
AXES2 = ((2, 2), ("data", "model"))
STEPS = 4
BASE = dict(algorithm="gossip_pga", topology="one_peer_exp", H=2,
            comm_backend="pallas")
SLOWMO = dict(algorithm="slowmo", slowmo_beta=0.5, slowmo_lr=0.7)
OPT = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
COMMON = dict(global_batch=8, seq_len=8, log_every=1)
FAULTS = dict(drops={1: (2, 5)}, rejoins={3: (2, 5)})
# SlowMo runs: (mesh, nodes, DistConfig overrides)
SLOWMO_RUNS = {"slowmo": ("1d", N, {}),
               "slowmo_2d": ("2d", N2, {}),
               "slowmo_overlap": ("1d", N, dict(comm_overlap=True))}
CKPT_CASES = {
    "int8_ef": dict(comm_compression="int8", comm_global_compression="int8",
                    comm_error_feedback=True),
    "slowmo": SLOWMO,
    "push_faults": dict(topology="directed_exp", push_sum=True),
    "aga": dict(algorithm="gossip_aga", aga_h_init=2, aga_warmup=1),
    "overlap": dict(comm_overlap=True),
}
TOL = dict(rtol=1e-6, atol=1e-7)        # rank mesh vs one process
JTOL = dict(rtol=1e-5, atol=1e-7)       # the port vs the JAX Trainer


def _config(dist_kw, **extra):
    return tcfg.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg.DistConfig(**{**BASE, **dist_kw}),
        optimizer=tcfg.OptimizerConfig(**OPT), **COMMON, **extra)


def _trainer(dist_kw, mesh, n, ckpt_dir="", ckpt_every=0):
    faults = (FaultSchedule(n_nodes=n, **FAULTS) if dist_kw.get("push_sum")
              else None)
    return Trainer(_config(dist_kw, ckpt_every=ckpt_every,
                           ckpt_dir=ckpt_dir),
                   n, mesh=mesh, with_consensus=True, fault_schedule=faults,
                   device="cpu")


def _flat_state(st):
    """``{checkpoint key: leaf}`` of a state, the tensors cloned."""
    return {k: v.clone() if torch.is_tensor(v) else v
            for k, v in _flatten(st).items()}


def _history(tr):
    return [(h["phase"], h["loss"], h["consensus"]) for h in tr.history]


def _slowmo_run(mesh, n, dist_kw, row0):
    tr = _trainer({**SLOWMO, **dist_kw}, mesh, n)
    st = tr.init_state(params=interop.from_numpy(row0, "cpu"))
    st = tr.run(st, steps=STEPS, log_every=1)
    return _flat_state(st), _history(tr)


def _side_state(tr):
    """The sidecars' trajectory state: fault counters, AGA schedule."""
    fs = tr.fault_schedule.state_dict() if tr.fault_schedule else None
    return fs, tr.schedule.state_dict(), list(
        getattr(tr.schedule, "history", []))


def _ckpt_case(name, mesh, mesh2, root):
    """One checkpoint case on the ranks: U the uninterrupted 4 steps
    writing steps 2 and 4; B a fresh (4,) Trainer restoring step 2 and
    running steps 2-3; C the same on the (2, 2) mesh."""
    d = os.path.join(root, name)
    dist_kw = CKPT_CASES[name]
    tr = _trainer(dist_kw, mesh, N, d, ckpt_every=2)
    st = tr.init_state(torch.Generator().manual_seed(0))
    st = tr.run(st, steps=2, log_every=1)
    out = {"at2": _flat_state(st)}
    st = tr.run(st, steps=2, log_every=1)
    out.update(u=_flat_state(st), u_side=_side_state(tr))
    for key, m in (("b", mesh), ("c", mesh2)):
        trb = _trainer(dist_kw, m, N, d)
        stb = restore_checkpoint(
            d, trb.init_state(torch.Generator().manual_seed(0)), step=2,
            mesh=m)
        out[key + "_restored"] = _flat_state(stb)
        stb = trb.run(stb, steps=2, log_every=1)
        out[key] = _flat_state(stb)
        out[key + "_side"] = _side_state(trb)
        out[key + "_hist"] = _history(trb)
    return out


def _rank_worker(rank, root, jax_dir, row0):
    import torch.distributed as dist
    mesh = make_mesh((K,), ("data",), device="cpu", group=dist.group.WORLD)
    mesh2 = make_mesh(*AXES2, device="cpu", group=dist.group.WORLD)
    meshes = {"1d": mesh, "2d": mesh2}
    out = {"coords": {"1d": (mesh.node_rank, mesh.model_rank),
                      "2d": (mesh2.node_rank, mesh2.model_rank)}}
    for name, (kind, n, kw) in SLOWMO_RUNS.items():
        out[("slowmo", name)] = _slowmo_run(meshes[kind], n, kw, row0)
    for name in CKPT_CASES:
        out[("ckpt", name)] = _ckpt_case(name, mesh, mesh2, root)
    # a JAX-written file onto the ranks (the parent writes it while the
    # ranks run, then its marker), then a template of another n
    deadline = time.monotonic() + 150
    while not os.path.exists(os.path.join(jax_dir, "written")):
        if time.monotonic() > deadline:
            raise TimeoutError("the JAX checkpoint was not written")
        time.sleep(0.05)
    tr = _trainer(SLOWMO, mesh, N)
    out["jax_file"] = _flat_state(restore_checkpoint(
        jax_dir, tr.init_state(torch.Generator().manual_seed(0)),
        mesh=mesh))
    try:
        tr = _trainer(SLOWMO, mesh, N // 2)
        restore_checkpoint(jax_dir, tr.init_state(
            torch.Generator().manual_seed(0)), mesh=mesh)
        out["wrong_n"] = None
    except ValueError as e:
        out["wrong_n"] = str(e)
    return out


def _jax_config(dist_kw):
    from repro.configs import base as jcfg
    from repro.configs import pga_lm_100m as jarch
    return jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(**{**BASE, **dist_kw}),
        optimizer=jcfg.OptimizerConfig(**OPT), **COMMON)


def _jax_file(jax_dir):
    """A checkpoint the reference writes: the JAX SlowMo Trainer's state
    at n = 8 with every float leaf redrawn (each node row its own
    values), saved by ``repro.checkpoint.save_checkpoint`` at step 6."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import save_checkpoint as jsave
    from repro.train.state import TrainState as JState
    from repro.train.trainer import Trainer as JTrainer
    jst = JTrainer(_jax_config(SLOWMO), n_nodes=N).init_state(
        jax.random.PRNGKey(1))
    rng = np.random.default_rng(7)

    def redraw(a):
        a = np.asarray(a)
        if a.dtype.kind != "f":
            return jnp.asarray(a)
        return jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype))
    state = JState(params=jax.tree.map(redraw, jst.params),
                   opt_state=jax.tree.map(redraw, jst.opt_state),
                   step=jnp.asarray(6, jnp.int32),
                   extras=jax.tree.map(redraw, jst.extras))
    jsave(jax_dir, state, 6)
    with open(os.path.join(jax_dir, "written"), "w"):
        pass


def _jax_slowmo(n, row0):
    """The JAX SlowMo Trainer without a mesh at n nodes from the replica
    ``row0``, its state built as its ``init_state`` builds it: 4 steps,
    the final state's leaves by checkpoint key and the history."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.ckpt import _flatten as jflatten
    from repro.core import algo as jalgo
    from repro.optim import make_optimizer
    from repro.train.state import TrainState as JState
    from repro.train.state import stack_for_nodes
    from repro.train.trainer import Trainer as JTrainer
    jt = _jax_config(SLOWMO)
    jtr = JTrainer(jt, n_nodes=n, with_consensus=True)
    params = stack_for_nodes(jax.tree.map(jnp.asarray, row0), n)
    jst = JState(params=params,
                 opt_state=make_optimizer(jt.optimizer,
                                          per_node=True).init(params),
                 step=jnp.zeros((), jnp.int32),
                 extras=jalgo.init_extras(jt.dist, params, n))
    jst = jtr.run(jst, steps=STEPS, log_every=1)
    return jflatten(jax.device_get(jst))[0], jtr.history


@pytest.fixture(scope="module")
def runs():
    """``{"ranks", "local", "jax", "files", "local_resume", "jax_read",
    "jax_file"}``: the 4 ranks' results (spawned once) and, computed here,
    the one-process SlowMo runs, the JAX SlowMo Trainers, then the files'
    contents read back by numpy, by the reference and by the one-process
    Trainer."""
    import threading

    root = tempfile.mkdtemp(prefix="rank_ckpt_")
    jax_dir = os.path.join(root, "jax")
    # the port's replica: every run starts from it, the JAX ones too
    from repro_torch.models.model import make_model
    row0 = interop.to_numpy(make_model(_config(SLOWMO).model).init(
        torch.Generator().manual_seed(0), torch.device("cpu")))
    box = {}

    def spawn():
        try:
            box["ranks"] = run_ranks(_rank_worker, K, timeout_s=170,
                                     args=(root, jax_dir, row0))
        except BaseException as e:             # re-raised below
            box["error"] = e

    th = threading.Thread(target=spawn)
    th.start()
    try:
        import jax

        from repro.checkpoint import restore_checkpoint as jrestore
        from repro.checkpoint.ckpt import _flatten as jflatten
        from repro.core.faults import FaultSchedule as JFaults
        from repro.train.trainer import Trainer as JTrainer
        _jax_file(jax_dir)
        meshes = {"1d": make_mesh((K,), ("data",), device="cpu"),
                  "2d": make_mesh(*AXES2, device="cpu")}
        out = {"local": {}, "jax": {n: _jax_slowmo(n, row0)
                                    for n in (N, N2)}}
        for name, (kind, n, kw) in SLOWMO_RUNS.items():
            out["local"][name] = _slowmo_run(meshes[kind], n, kw, row0)
    finally:
        th.join()
    try:
        if "error" in box:
            raise box["error"]
        out["ranks"] = box["ranks"]
        out["files"], out["jax_read"], out["local_resume"] = {}, {}, {}
        for name, dist_kw in CKPT_CASES.items():
            d = os.path.join(root, name)
            for step in (2, 4):
                with np.load(os.path.join(d, f"ckpt_{step:08d}.npz")) as z:
                    out["files"][(name, step)] = {k: z[k] for k in z.files}
            jtr = JTrainer(_jax_config(dist_kw), n_nodes=N,
                           fault_schedule=(JFaults(n_nodes=N, **FAULTS)
                                           if dist_kw.get("push_sum")
                                           else None))
            got = jrestore(d, jtr.init_state(jax.random.PRNGKey(0)), step=2)
            out["jax_read"][name] = {k: np.asarray(v) for k, v in
                                     jflatten(jax.device_get(got))[0].items()}
            tr = _trainer(dist_kw, meshes["1d"], N, d)
            st = restore_checkpoint(
                d, tr.init_state(torch.Generator().manual_seed(0)), step=2,
                mesh=meshes["1d"])
            restored = _flat_state(st)
            out["local_resume"][name] = (restored, _flat_state(
                tr.run(st, steps=2, log_every=1)), _history(tr))
        with np.load(os.path.join(jax_dir, "ckpt_00000006.npz")) as z:
            out["jax_file"] = {k: z[k] for k in z.files}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
STACKED = (".params/", ".opt_state/", ".extras/ef_state/",
           ".extras/push_weight")


def _gathered(ranks, pick):
    """``{key: leaf}`` of the ranks' state: the node-stacked leaves (the
    params, the optimizer's per-node leaves, the EF memory, the push
    weight) concatenated over the given ranks in order, the others rank
    0's, which every rank must hold bitwise."""
    recs = [pick(r) for r in ranks]
    out = {}
    for key, leaf in recs[0].items():
        if key.startswith(STACKED) and torch.is_tensor(leaf) and leaf.dim():
            out[key] = torch.cat([rec[key] for rec in recs])
        else:
            for rec in recs[1:]:
                assert _equal(rec[key], leaf), key
            out[key] = leaf
    return out


def _equal(a, b):
    if torch.is_tensor(a) or torch.is_tensor(b):
        a = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        b = b if torch.is_tensor(b) else torch.from_numpy(np.asarray(b))
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    return int(a) == int(b)


def _one_d(runs, name, field):
    """A checkpoint case's ``field`` gathered over the (4,) ranks."""
    return _gathered(runs["ranks"], lambda r: r[("ckpt", name)][field])


def _two_d(runs, picker):
    """A state gathered over the (2, 2) ranks: node shards 0 and 1 (model
    rank 0's; the model ranks of a node shard must hold the same rows)."""
    ranks = runs["ranks"]
    by_node = {}
    for r in ranks:
        nr, mr = r["coords"]["2d"]
        if nr in by_node:
            for k, v in picker(r).items():
                assert _equal(v, by_node[nr][k]), k
        if mr == 0 or nr not in by_node:
            by_node[nr] = picker(r)
    return _gathered([by_node[0], by_node[1]], lambda r: r)


def _momentum_bound(anchor, lr=OPT["lr"], atol=1e-7, rtol=1e-6):
    """SlowMo's momentum carries its anchor's bound over lr."""
    return (atol + rtol * float(np.abs(np.asarray(anchor)).max())) / lr


def _close(got, want, what, **tol):
    assert sorted(got) == sorted(want), what
    for k in want:
        if k.startswith(".extras/slow_u"):
            bound = _momentum_bound(want[k.replace("slow_u", "slow_params")],
                                    **tol)
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=bound,
                                       err_msg=f"{what} {k}")
        elif torch.is_tensor(want[k]):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       err_msg=f"{what} {k}", **tol)
        else:
            assert got[k] == want[k], (what, k)


def _bitwise(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert _equal(got[k], want[k]), (what, k)


# ---------------------------------------------------------------------------
# SlowMo on the rank meshes
# ---------------------------------------------------------------------------
def _slowmo_ranks(runs, name):
    kind = SLOWMO_RUNS[name][0]
    if kind == "2d":
        return _two_d(runs, lambda r: r[("slowmo", name)][0])
    return _gathered(runs["ranks"], lambda r: r[("slowmo", name)][0])


@pytest.mark.parametrize("name", list(SLOWMO_RUNS))
def test_rank_slowmo_is_the_one_process_trainer(runs, name):
    """Params, optimizer state and the anchor within atol 1e-7, rtol 1e-6
    of the one-process Trainer on the same mesh shape (the momentum within
    its anchor's bound over lr), every rank's phases and losses (rtol
    1e-6) its."""
    want, want_hist = runs["local"][name]
    _close(_slowmo_ranks(runs, name), want, name, **TOL)
    for r in runs["ranks"]:
        hist = r[("slowmo", name)][1]
        assert [h[0] for h in hist] == [h[0] for h in want_hist] == [
            "gossip", "slowmo", "gossip", "slowmo"]
        np.testing.assert_allclose([h[1] for h in hist],
                                   [h[1] for h in want_hist], rtol=1e-6)


@pytest.mark.parametrize("name", list(SLOWMO_RUNS))
def test_rank_slowmo_slots_are_bitwise_on_every_rank(runs, name):
    """``slow_params`` and ``slow_u`` are whole and bitwise equal on every
    rank, and the outer steps leave every node on the same bits
    (consensus exactly 0.0)."""
    recs = [r[("slowmo", name)] for r in runs["ranks"]]
    slots = [k for k in recs[0][0] if k.startswith(".extras/slow_")]
    assert slots and any(k.startswith(".extras/slow_u") for k in slots)
    for rec in recs[1:]:
        for k in slots:
            assert _equal(rec[0][k], recs[0][0][k]), k
    n = SLOWMO_RUNS[name][1]
    shapes = {k: tuple(v.shape) for k, v in runs["local"][name][0].items()
              if k in slots}
    assert {k: tuple(recs[0][0][k].shape) for k in slots} == shapes
    assert all(s[:1] != (n,) or len(s) == 1 for s in shapes.values())
    for rec in recs:
        for phase, _, cons in rec[1]:
            if phase == "slowmo":
                assert cons == 0.0


@pytest.mark.parametrize("name", ["slowmo", "slowmo_2d"])
def test_rank_slowmo_matches_jax_trainer(runs, name):
    """Against the JAX SlowMo Trainer without a mesh: params and the
    anchor rtol 1e-5, atol 1e-7, the momentum within each leaf's anchor
    bound over lr, losses rtol 1e-5, the gossip steps' consensus rtol
    1e-4 and the outer steps' exactly 0.0."""
    n = SLOWMO_RUNS[name][1]
    jflat, jhist = runs["jax"][n]
    got = _slowmo_ranks(runs, name)
    for k, v in got.items():
        if not (k.startswith(".params") or k.startswith(".extras")):
            continue
        want = np.asarray(jflat[k])
        if k.startswith(".extras/slow_u"):
            bound = _momentum_bound(
                jflat[k.replace("slow_u", "slow_params")], **JTOL)
            np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=bound,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want, err_msg=k, **JTOL)
    hist = runs["ranks"][0][("slowmo", name)][1]
    assert [h[0] for h in hist] == [h["phase"] for h in jhist]
    for (phase, loss, cons), jr in zip(hist, jhist):
        np.testing.assert_allclose(loss, jr["loss"], rtol=1e-5)
        if phase == "slowmo":
            assert cons == 0.0 == jr["consensus"]
        else:
            np.testing.assert_allclose(cons, jr["consensus"], rtol=1e-4)


# ---------------------------------------------------------------------------
# Checkpoints on the rank meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CKPT_CASES))
def test_rank_file_is_the_gathered_state(runs, name):
    """``np.load`` of the ranks' step-2 and step-4 files: every member
    bitwise the ranks' state after that step, node-stacked leaves in node
    order, the unstacked slots and ``.step`` once."""
    for step, field in ((2, "at2"), (4, "u")):
        f = runs["files"][(name, step)]
        want = _one_d(runs, name, field)
        assert sorted(k for k in f if k != "__dtype_manifest__") == \
            sorted(want)
        for k, v in want.items():
            assert _equal(f[k], v), (name, step, k)


@pytest.mark.parametrize("name", list(CKPT_CASES))
def test_reference_reads_the_rank_file(runs, name):
    """The reference's ``restore_checkpoint`` onto a JAX template of the
    same config gives every array of the file, bitwise."""
    f = runs["files"][(name, 2)]
    got = runs["jax_read"][name]
    assert sorted(got) == sorted(k for k in f if k != "__dtype_manifest__")
    for k, v in got.items():
        assert v.dtype == f[k].dtype and np.array_equal(
            v.reshape(-1).view(np.uint8), f[k].reshape(-1).view(np.uint8)), \
            (name, k)


@pytest.mark.parametrize("name", list(CKPT_CASES))
def test_rank_resume_is_bitwise_the_uninterrupted_run(runs, name):
    """Fresh (4,) rank Trainers restore step 2 (each rank its rows,
    bitwise the file's) and run steps 2-3: params, optimizer state and
    extras bitwise the uninterrupted rank run's, and the sidecars' state
    (fault counters, the AGA schedule and its history) equal."""
    _bitwise(_one_d(runs, name, "b_restored"), _one_d(runs, name, "at2"),
             name)
    _bitwise(_one_d(runs, name, "b"), _one_d(runs, name, "u"), name)
    for r in runs["ranks"]:
        rec = r[("ckpt", name)]
        assert rec["b_side"] == rec["u_side"]
    if name == "push_faults":
        assert runs["ranks"][0][("ckpt", name)]["u_side"][0]["drops_applied"]


@pytest.mark.parametrize("name", list(CKPT_CASES))
def test_one_process_trainer_resumes_the_rank_file(runs, name):
    """The one-process (4,) Trainer restores the ranks' step-2 file
    bitwise and runs steps 2-3 within atol 1e-7, rtol 1e-6 of the resumed
    ranks (losses rtol 1e-6)."""
    restored, final, hist = runs["local_resume"][name]
    _bitwise(restored, _one_d(runs, name, "at2"), name)
    _close(_one_d(runs, name, "b"), final, name, **TOL)
    got = runs["ranks"][0][("ckpt", name)]["b_hist"]
    np.testing.assert_allclose([h[1] for h in got], [h[1] for h in hist],
                               rtol=1e-6)


@pytest.mark.parametrize("name", list(CKPT_CASES))
def test_rank_file_resumes_on_the_two_d_mesh(runs, name):
    """Restored on (data=2, model=2) ranks (2 node shards of 4 rows, the
    model ranks of a node shard alike): bitwise the file, then steps 2-3
    within atol 1e-7, rtol 1e-6 of the (4,) ranks' resumed run."""
    _bitwise(_two_d(runs, lambda r: r[("ckpt", name)]["c_restored"]),
             _one_d(runs, name, "at2"), name)
    _close(_two_d(runs, lambda r: r[("ckpt", name)]["c"]),
           _one_d(runs, name, "b"), name, **TOL)


def test_jax_checkpoint_restores_onto_the_ranks(runs):
    """A file the reference wrote (SlowMo, every node row its own values):
    each rank's rows of every stacked leaf, and the slots and ``.step``
    whole, bitwise the JAX arrays."""
    f = runs["jax_file"]
    got = _gathered(runs["ranks"], lambda r: r["jax_file"])
    assert sorted(got) == sorted(k for k in f if k != "__dtype_manifest__")
    for k, v in got.items():
        assert _equal(v, f[k]), k
    assert got[".step"] == 6


def test_template_of_another_n_raises(runs):
    """A template of 1 row a rank (n = 4) against the n = 8 file raises
    ``ValueError`` naming both."""
    for r in runs["ranks"]:
        msg = r["wrong_n"]
        assert msg is not None and "8 nodes" in msg and "= 4" in msg, msg
