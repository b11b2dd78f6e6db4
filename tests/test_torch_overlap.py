"""Port parity: overlapped gossip (``mixing.start_round``,
``finish_round``, ``overlap_flush``, ``simulate(overlap=True)``) against
the live JAX package on the CPU, where the port's fused apply takes the
per-shard compensated kernel's plain twin.

The JAX side runs as ``tests/test_overlap.py`` runs it: the stacked
``backend="reference"`` rounds (the reference's own sharded overlap suite
holds its sharded rounds against them too).  Inputs are made by numpy
from a seed and handed to both.  Tolerances, with their reasons:

* dense rounds, fp32: atol 1e-6 on unit-normal inputs.  The apply sums
  ``M·b`` over the 8 nodes in another order (a BLAS matmul against XLA's
  dot, or the sharded path's gathered row-blocks; the reference's own
  sharded suite holds ring at 1e-6);
* the bf16 wire: the captured buffer bitwise (both round to nearest
  even), the apply atol 1e-6 (the cast happens once, at capture, so the
  apply is exact fp32 arithmetic on equal operands);
* int8 + EF, stacked and sharded: the codes agree exactly on equal
  inputs, so the buffered estimate and the EF memory are held to atol
  1e-6 and the apply to 2e-5, as ``tests/test_torch_sharded.py`` holds
  the synchronous compressed rounds; the node average is kept to 1e-5;
* the flush's global average: the port's is x̄ by pairwise halving,
  exactly equal rows (consensus 0.0) and atol 1e-6 from the reference's
  mean; its re-primed buffer bitwise the flushed iterate;
* ``simulate(overlap=True)``: full gradients (the generators differ,
  ROADMAP C.3), loss rtol 2e-6, consensus rtol 5e-6 + atol 1e-12, int8
  + EF consensus rtol 5e-5, as ``tests/test_torch_algorithms.py`` holds
  the synchronous simulator; against the port-side stale recursion
  ``x_{t+1} = y_t + (W − I)·y_{t−1}``: bitwise (the same operations in
  the same order on the CPU); plain overlapped gossip with batch-8
  gradients diverging (consensus > 1e6 in 150 steps) in both packages,
  PGA staying below 10;
* the overlapped Trainer (reduced pga-lm-100m at fp32, SGD, 4 nodes
  over one_peer_exp, H = 3, 4 steps) against the JAX Trainer from one
  set of weights: params rtol 1e-5, atol 1e-7, loss and consensus rtol
  1e-5, as the synchronous Trainer in ``tests/test_torch_train.py``;
  int8 + EF there: the forward and backward sum in another order, and
  stochastic rounding turns a 1-ulp difference on a code boundary into
  one code step, which the next captures carry on (the overlapped step
  quantizes twice at a flush: the collective and the re-prime).  So
  every param and EF element within two code steps of its leaf (absmax/
  127; the collective's power-of-two step is up to two of them), all but
  5e-5 of them within 1e-6 (measured, stacked: 121 of 5,772,288 params
  and 137 EF elements off, at most 1.57 code steps), loss and consensus
  rtol 1e-4, as ``tests/test_torch_train.py``'s compressed Trainer.
  One step per ``run()`` against one ``run(steps=4)``: bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as JC
from repro.configs import base as jcfg
from repro.configs import pga_lm_100m as jarch
from repro.core import mixing as jmix
from repro.core import simulate as jsim
from repro.data import make_logistic_problem as jproblem
from repro.train.trainer import Trainer as JTrainer
from repro_torch import compress as TC
from repro_torch import interop
from repro_torch.configs import base as tcfg_mod
from repro_torch.configs import pga_lm_100m as tarch
from repro_torch.core import mixing as tmix
from repro_torch.core import simulate as tsim
from repro_torch.core import topology as ttopo
from repro_torch.core.mesh import make_mesh
from repro_torch.core.schedule import make_schedule
from repro_torch.data import make_logistic_problem as tproblem
from repro_torch.kernels import mixing_cuda as tmc
from repro_torch.train import Trainer as TTrainer
from repro_torch.tree import pairwise_mean, tree_leaves

torch.set_num_threads(2)

N = 8
SHAPES = [(5, 3), (7,), ()]


def _tree(seed, n=N, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {f"leaf{i}": rng.standard_normal((n,) + s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _jax(tree):
    return None if tree is None else jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return None if tree is None else jax.tree.map(torch.from_numpy, tree)


def _close(jtree, ttree, atol, rtol=0.0):
    jl, tl = jax.tree.leaves(jtree), jax.tree.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(b.float() if torch.is_tensor(b)
                                              else b, np.float32),
                                   np.asarray(a, np.float32), rtol=rtol,
                                   atol=atol)


def _specs(topology, *, backend="pallas", cd=None, name="none",
           global_name="none", mesh=None):
    """The JAX stacked reference spec and the port's spec (a ``mesh`` of
    node shards routes the port through the sharded rounds)."""
    jspec = jmix.CommSpec(
        topology=topology, n_nodes=N, backend="reference",
        comm_dtype=None if cd is None else jnp.bfloat16,
        compressor=JC.make_compressor(name),
        global_compressor=JC.make_compressor(global_name)).validate()
    tspec = tmix.CommSpec(
        topology=topology, n_nodes=N, backend=backend, mesh=mesh,
        shard_mode="sharded" if mesh is not None else "auto",
        comm_dtype=None if cd is None else torch.bfloat16,
        compressor=TC.make_compressor(name),
        global_compressor=TC.make_compressor(global_name)).validate()
    return jspec, tspec


def _mesh(k=4):
    return make_mesh((k,), ("data",), device="cpu")


# ---------------------------------------------------------------------------
# start_round / finish_round against the JAX functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topology", ("ring", "one_peer_exp", "grid"))
@pytest.mark.parametrize("cd", (None, "bf16"))
@pytest.mark.parametrize("where", ("reference", "pallas", "sharded"))
def test_dense_start_finish_matches_reference(topology, cd, where):
    """The dense double buffer, stacked on both backends and on a mesh of
    4 node shards (A.10.4), applied with the factors of three issuing
    shifts (one_peer_exp changes hop every step)."""
    y, b = _tree(0), _tree(1)
    mesh = _mesh() if where == "sharded" else None
    jspec, tspec = _specs(topology, cd=cd, mesh=mesh,
                          backend="reference" if where == "reference"
                          else "pallas")
    jrs, jef = jmix.start_round(_jax(b), jspec)
    trs, tef = tmix.start_round(_torch(b), tspec)
    assert jef is None and tef is None and set(trs) == {"q"}
    for a, t in zip(jax.tree.leaves(jrs["q"]), tree_leaves(trs["q"])):
        assert t.dtype == (torch.float32 if cd is None else torch.bfloat16)
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      t.float().numpy())
    for step in (0, 1, 2):
        want = jmix.finish_round(_jax(y), jrs, jspec, step=step)
        got = tmix.finish_round(_torch(y), trs, tspec, step=step)
        _close(want, got, atol=1e-6)


@pytest.mark.parametrize("topology", ("ring", "one_peer_exp"))
@pytest.mark.parametrize("where", ("reference", "pallas", "sharded"))
def test_int8_ef_start_finish_matches_reference(topology, where):
    """int8 + EF: the stacked modes buffer the decoded estimate, the
    sharded one the wire arrays (4 shards of 2 nodes); the EF memory
    advances against the buffered payload; the apply keeps the node
    average for the stale payload."""
    y, b = _tree(2), _tree(3)
    ef0 = jax.tree.map(np.zeros_like, b)
    mesh = _mesh() if where == "sharded" else None
    jspec, tspec = _specs(topology, name="int8", mesh=mesh,
                          backend="reference" if where == "reference"
                          else "pallas")
    jrs, jef = jmix.start_round(_jax(b), jspec, ef_state=_jax(ef0), seed=3)
    trs, tef = tmix.start_round(_torch(b), tspec, ef_state=_torch(ef0),
                                seed=3)
    _close(jef, tef, atol=1e-6)
    assert sum(float(e.abs().sum()) for e in tree_leaves(tef)) > 0.0
    if where == "sharded":
        assert set(trs) == {"wire"} and len(trs["wire"]) == len(SHAPES)
    else:
        _close(jrs["q"], trs["q"], atol=1e-6)
    for step in (1, 2):
        want = jmix.finish_round(_jax(y), jrs, jspec, step=step)
        got = tmix.finish_round(_torch(y), trs, tspec, step=step)
        _close(want, got, atol=2e-5)
        for g, x in zip(tree_leaves(got), tree_leaves(_torch(y))):
            np.testing.assert_allclose(g.mean(0).numpy(), x.mean(0).numpy(),
                                       atol=1e-5)


@pytest.mark.parametrize("compressed", (False, True))
def test_sharded_wire_apply_is_the_synchronous_rounds(compressed):
    """The synchronous sharded round is the overlapped one with a buffer
    of the current iterate: the same apply code (the wire split of
    ``_communicate_sharded_compressed``; the dense halo gather)."""
    x = _torch(_tree(4))
    name = "int8" if compressed else "none"
    _, tspec = _specs("one_peer_exp", name=name, mesh=_mesh())
    ef0 = jax.tree.map(torch.zeros_like, x) if compressed else None
    sync = tmix.communicate(x, tspec, phase="gossip", step=1,
                            ef_state=ef0, seed=7)
    if compressed:
        sync, sync_ef = sync
    zeros = jax.tree.map(torch.zeros_like, x)
    # a compensated round on a zero iterate with the buffer b = x is
    # (W − I)·x; plus x it is the synchronous W·x
    rs, ef = tmix.start_round(x, tspec, ef_state=ef0, seed=7)
    got = tmix.finish_round(zeros, rs, tspec, step=1)
    for s, g, xx in zip(tree_leaves(sync), tree_leaves(got),
                        tree_leaves(x)):
        np.testing.assert_allclose((g + xx).numpy(), s.numpy(), atol=1e-5)
    if compressed:
        for a, b in zip(tree_leaves(sync_ef), tree_leaves(ef)):
            assert torch.equal(a, b)


ISSUED = [(where, buf) for where in ("1d", "2d")
          for buf in ("fp32", "bf16", "int8", "topk")]


@pytest.mark.parametrize("where,buf", ISSUED, ids=lambda v: v)
def test_issued_round_is_the_serial_round_bitwise(where, buf):
    """``finish_round(issue_round(b))`` is ``finish_round(b)`` bit for bit
    on one-process meshes of 4 node shards and of (data=2, model=2), for
    the dense fp32 and bf16-wire buffers and the int8 and top-k wire
    arrays, at three issuing shifts (on CPU tensors the issue gathers at
    once); each also matches the JAX ``finish_round`` (dense atol 1e-6,
    lossy 2e-5, as above).  An issued round is not issued again, and its
    halo is not applied with another shift."""
    mesh = (_mesh() if where == "1d"
            else make_mesh((2, 2), ("data", "model"), device="cpu"))
    name = buf if buf in ("int8", "topk") else "none"
    jspec, tspec = _specs("one_peer_exp", cd="bf16" if buf == "bf16"
                          else None, name=name, mesh=mesh)
    y, b = _tree(5), _tree(6)
    ef0 = jax.tree.map(np.zeros_like, b) if name != "none" else None
    jrs, _ = jmix.start_round(_jax(b), jspec, ef_state=_jax(ef0), seed=3)
    trs, _ = tmix.start_round(_torch(b), tspec, ef_state=_torch(ef0),
                              seed=3)
    for step in (0, 1, 2):
        serial = tmix.finish_round(_torch(y), trs, tspec, step=step)
        issued = tmix.issue_round(trs, tspec, step=step)
        assert "halo" in issued and "halo" not in trs
        got = tmix.finish_round(_torch(y), issued, tspec, step=step)
        tmix.drain_round(issued)
        for a, g in zip(tree_leaves(serial), tree_leaves(got)):
            assert a.dtype == g.dtype and torch.equal(a, g)
        _close(jmix.finish_round(_jax(y), jrs, jspec, step=step), got,
               atol=1e-6 if name == "none" else 2e-5)
    with pytest.raises(ValueError, match="already issued"):
        tmix.issue_round(issued, tspec, step=2)
    with pytest.raises(ValueError, match="issued for shift 2"):
        tmix.finish_round(_torch(y), issued, tspec, step=1)


@pytest.mark.parametrize("backend", ("reference", "pallas"))
def test_stacked_round_has_nothing_to_issue(backend):
    """The stacked apply gathers nothing (``q_self is qs``): its round
    state comes back from ``issue_round`` as it went in."""
    _, tspec = _specs("one_peer_exp", backend=backend)
    trs, _ = tmix.start_round(_torch(_tree(7)), tspec)
    assert tmix.issue_round(trs, tspec, step=1) is trs
    tmix.drain_round(trs)


# ---------------------------------------------------------------------------
# Flush, EF, the buffer's storage
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ("reference", "pallas"))
@pytest.mark.parametrize("phase", ("global", "gossip"))
def test_flush_matches_reference(backend, phase):
    """The synchronous round and the re-prime: after a global flush the
    nodes are exactly equal (consensus 0.0) and the buffer is the
    averaged iterate, bitwise."""
    y = _tree(5)
    jspec, tspec = _specs("ring", backend=backend)
    jm, jb, jef = jmix.overlap_flush(_jax(y), jspec, phase=phase, step=1)
    tm, tb, tef = tmix.overlap_flush(_torch(y), tspec, phase=phase, step=1)
    assert jef is None and tef is None
    _close(jm, tm, atol=1e-6)
    for m, q in zip(tree_leaves(tm), tree_leaves(tb["q"])):
        assert torch.equal(m, q) and m.data_ptr() != q.data_ptr()
        if phase == "global":
            assert torch.equal(m, pairwise_mean(m).expand(m.shape))


def test_lossy_flush_advances_ef_twice():
    """int8 gossip + int8 collective + EF: the flush's EF memory is the
    collective round's advanced once more by the re-prime's capture, and
    matches the reference's."""
    y = _tree(6)
    ef0 = jax.tree.map(np.zeros_like, y)
    jspec, tspec = _specs("ring", name="int8", global_name="int8")
    jm, jrs, jef = jmix.overlap_flush(_jax(y), jspec, phase="global", step=0,
                                      ef_state=_jax(ef0), seed=4)
    tm, trs, tef = tmix.overlap_flush(_torch(y), tspec, phase="global",
                                      step=0, ef_state=_torch(ef0), seed=4)
    _close(jm, tm, atol=2e-5)
    _close(jef, tef, atol=1e-6)
    _close(jrs["q"], trs["q"], atol=1e-6)
    once, ef1 = tmix.communicate(_torch(y), tspec, phase="global", step=0,
                                 ef_state=_torch(ef0), seed=4)
    _, ef2 = tmix.start_round(once, tspec, ef_state=ef1, seed=4)
    for a, b, c in zip(tree_leaves(tef), tree_leaves(ef2),
                       tree_leaves(ef1)):
        assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("dtype,cd", ((torch.float32, None),
                                      (torch.bfloat16, torch.bfloat16)))
def test_buffer_owns_its_storage(dtype, cd):
    """The dense buffer is a copy even where the cast is a no-op: writing
    into the params after ``start_round`` leaves it unchanged."""
    x = {k: v.to(dtype) for k, v in _torch(_tree(7)).items()}
    spec = tmix.CommSpec(topology="ring", n_nodes=N, backend="pallas",
                         comm_dtype=cd).validate()
    rs, _ = tmix.start_round(x, spec)
    before = [q.clone() for q in tree_leaves(rs["q"])]
    for p in tree_leaves(x):
        p.add_(1.0)
    for q, b in zip(tree_leaves(rs["q"]), before):
        assert torch.equal(q, b)


def test_apply_refuses_an_output_over_the_buffer():
    """The per-shard kernel's wrapper still refuses an ``out`` that shares
    storage with its inputs, the buffer (``q_self is qs``) included."""
    rng = np.random.default_rng(8)
    x, b = (torch.from_numpy(rng.standard_normal((N, 16)).astype(np.float32))
            for _ in range(2))
    w, M = (torch.from_numpy(a) for a in tmix.compensated_round_factors(
        "gossip", "ring", N))
    for out in (b, x, b[:, :]):
        with pytest.raises(ValueError, match="shares storage"):
            tmc.shard_comp_mix_block(x, b, b, w, M, out=out)
    o = tmc.shard_comp_mix_block(x, b, b, w, M, out=torch.empty_like(x))
    assert torch.equal(o, tmc.shard_comp_mix_block_plain(x, b, b, w, M))


def test_fused_apply_runs_per_dispatch_group():
    """The stacked fused apply packs only each dispatch group: a leaf at
    or above the threshold is its own group, the small ones one staging
    group; every column is the per-leaf reference's."""
    tree = _torch(_tree(9, shapes=[(3, 4), (40,), (2,), ()]))
    buf = _torch(_tree(10, shapes=[(3, 4), (40,), (2,), ()]))
    leaves = tree_leaves(tree)
    assert [len(g) for g in tmc._dispatch_groups(leaves, 16)] == [3, 1]
    got = tmc.compensated_apply(tree, buf, topology="one_peer_exp",
                                n_nodes=N, step=1, leaf_threshold=16)
    want = tmix._compressed_round_reference(tree, buf, "gossip",
                                            "one_peer_exp", N, 1, 1)
    _close(want, got, atol=1e-6)


# ---------------------------------------------------------------------------
# simulate(overlap=True)
# ---------------------------------------------------------------------------
ALGORITHMS = ("parallel", "gossip", "local", "gossip_pga", "gossip_aga",
              "slowmo", "hier_pga", "gt_pga")
SIM_N, SIM_M, SIM_D, SIM_STEPS, SIM_EVAL = 8, 64, 10, 30, 5


@pytest.fixture(scope="module")
def problems():
    return (jproblem(n=SIM_N, M=SIM_M, d=SIM_D, seed=0),
            tproblem(n=SIM_N, M=SIM_M, d=SIM_D, seed=0, device="cpu"))


def _sim_kwargs(algorithm, topology, backend, **extra):
    kw = dict(algorithm=algorithm, n=SIM_N, steps=SIM_STEPS, lr=0.2, H=6,
              topology=topology, eval_every=SIM_EVAL, backend=backend,
              slowmo_beta=0.5, slowmo_lr=0.7, overlap=True, **extra)
    if algorithm == "hier_pga":
        kw["aga_kwargs"] = {"n_pods": 2, "hier_h_pod": 3}
    if algorithm == "gossip_aga":
        kw["aga_kwargs"] = {"aga_h_init": 2, "aga_warmup": 10}
    return kw


def _sim_pair(problems, algorithm, topology, backend, **extra):
    jp, tp = problems
    want = jsim(grad_fn=jp.grad_fn(0), loss_fn=jp.loss_fn(),
                x0=jnp.zeros(SIM_D),
                **_sim_kwargs(algorithm, topology, "reference", **extra))
    got = tsim(grad_fn=tp.grad_fn(0), loss_fn=tp.loss_fn(),
               x0=torch.zeros(SIM_D), device="cpu",
               **_sim_kwargs(algorithm, topology, backend, **extra))
    np.testing.assert_array_equal(got["iteration"], want["iteration"])
    return want, got


@pytest.mark.parametrize("algorithm,topology,backend", [
    ("gossip_pga", "ring", "pallas"), ("gossip_pga", "ring", "reference"),
    ("gossip_pga", "one_peer_exp", "pallas"),
    ("gossip_pga", "one_peer_exp", "reference"),
    ("gossip", "grid", "pallas")] + [
    (a, "ring", "pallas") for a in ALGORITHMS
    if a not in ("gossip_pga",)])
def test_simulate_overlap_matches_reference(problems, algorithm, topology,
                                            backend):
    want, got = _sim_pair(problems, algorithm, topology, backend)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-6)
    np.testing.assert_allclose(got["consensus"], want["consensus"],
                               rtol=5e-6, atol=1e-12)
    if algorithm == "gossip_aga":
        assert got["H_history"].tolist() == want["H_history"].tolist()


@pytest.mark.parametrize("backend", ("reference", "pallas"))
def test_compressed_simulate_overlap_matches_reference(problems, backend):
    want, got = _sim_pair(problems, "gossip_pga", "one_peer_exp", backend,
                          compression="int8", error_feedback=True,
                          global_compression="int8")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-6)
    np.testing.assert_allclose(got["consensus"], want["consensus"],
                               rtol=5e-5)


def _stale_recursion(problem, *, topology, steps, H, lr, eval_every):
    """Hand-rolled port-side oracle of gossip_pga overlapped: step k's
    gossip applies the compensated factors of the buffer's priming shift
    to ``y_{k−1}``; global steps average synchronously and re-prime."""
    grad_fn, loss_fn = problem.grad_fn(batch=16), problem.loss_fn()
    n = problem.n
    sched = make_schedule(tcfg_mod.DistConfig(algorithm="gossip_pga",
                                              topology=topology, H=H))
    period = ttopo.schedule_period(topology, n)
    generator = torch.Generator().manual_seed(0)
    x = torch.zeros(problem.d)[None].expand(n, problem.d).contiguous()
    buf, bshift = x.clone(), sched.gossip_shift_step(0, period)
    losses, consensus = [], []
    for k in range(steps):
        phase = sched.advance(k)
        shift = sched.gossip_shift_step(k, period)
        y = x - lr * grad_fn(x, generator, k)
        if phase == "gossip":
            w, M = (torch.from_numpy(a) for a in
                    tmix.compensated_round_factors("gossip", topology, n,
                                                   bshift, 1))
            x = y + (torch.matmul(M, buf) - w * buf)
            buf = y
        else:
            x = torch.mean(y, dim=0, keepdim=True).expand(y.shape)
            buf = x
        bshift = shift
        if k % eval_every == 0 or k == steps - 1:
            xbar = pairwise_mean(x)[0]
            losses.append(float(loss_fn(xbar)))
            consensus.append(float(torch.mean(torch.sum((x - xbar) ** 2,
                                                        -1))))
    return np.array(losses), np.array(consensus)


@pytest.mark.parametrize("topology", ("ring", "one_peer_exp"))
def test_simulate_overlap_is_the_stale_recursion_bitwise(problems,
                                                         topology):
    _, tp = problems
    got = tsim(algorithm="gossip_pga", grad_fn=tp.grad_fn(batch=16),
               loss_fn=tp.loss_fn(), x0=torch.zeros(SIM_D), n=SIM_N,
               steps=25, lr=0.1, topology=topology, H=6, eval_every=5,
               overlap=True, device="cpu")
    want_loss, want_cons = _stale_recursion(tp, topology=topology, steps=25,
                                            H=6, lr=0.1, eval_every=5)
    np.testing.assert_array_equal(got["loss"], want_loss)
    np.testing.assert_array_equal(got["consensus"], want_cons)


def test_overlapped_gossip_diverges_where_pga_does_not(problems):
    """The one-step-stale recursion is not damped where W has negative
    eigenvalues (the ring's reach −1/3).  With batch-8 gradients plain
    overlapped gossip's consensus grows past 1e6 within 150 steps in the
    reference and in the port alike (their noise draws differ, C.3),
    while PGA's flush keeps both below 10: a property of the algorithm,
    kept for parity."""
    jp, tp = problems
    for algorithm, diverges in (("gossip", True), ("gossip_pga", False)):
        kw = dict(algorithm=algorithm, n=SIM_N, steps=150, lr=0.2,
                  topology="ring", H=16, eval_every=50, overlap=True)
        want = jsim(grad_fn=jp.grad_fn(8), loss_fn=jp.loss_fn(),
                    x0=jnp.zeros(SIM_D), **kw)
        got = tsim(grad_fn=tp.grad_fn(8), loss_fn=tp.loss_fn(),
                   x0=torch.zeros(SIM_D), device="cpu", **kw)
        for out in (want, got):
            c = float(out["consensus"][-1])
            assert (c > 1e6) if diverges else (c < 10.0), (algorithm, c)


def test_push_sum_overlap_is_refused_as_the_reference(problems):
    jp, tp = problems
    with pytest.raises(ValueError) as want:
        jsim(grad_fn=jp.grad_fn(0), loss_fn=jp.loss_fn(),
             x0=jnp.zeros(SIM_D), push_sum=True,
             **_sim_kwargs("gossip_pga", "directed_ring", "reference"))
    with pytest.raises(ValueError) as got:
        tsim(grad_fn=tp.grad_fn(0), loss_fn=tp.loss_fn(),
             x0=torch.zeros(SIM_D), device="cpu", push_sum=True,
             **_sim_kwargs("gossip_pga", "directed_ring", "reference"))
    assert str(got.value) == str(want.value)
    assert "comm_overlap" in str(got.value)


# ---------------------------------------------------------------------------
# The overlapped Trainer against the JAX Trainer
# ---------------------------------------------------------------------------
TRAIN_STEPS = 4
TRAIN_PHASES = ["gossip", "gossip", "global", "gossip"]
INT8_EF = dict(comm_compression="int8", comm_global_compression="int8",
               comm_error_feedback=True)


def _train_configs(compressed):
    dist = dict(algorithm="gossip_pga", topology="one_peer_exp", H=3,
                comm_overlap=True, **(INT8_EF if compressed else {}))
    opt = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
    common = dict(global_batch=8, seq_len=32, log_every=1)
    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(comm_backend="reference", **dist),
        optimizer=jcfg.OptimizerConfig(**opt), **common)
    tt = tcfg_mod.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg_mod.DistConfig(comm_backend="pallas", **dist),
        optimizer=tcfg_mod.OptimizerConfig(**opt), **common)
    return jt, tt


@pytest.fixture(scope="module", params=(False, True),
                ids=("dense", "int8_ef"))
def jax_run(request):
    """The JAX Trainer's overlapped run and the weights it started from."""
    jt, _ = _train_configs(request.param)
    jtr = JTrainer(jt, n_nodes=4, with_consensus=True)
    jst = jtr.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree.map(lambda p: np.asarray(p[0]),
                        jax.device_get(jst.params))
    jst = jtr.run(jst, steps=TRAIN_STEPS, log_every=1)
    return request.param, row0, jst, jtr.history


def _port_run(compressed, row0, *, mesh=None, per_step=False):
    _, tt = _train_configs(compressed)
    ttr = TTrainer(tt, n_nodes=4, mesh=mesh, with_consensus=True,
                   device="cpu")
    tst = ttr.init_state(params=interop.from_numpy(row0, "cpu"))
    if per_step:
        for _ in range(TRAIN_STEPS):
            tst = ttr.run(tst, steps=1, log_every=1)
    else:
        tst = ttr.run(tst, steps=TRAIN_STEPS, log_every=1)
    return tst, ttr


def _trees_close(want, got, compressed, like=None):
    """``like``: the params whose leaves set the code steps."""
    wl = jax.tree.leaves(jax.device_get(want))
    gl = jax.tree.leaves(interop.to_numpy(got))
    assert len(wl) == len(gl)
    if not compressed:
        for a, b in zip(wl, gl):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
        return
    size = sum(a.size for a in wl)
    off = sum(int((np.abs(a - b) > 1e-6).sum()) for a, b in zip(wl, gl))
    # each element within two int8 code steps of its leaf (absmax/127 of
    # the leaf in ``like``; a collective's power-of-two step is up to two)
    steps = max(float(np.abs(a - b).max())
                / (float(np.abs(p).max()) / 127.0)
                for a, b, p in zip(wl, gl, jax.tree.leaves(like)))
    assert off <= 5e-5 * size and steps <= 2.0, (off, steps)


@pytest.mark.parametrize("sharded", (False, True),
                         ids=("stacked", "sharded"))
def test_trainer_overlap_matches_reference(jax_run, sharded):
    """Stacked and on a mesh of 2 node shards, uncompressed and int8 +
    EF: per-step phases, loss and consensus (0.0 after the uncompressed
    global flush), params and EF memory; one ``run()`` per step gives
    bitwise the state of one ``run(steps=4)``, the buffer kept across the
    calls."""
    compressed, row0, jst, jhist = jax_run
    mesh = make_mesh((2,), ("data",), device="cpu") if sharded else None
    tst, ttr = _port_run(compressed, row0, mesh=mesh)
    assert [r["phase"] for r in ttr.history] == \
        [r["phase"] for r in jhist] == TRAIN_PHASES
    rtol = 1e-4 if compressed else 1e-5
    for jr, tr in zip(jhist, ttr.history):
        for key in ("loss", "consensus"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=rtol)
        if tr["phase"] == "global" and not compressed:
            assert tr["consensus"] == 0.0
    like = jax.device_get(jst.params)
    _trees_close(jst.params, tst.params, compressed, like)
    if compressed:
        _trees_close(jst.extras["ef_state"], tst.ef_state, True, like)
    step_st, step_tr = _port_run(compressed, row0, mesh=mesh, per_step=True)
    for a, b in zip(tree_leaves((tst.params, tst.extras)),
                    tree_leaves((step_st.params, step_st.extras))):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(ttr._comm_buf), tree_leaves(
            step_tr._comm_buf)):
        assert torch.equal(a, b)
    assert ttr._buf_shift == step_tr._buf_shift


def test_phase_none_leaves_the_buffer_in_flight():
    """A ``"none"`` step (Local SGD between its averages) neither
    finishes nor re-primes: the step returns the very buffer it got."""
    _, tt = _train_configs(False)
    tt = tt.replace(dist=dataclasses.replace(tt.dist, algorithm="local"))
    ttr = TTrainer(tt, n_nodes=4, device="cpu")
    st = ttr.init_state(torch.Generator().manual_seed(0))
    st = ttr._prime(st)
    buf = ttr._comm_buf
    step_fn = ttr._get_step_fn("none", 0)
    st2, metrics, new_buf = step_fn(st, ttr.device_batch(0), 0.05, buf)
    assert new_buf is buf and np.isfinite(float(metrics["loss"]))
    assert not torch.equal(tree_leaves(st2.params)[0],
                           tree_leaves(st.params)[0])


def test_occupancy_calibration_waits_for_obs():
    """The occupancy calibration (ROADMAP A.6, ported): off for None
    (no JSONL sink) and False, one ``occupancy`` record for True, taken
    on clones, so the run ends bitwise where the others end."""
    _, tt = _train_configs(False)
    ends, records = [], []
    for flag in (None, False, True):
        tr = TTrainer(tt, n_nodes=4, measure_occupancy=flag, device="cpu")
        st = tr.run(tr.init_state(torch.Generator().manual_seed(0)),
                    steps=3, log_every=1)
        ends.append(tree_leaves((st.params, st.opt_state, tr._comm_buf)))
        records.append([r for r in tr.telemetry.ring().records("comm_round")
                        if r["role"] == "occupancy"])
    assert [len(r) for r in records] == [0, 0, 1]
    assert 0.0 <= records[2][0]["occupancy"] <= 1.0
    for a, b, c in zip(*ends):
        assert torch.equal(a, b) and torch.equal(a, c)
