"""Port parity: 2-D ``(node, model)`` rank meshes on the CPU — one
``torch.distributed`` rank per block of a ``(data=2, model=2)`` mesh.

Four gloo ranks are spawned once for the module (:func:`runs`); rank
``(r, c)`` holds the rows of node shard r whole and computes column chunk
c of every round, the chunks then gathered across the model axis into
whole rows.  Each case builds its inputs with numpy from a seed for all n
nodes and hands a rank its node shard's rows.  The one-process 2-D mesh
(every block in this process) and the JAX references are computed here
while the ranks run.

Held to, with the tolerances and their reasons:
* the one-process 2-D round on the same inputs: **bitwise**, each rank's
  column block before the gather (its chunk of the packed matrix, the
  uncompressed rounds) and its whole rows after it — the ranks run the
  same chunk bodies on the same rows and halos, every sum over node
  shards is the same left fold of gathered partials, and the gather moves
  disjoint columns as bytes;
* the live JAX stacked reference, at ``tests/test_torch_sharded.py``'s
  tolerances (atol 1e-5 fp32, 3e-2 with the bf16 wire, compressed rounds
  and their EF 2e-5);
* a round's exchange bytes: the node-axis halo of an uncompressed gossip
  round moves 1/k_model of the 1-D round's columns, and the model-axis
  gather brings the other chunk back (equal sizes: the leaves' columns
  divide by 2);
* the Trainer on the rank mesh, n = 4 (2 nodes a node shard), 4 steps,
  against the one-process 2-D Trainer: params within atol 1e-7, rtol
  1e-6 and the losses within rtol 1e-6 (``tests/test_torch_dist_train.py``'s
  bounds: the CPU's GEMMs may block a batch of 2 nodes otherwise than one
  of 4); the clipped case's joint gradient norm, folded over the node-axis
  ranks only, within rtol 1e-6 of the one-process one (counted k_model
  times it would be √2 larger, and the clip would scale the step by
  1/√2); the rank Trainer's Gossip-PGA run against the JAX Trainer
  without a mesh as that file holds the 1-D ranks (params rtol 1e-5 atol
  1e-7, the loss rtol 1e-5); checkpoints raise naming A.10.1.

JAX is imported inside the tests, never at module top: a spawned rank
imports this module to find its worker and must load no JAX
(``tests/test_torch_isolation.py`` holds this).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import compress as TC
from repro_torch import interop
from repro_torch.configs import base as tcfg
from repro_torch.configs import pga_lm_100m as tarch
from repro_torch.core import mixing as tmix
from repro_torch.core.mesh import make_mesh, run_ranks
from repro_torch.kernels import mixing_cuda as tmc
from repro_torch.train import Trainer
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

RANKS, KN, KM = 4, 2, 2                 # ranks, node shards, model shards
N = 8                                   # nodes of the round cases
SHAPES = [(5, 3), (7,), (), (2100,)]
AXES = ((KN, KM), ("data", "model"))
PHASES = [("gossip", "ring", 1), ("gossip", "exp", 1),
          ("gossip", "one_peer_exp", 1), ("gossip", "grid", 1),
          ("global", "ring", 1), ("pod_avg", "ring", 2),
          ("pod_avg", "ring", 4)]
ROUNDS = [(p, t, pods, cd) for (p, t, pods) in PHASES
          for cd in (None, "bfloat16")]
RESIDUAL = (("gossip", "ring"), ("gossip", "one_peer_exp"),
            ("pod_avg", "ring"), ("global", "ring"))
COMPRESSED = ("int8", "fp8", "topk", "randk")
CPHASES = (("gossip", "one_peer_exp", 0), ("gossip", "one_peer_exp", 1),
           ("gossip", "ring", 0), ("global", "ring", 0),
           ("pod_avg", "ring", 0))
COLLECTIVE = ("int8", "fp8")
OVERLAP = ("none", "int8", "topk")

# the Trainer cases: 4 nodes, 4 steps (gossip, global, gossip, global)
TN, STEPS = 4, 4
DIST = dict(algorithm="gossip_pga", topology="one_peer_exp", H=2,
            comm_backend="pallas", comm_shard_mode="sharded")
OPT = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
COMMON = dict(global_batch=8, seq_len=8, log_every=1)
TCASES = [("pga", {}, {}, {}),
          ("clip", {}, dict(grad_clip=0.05), {}),
          ("compressed", dict(comm_compression="int8",
                              comm_global_compression="int8",
                              comm_error_feedback=True), {}, {}),
          ("overlap", dict(comm_overlap=True), {}, {}),
          ("push", dict(topology="directed_exp", push_sum=True), {}, {}),
          ("ckpt", {}, {}, dict(ckpt_every=2, ckpt_dir="unused"))]
REFUSED = ("ckpt",)


def _id(case) -> str:
    return "-".join(str(c) for c in case)


def _tree(seed, n=N):
    rng = np.random.default_rng(seed)
    return {f"leaf{i}": rng.standard_normal((n,) + s).astype(np.float32)
            for i, s in enumerate(SHAPES)}


def _ef(seed, n=N):
    rng = np.random.default_rng(seed)
    return {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in _tree(seed + 50, n).items()}


def _rows(tree, rows):
    if tree is None:
        return None
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
            for k, v in tree.items()}


def _flat(out):
    return [t for t in tree_leaves(out) if torch.is_tensor(t)]


def _spec(mesh, topology, n_pods=1, cd=None, name="none",
          global_name="none"):
    return tmix.CommSpec(
        topology=topology, n_nodes=N, n_pods=n_pods, backend="pallas",
        mesh=mesh, shard_mode="sharded",
        comm_dtype=None if cd is None else torch.bfloat16,
        compressor=TC.make_compressor(name, k=3),
        global_compressor=TC.make_compressor(global_name)).validate()


# ---------------------------------------------------------------------------
# The round cases: each runs on a mesh and a row slice of the inputs
# ---------------------------------------------------------------------------
def _round_case(case, mesh, rows):
    phase, topology, pods, cd = case
    return _flat(tmix.communicate(_rows(_tree(0), rows),
                                  _spec(mesh, topology, pods, cd),
                                  phase=phase, step=3))


def _residual_case(case, mesh, rows):
    phase, topology = case
    return _flat(tmix.communicate_sharded(
        _rows(_tree(3), rows), _spec(mesh, topology, 2), phase=phase,
        step=1, with_residual=True))


def _half_step_case(case, mesh, rows):
    return _flat(tmix.communicate_sharded(
        _rows(_tree(4), rows), _spec(mesh, "ring"), phase="gossip",
        grads=_rows(_tree(5), rows), gamma=0.37))


def _compressed_case(name, mesh, rows):
    out = []
    for phase, topology, step in CPHASES:
        out += _flat(tmix.communicate(
            _rows(_tree(6), rows), _spec(mesh, topology, 2, name=name),
            phase=phase, step=step, ef_state=_rows(_ef(1), rows),
            seed=5 + step))
    return out


def _collective_case(name, mesh, rows):
    out = []
    for phase in ("global", "pod_avg"):
        out += _flat(tmix.communicate(
            _rows(_tree(7), rows), _spec(mesh, "ring", 2, global_name=name),
            phase=phase, ef_state=_rows(_ef(2), rows), seed=9))
    return out


def _push_case(case, mesh, rows):
    from repro_torch.core.faults import push_round
    W, _ = push_round("directed_exp", N, "gossip", 1, 1, None)
    w = np.random.default_rng(2).uniform(0.5, 1.5, (N, 1)).astype(
        np.float32)
    x, new_w = tmix.communicate_push_sum(
        _rows(_tree(8), rows), torch.from_numpy(w[rows].copy()), W=W,
        n_nodes=N, backend="pallas", mesh=mesh)
    return _flat(x) + [new_w]


def _overlap_case(name, mesh, rows):
    spec = _spec(mesh, "one_peer_exp", name=name)
    ef = _rows(_ef(3), rows) if name != "none" else None
    buf, ef1 = tmix.start_round(_rows(_tree(9), rows), spec, ef_state=ef,
                                seed=3)
    mixed = tmix.finish_round(_rows(_tree(10), rows), buf, spec, step=1)
    return _flat(mixed) + (_flat(ef1) if ef1 is not None else [])


CASES = ([("round", c) for c in ROUNDS]
         + [("residual", c) for c in RESIDUAL]
         + [("half_step", ("ring",))]
         + [("compressed", c) for c in COMPRESSED]
         + [("collective", c) for c in COLLECTIVE]
         + [("push", ("directed_exp",))]
         + [("overlap", c) for c in OVERLAP])
RUN = {"round": _round_case, "residual": _residual_case,
       "half_step": _half_step_case, "compressed": _compressed_case,
       "collective": _collective_case, "push": _push_case,
       "overlap": _overlap_case}


# ---------------------------------------------------------------------------
# The Trainer cases
# ---------------------------------------------------------------------------
def _config(dist_kw, opt_kw, extra):
    return tcfg.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg.DistConfig(**{**DIST, **dist_kw}),
        optimizer=tcfg.OptimizerConfig(**{**OPT, **opt_kw}), **COMMON,
        **extra)


def _train(case, mesh, row0):
    """``(params leaves, [(phase, loss, consensus, grad_norm)])`` of one
    Trainer case on ``mesh``, or the ``NotImplementedError`` message."""
    name, dist_kw, opt_kw, extra = case
    try:
        tr = Trainer(_config(dist_kw, opt_kw, extra), TN, mesh=mesh,
                     with_consensus=True, device="cpu")
        st = tr.init_state(params=interop.from_numpy(row0, "cpu"))
        st = tr.run(st, steps=STEPS, log_every=1)
    except NotImplementedError as e:
        return str(e)
    return ([p.clone() for p in tree_leaves(st.params)],
            [(h["phase"], h["loss"], h["consensus"], h["grad_norm"])
             for h in tr.history])


def _rank_worker(rank: int, row0):
    """One rank of the (data=2, model=2) mesh: every round case on its
    node shard's rows (with its column block before the gather for the
    uncompressed rounds), the exchange bytes of one gossip round on each
    axis, then every Trainer case."""
    import torch.distributed as dist
    mesh = make_mesh(*AXES, device="cpu", group=dist.group.WORLD)
    m = N // KN
    rows = slice(mesh.node_rank * m, (mesh.node_rank + 1) * m)
    blocks = []
    real = tmix._gather_chunks

    def spy(mesh_, kc, outs):
        blocks.append([t.clone() for t in next(iter(outs.values()))])
        return real(mesh_, kc, outs)

    out = {"coords": (mesh.node_rank, mesh.model_rank)}
    tmix._gather_chunks = spy
    try:
        for kind, case in CASES:
            blocks.clear()
            out[(kind, case)] = RUN[kind](case, mesh, rows)
            if kind == "round":
                out[("block", case)] = blocks[0][0]
    finally:
        tmix._gather_chunks = real
    for ex in (mesh.exchange, mesh.model_exchange):
        ex.reset_stats()
    tmix.communicate(_rows(_tree(0), rows), _spec(mesh, "ring"),
                     phase="gossip")
    out["bytes"] = (dict(mesh.exchange.stats),
                    dict(mesh.model_exchange.stats))
    tm = TN // KN
    for case in TCASES:
        out[("train", case[0])] = _train(case, mesh, row0)
    out["rows"] = (mesh.node_rank * tm, (mesh.node_rank + 1) * tm)
    return out


def _jax_reference(kind, case):
    """The live JAX stacked reference of a round case on all n nodes."""
    import jax
    import jax.numpy as jnp

    from repro import compress as JC
    from repro.core import mixing as jmix

    def spec(topology, n_pods=1, cd=None, name="none", global_name="none"):
        return jmix.CommSpec(
            topology=topology, n_nodes=N, n_pods=n_pods,
            backend="reference",
            comm_dtype=None if cd is None else jnp.bfloat16,
            compressor=JC.make_compressor(name, k=3),
            global_compressor=JC.make_compressor(global_name)).validate()

    def tree(t):
        return jax.tree.map(jnp.asarray, t)

    def flat(t):
        return [np.asarray(a) for a in jax.tree.leaves(t)]

    if kind == "round":
        phase, topology, pods, cd = case
        return flat(jmix.communicate(tree(_tree(0)),
                                     spec(topology, pods, cd), phase=phase,
                                     step=3))
    if kind == "compressed":
        want = []
        for phase, topology, step in CPHASES:
            mixed, new_ef = jmix.communicate(
                tree(_tree(6)), spec(topology, 2, name=case), phase=phase,
                step=step, ef_state=tree(_ef(1)), seed=5 + step)
            want += flat(mixed) + flat(new_ef)
        return want
    want = []
    for phase in ("global", "pod_avg"):
        mixed, new_ef = jmix.communicate(
            tree(_tree(7)), spec("ring", 2, global_name=case), phase=phase,
            ef_state=tree(_ef(2)), seed=9)
        want += flat(mixed) + flat(new_ef)
    return want


@pytest.fixture(scope="module")
def runs():
    """``{"ranks", "local", "jax", "train_local", "train_jax"}``: the 4
    ranks' results (spawned once), and, computed here while they run, the
    one-process 2-D mesh's round and Trainer cases and the JAX
    references."""
    import threading

    import jax

    from repro.configs import base as jcfg
    from repro.configs import pga_lm_100m as jarch
    from repro.train.trainer import Trainer as JTrainer

    jdist = {k: v for k, v in DIST.items() if k != "comm_shard_mode"}
    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(**jdist), optimizer=jcfg.OptimizerConfig(**OPT),
        **COMMON)
    jtr = JTrainer(jt, n_nodes=TN, with_consensus=True)
    jst = jtr.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree.map(lambda p: np.asarray(p[0]),
                        jax.device_get(jst.params))
    box = {}

    def spawn():
        try:
            box["ranks"] = run_ranks(_rank_worker, RANKS, args=(row0,),
                                     timeout_s=170)
        except BaseException as e:             # re-raised below
            box["error"] = e

    th = threading.Thread(target=spawn)
    th.start()
    try:
        mesh = make_mesh(*AXES, device="cpu")
        out = {"local": {(kind, case): RUN[kind](case, mesh, slice(None))
                         for kind, case in CASES},
               "jax": {(kind, case): _jax_reference(kind, case)
                       for kind, case in CASES
                       if kind in ("round", "compressed", "collective")}}
        out["train_local"] = {case[0]: _train(case, mesh, row0)
                              for case in TCASES if case[0] not in REFUSED}
        jst = jtr.run(jst, steps=STEPS, log_every=1)
        out["train_jax"] = (jax.tree.leaves(jax.device_get(jst.params)),
                            jtr.history)
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    out["ranks"] = box["ranks"]
    return out


def _rows_of(runs, r):
    """Rank r's node rows of the round cases."""
    nr = runs["ranks"][r]["coords"][0]
    return slice(nr * (N // KN), (nr + 1) * (N // KN))


def _whole_rows_bitwise(runs, kind, case):
    want = runs["local"][(kind, case)]
    for r in range(RANKS):
        rows = _rows_of(runs, r)
        got = runs["ranks"][r][(kind, case)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            # node-stacked outputs: this rank's rows; x̄ and the residual
            # whole on every rank
            ww = w[rows] if w.dim() and w.shape[0] == N else w
            assert g.dtype == ww.dtype and g.shape == ww.shape
            assert torch.equal(g, ww), (kind, case, r)


def _stacked(runs, kind, case):
    """Node-stacked outputs of node shards 0 and 1 (model rank 0's)."""
    by_node = {runs["ranks"][r]["coords"][0]: runs["ranks"][r][(kind, case)]
               for r in range(RANKS) if runs["ranks"][r]["coords"][1] == 0}
    return [torch.cat([by_node[s][i] for s in range(KN)])
            for i in range(len(by_node[0]))]


def _close(want, got, atol):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), atol=atol)


def test_rank_coordinates_are_row_major(runs):
    """Rank g is block (node shard g // 2, model shard g % 2) of the
    (data=2, model=2) mesh."""
    assert [runs["ranks"][g]["coords"] for g in range(RANKS)] == \
        [(g // KM, g % KM) for g in range(RANKS)]


@pytest.mark.parametrize("case", ROUNDS, ids=_id)
def test_rank_round_blocks_and_rows_are_the_one_process_round(runs, case):
    """Each rank's column block before the gather is chunk c of the
    one-process round's rows of its node shard, and its whole rows after
    the gather are those rows, bit for bit."""
    _whole_rows_bitwise(runs, "round", case)
    want = runs["local"][("round", case)]
    spec_tree = {f"leaf{i}": w for i, w in enumerate(want)}
    lay = tmc.ModelChunks(spec_tree, KM)
    for r in range(RANKS):
        c = runs["ranks"][r]["coords"][1]
        block = runs["ranks"][r][("block", case)]
        rows = lay.chunk(spec_tree, c)[_rows_of(runs, r)]
        # a global round's block is its chunk of x̄, broadcast after
        assert torch.equal(block, rows[:block.shape[0]])


@pytest.mark.parametrize("case", ROUNDS, ids=_id)
def test_rank_round_matches_jax_stacked_reference(runs, case):
    _close(runs["jax"][("round", case)], _stacked(runs, "round", case),
           atol=1e-5 if case[3] is None else 3e-2)


@pytest.mark.parametrize("kind,case",
                         [("residual", c) for c in RESIDUAL]
                         + [("half_step", ("ring",)), ("push",
                                                       ("directed_exp",))]
                         + [("overlap", c) for c in OVERLAP],
                         ids=lambda v: v if isinstance(v, str) else _id(v))
def test_rank_fused_push_and_overlap_rounds_bitwise(runs, kind, case):
    """The fused residual (x̄ and the residual whole on every rank: the
    folds over the node ranks per chunk, then over the model ranks), the
    fused half-step, push-sum (x and w) and the overlapped apply (dense,
    int8 with its EF, top-k whole on every model rank)."""
    _whole_rows_bitwise(runs, kind, case)


@pytest.mark.parametrize("name", COMPRESSED)
def test_rank_compressed_rounds(runs, name):
    """Compressed gossip, pod and global rounds with EF: bitwise the
    one-process 2-D rounds (int8/fp8 codes column-sliced, the sparsifiers
    whole on every model rank) and within 2e-5 of the JAX stacked ones."""
    _whole_rows_bitwise(runs, "compressed", name)
    _close(runs["jax"][("compressed", name)],
           _stacked(runs, "compressed", name), atol=2e-5)


@pytest.mark.parametrize("name", COLLECTIVE)
def test_rank_collective(runs, name):
    """The compressed collective on global and pod rounds with EF: the
    stage-1 ``all_to_all`` and stage-2 ``all_gather`` among the node ranks
    of one model slice, the slices gathered into whole rows: bitwise the
    one-process 2-D collective, within 2e-5 of the JAX stacked one."""
    _whole_rows_bitwise(runs, "collective", name)
    _close(runs["jax"][("collective", name)],
           _stacked(runs, "collective", name), atol=2e-5)


def test_rank_exchange_bytes_split_over_the_two_axes(runs):
    """One uncompressed ring gossip round: the node-axis halo sends this
    rank's chunk of its 4 rows to each of the 2 ring neighbours' shards
    (the shard itself and its neighbour, here one other shard) — half the
    1-D round's columns — and the model-axis gather receives the other
    chunk of the same size."""
    lay = tmc.ModelChunks(_rows({k: v for k, v in _tree(0).items()},
                                slice(0, N // KN)), KM)
    chunk_bytes = (N // KN) * lay.W * 4
    for r in range(RANKS):
        node, model = runs["ranks"][r]["bytes"]
        assert model["bytes_out"] == chunk_bytes
        assert model["bytes_in"] == KM * chunk_bytes
        assert node["bytes_out"] % chunk_bytes == 0
        assert node["bytes_out"] > 0


# ---------------------------------------------------------------------------
# The Trainer on the rank mesh
# ---------------------------------------------------------------------------
def _rank_params(runs, name):
    """The params of node shards 0 and 1 concatenated per leaf (model rank
    0's; the model ranks of a node shard hold the same rows)."""
    by_node = {runs["ranks"][r]["coords"][0]:
               runs["ranks"][r][("train", name)][0]
               for r in range(RANKS) if runs["ranks"][r]["coords"][1] == 0}
    return [torch.cat([by_node[s][i] for s in range(KN)])
            for i in range(len(by_node[0]))]


@pytest.mark.parametrize("name", [c[0] for c in TCASES
                                  if c[0] not in REFUSED])
def test_rank_trainer_is_the_one_process_two_d_trainer(runs, name):
    """Params within atol 1e-7, rtol 1e-6 of the one-process 2-D
    Trainer's rows, the model ranks of one node shard bitwise each other,
    and every rank logs the same phases and losses (rtol 1e-6)."""
    want_params, want_hist = runs["train_local"][name]
    got = _rank_params(runs, name)
    for g, w in zip(got, want_params):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)
    by_node = {}
    for r in range(RANKS):
        nr = runs["ranks"][r]["coords"][0]
        params, hist = runs["ranks"][r][("train", name)]
        if nr in by_node:
            for a, b in zip(params, by_node[nr]):
                assert torch.equal(a, b)
        by_node[nr] = params
        assert [h[0] for h in hist] == [h[0] for h in want_hist]
        np.testing.assert_allclose([h[1] for h in hist],
                                   [h[1] for h in want_hist], rtol=1e-6)


def test_rank_joint_gradient_norm_is_not_counted_per_model_rank(runs):
    """With the clip engaged (0.05, below every step's norm): every rank's
    ``grad_norm`` within rtol 1e-6 of the one-process 2-D Trainer's — the
    fold over the 2 node ranks of its chunk, not over all 4 ranks (√2
    larger) — and the clipped run's params differ from the unclipped
    one's."""
    want = [h[3] for h in runs["train_local"]["clip"][1]]
    assert min(want) > 0.05
    for r in range(RANKS):
        got = [h[3] for h in runs["ranks"][r][("train", "clip")][1]]
        np.testing.assert_allclose(got, want, rtol=1e-6)
    clipped, plain = _rank_params(runs, "clip"), _rank_params(runs, "pga")
    assert any(not torch.equal(a, b) for a, b in zip(clipped, plain))


def test_rank_trainer_matches_jax_trainer(runs):
    want_params, want_hist = runs["train_jax"]
    for r in range(RANKS):
        hist = runs["ranks"][r][("train", "pga")][1]
        assert [h[0] for h in hist] == ["gossip", "global", "gossip",
                                        "global"]
        for (phase, loss, cons, _), jr in zip(hist, want_hist):
            np.testing.assert_allclose(loss, jr["loss"], rtol=1e-5)
            if phase == "global":
                assert cons == 0.0
            else:
                np.testing.assert_allclose(cons, jr["consensus"],
                                           rtol=1e-4)
    for got, want in zip(_rank_params(runs, "pga"), want_params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)


def test_rank_checkpoints_are_refused(runs):
    for r in range(RANKS):
        msg = runs["ranks"][r][("train", "ckpt")]
        assert isinstance(msg, str) and "ROADMAP A.10.1" in msg, msg
