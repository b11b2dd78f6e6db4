"""Port parity: the sharded rounds on a rank mesh (one ``torch.distributed``
rank per node shard, ``make_mesh(..., group=...)``) on the CPU.

Four gloo ranks are spawned once for the module (:func:`runs`); each runs
every case on its own rows and its results are saved, then the
parametrised tests compare them.  Each case builds its inputs with numpy
from a seed, for all n = 4m nodes, and hands a rank its m rows.

Held to, with the tolerances and their reasons:
* the port's one-process sharded round on the same inputs (every shard in
  one process, ``make_mesh`` without a group): **bitwise** — the ranks run
  the same shard bodies on the same rows and halos, the exchange moves
  bytes, and every sum over shards is the same left fold of the gathered
  partials;
* the live JAX stacked reference, at ``tests/test_torch_sharded.py``'s
  tolerances: atol 1e-5 for fp32 rounds and 3e-2 with the bf16 wire (the
  sharded global/pod round averages fp32 sums of the wire-cast rows, the
  stacked reference rounds the mean back to bf16); the consensus residual
  rtol 1e-4, atol 1e-6; compressed gossip and the compressed collective
  atol 2e-5 on the mixed state and the EF state (the codes agree exactly,
  the mix sums in another order);
* the ppermute runtime (``gossip_ppermute`` through
  ``make_shard_map_mixer``, ``global_average_ppermute``) against JAX's
  ``mix_array`` and ``global_average_pytree`` on the stacked nodes: atol
  1e-6 (the same fp32 products and sums; the JAX mean reduces in XLA's
  order).

JAX is imported inside the tests, never at module top: a spawned rank
imports this module to find its worker and must load no JAX
(``tests/test_torch_isolation.py`` holds this).
"""
import numpy as np
import pytest
import torch

from repro_torch import compress as TC
from repro_torch.core import mixing as tmix
from repro_torch.core.mesh import make_mesh, run_ranks

torch.set_num_threads(2)

K = 4                                   # ranks = node shards
SHAPES = [(5, 3), (7,), ()]
# the 8 phase x topology cases of the reference's sharded suite
PHASES = ([("gossip", t, 1) for t in ("ring", "exp", "one_peer_exp", "grid",
                                      "disconnected")]
          + [("global", "ring", 1), ("pod_avg", "ring", 2),
             ("pod_avg", "ring", 4)])
ROUNDS = [(p, t, pods, cd, m) for (p, t, pods) in PHASES
          for cd in (None, "bfloat16") for m in (1, 2)]
RESIDUAL = (("gossip", "ring"), ("gossip", "one_peer_exp"),
            ("pod_avg", "ring"), ("global", "ring"))
COMPRESSED = [(name, ef, m) for name in ("int8", "fp8", "topk", "randk")
              for ef in (False, True) for m in ((1, 2) if name == "randk"
                                                else (2,))]
COLLECTIVE = [(name, ef) for name in ("int8", "fp8") for ef in (False, True)]
CPHASES = (("gossip", "one_peer_exp", 0), ("gossip", "one_peer_exp", 1),
           ("gossip", "ring", 0), ("global", "ring", 0),
           ("pod_avg", "ring", 0))
PPERMUTE = (("ring", 0), ("exp", 0), ("one_peer_exp", 0),
            ("one_peer_exp", 1), ("one_peer_exp", 2))


def _id(case) -> str:
    return "-".join(str(c) for c in case)


def _tree(seed, n, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {f"leaf{i}": rng.standard_normal((n,) + s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _ctree(seed, n):
    rng = np.random.default_rng(seed)
    # ragged widths; "c" spans three 1024-column collective blocks
    return {"b": rng.standard_normal((n, 3, 5)).astype(np.float32),
            "a": {"w": rng.standard_normal((n, 37)).astype(np.float32)},
            "c": rng.standard_normal((n, 2100)).astype(np.float32)}


def _cef(seed, n):
    rng = np.random.default_rng(seed)
    return {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
            if not isinstance(v, dict) else
            {kk: (0.01 * rng.standard_normal(vv.shape)).astype(np.float32)
             for kk, vv in v.items()}
            for k, v in _ctree(seed + 100, n).items()}


def _rows(tree, rows):
    """``tree``'s node rows ``rows`` (a slice) as torch tensors."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rows(v, rows) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree[rows]))


def _flat(out):
    """The tensors of a round's output, in a fixed order."""
    from repro_torch.tree import tree_leaves
    return [t for t in tree_leaves(out) if torch.is_tensor(t)]


def _spec(mesh, n, topology, n_pods=1, cd=None, name="none",
          global_name="none"):
    return tmix.CommSpec(
        topology=topology, n_nodes=n, n_pods=n_pods, backend="pallas",
        mesh=mesh, comm_dtype=None if cd is None else torch.bfloat16,
        compressor=TC.make_compressor(name, k=3),
        global_compressor=TC.make_compressor(global_name)).validate()


# ---------------------------------------------------------------------------
# The cases: each runs on a mesh and a row slice of the all-node inputs
# ---------------------------------------------------------------------------
def _round_case(case, mesh, rows):
    phase, topology, pods, cd, m = case
    n = K * m
    spec = _spec(mesh, n, topology, pods, cd)
    return _flat(tmix.communicate(_rows(_tree(0, n), rows), spec,
                                  phase=phase, step=3))


def _residual_case(case, mesh, rows):
    phase, topology = case
    n = 2 * K
    return _flat(tmix.communicate_sharded(
        _rows(_tree(3, n), rows), _spec(mesh, n, topology, 2), phase=phase,
        step=1, with_residual=True))


def _half_step_case(case, mesh, rows):
    n = 2 * K
    return _flat(tmix.communicate_sharded(
        _rows(_tree(4, n), rows), _spec(mesh, n, "ring"), phase="gossip",
        grads=_rows(_tree(5, n), rows), gamma=0.37))


def _compressed_case(case, mesh, rows):
    name, ef, m = case
    n = K * m
    out = []
    for phase, topology, step in CPHASES:
        spec = _spec(mesh, n, topology, 2, name=name)
        out += _flat(tmix.communicate(
            _rows(_ctree(4, n), rows), spec, phase=phase, step=step,
            ef_state=_rows(_cef(1, n), rows) if ef else None,
            seed=5 + step))
    return out


def _collective_case(case, mesh, rows):
    name, ef = case
    n = 2 * K
    out = []
    for phase in ("global", "pod_avg"):
        spec = _spec(mesh, n, "one_peer_exp", 2, global_name=name)
        out += _flat(tmix.communicate(
            _rows(_ctree(5, n), rows), spec, phase=phase, step=0,
            ef_state=_rows(_cef(2, n), rows) if ef else None, seed=9))
    return out


def _meter_records(mesh, rows):
    """The ``comm_round`` records of an uncompressed and a compressed
    gossip round and a collective round, metered under an ambient hub."""
    from repro_torch import obs
    n = 2 * K
    tel = obs.Telemetry(sinks=[obs.RingSink()])
    with obs.telemetry_scope(tel):
        tmix.communicate(_rows(_tree(0, n), rows),
                         _spec(mesh, n, "one_peer_exp"), phase="gossip")
        tmix.communicate(_rows(_ctree(4, n), rows),
                         _spec(mesh, n, "ring", name="int8",
                               global_name="int8"), phase="gossip",
                         ef_state=_rows(_cef(1, n), rows), seed=3)
        tmix.communicate(_rows(_ctree(4, n), rows),
                         _spec(mesh, n, "ring", name="int8",
                               global_name="int8"), phase="global",
                         ef_state=_rows(_cef(1, n), rows), seed=3)
        spec = _spec(mesh, n, "one_peer_exp", name="int8")
        tmix.start_round(_rows(_ctree(4, n), rows), spec, seed=3)
    return tel.ring().records("comm_round")


def _ppermute_case(case, mesh, rows):
    topology, step = case
    x = _rows(_tree(6, K, [(3, 4)]), rows)["leaf0"]
    mixer = tmix.make_shard_map_mixer(mesh, "data", topology, step)
    return [mixer(x), tmix.global_average_ppermute(x, "data", mesh=mesh)]


CASES = ([("round", c) for c in ROUNDS]
         + [("residual", c) for c in RESIDUAL]
         + [("half_step", ("ring",))]
         + [("compressed", c) for c in COMPRESSED]
         + [("collective", c) for c in COLLECTIVE]
         + [("ppermute", c) for c in PPERMUTE])
RUN = {"round": _round_case, "residual": _residual_case,
       "half_step": _half_step_case, "compressed": _compressed_case,
       "collective": _collective_case, "ppermute": _ppermute_case}


def _m(kind, case) -> int:
    if kind == "round":
        return case[-1]
    if kind == "compressed":
        return case[2]
    return 1 if kind == "ppermute" else 2


def _rank_worker(rank: int):
    """One rank: every case on its rows of a 4-rank gloo mesh."""
    import torch.distributed as dist
    mesh = make_mesh((K,), ("data",), device="cpu", group=dist.group.WORLD)
    from repro_torch.core.mesh import Exchange
    out = {("refusals",): []}
    for what, fn in (
            ("Exchange", lambda: Exchange(dist.group.WORLD,
                                          torch.device("meta"))),
            ("reference", lambda: tmix.use_sharded_backend(
                "reference", mesh)),
            ("stacked", lambda: tmix.use_sharded_backend(
                "pallas", mesh, shard_mode="stacked"))):
        try:
            fn()
        except ValueError:
            out[("refusals",)].append(what)
    for kind, case in CASES:
        m = _m(kind, case)
        out[(kind, case)] = RUN[kind](case, mesh,
                                      slice(rank * m, (rank + 1) * m))
    out[("meter",)] = _meter_records(mesh, slice(rank * 2, rank * 2 + 2))
    return out


def _jax_spec(n, topology, n_pods=1, cd=None, name="none",
              global_name="none"):
    import jax.numpy as jnp

    from repro import compress as JC
    from repro.core import mixing as jmix
    return jmix.CommSpec(
        topology=topology, n_nodes=n, n_pods=n_pods, backend="reference",
        comm_dtype=None if cd is None else jnp.bfloat16,
        compressor=JC.make_compressor(name, k=3),
        global_compressor=JC.make_compressor(global_name)).validate()


def _jax_tree(tree):
    import jax
    import jax.numpy as jnp
    return None if tree is None else jax.tree.map(jnp.asarray, tree)


def _jax_flat(out):
    import jax
    return [np.asarray(t) for t in jax.tree.leaves(out)]


def _jax_reference(kind, case):
    """The live JAX stacked reference of a case on all n nodes (numpy):
    the outputs in the port's order; the residual case's as ``(mixed,
    x̄, Σ‖x_i − x̄‖²)``."""
    import jax
    import jax.numpy as jnp

    from repro.core import mixing as jmix
    from repro.core import topology as jtopo
    if kind == "round":
        phase, topology, pods, cd, m = case
        n = K * m
        return _jax_flat(jmix.communicate(
            _jax_tree(_tree(0, n)), _jax_spec(n, topology, pods, cd),
            phase=phase, step=3))
    if kind == "residual":
        phase, topology = case
        n = 2 * K
        leaves = jax.tree.leaves(jmix.communicate(
            _jax_tree(_tree(3, n)), _jax_spec(n, topology, 2), phase=phase,
            step=1))
        return ([np.asarray(p) for p in leaves],
                [np.asarray(jnp.mean(p, 0)) for p in leaves],
                sum(float(jnp.sum((p - jnp.mean(p, 0, keepdims=True)) ** 2))
                    for p in leaves))
    if kind == "half_step":
        n = 2 * K
        x, g = _jax_tree(_tree(4, n)), _jax_tree(_tree(5, n))
        return _jax_flat(jmix.communicate(
            jax.tree.map(lambda p, q: p - 0.37 * q, x, g),
            _jax_spec(n, "ring"), phase="gossip", step=0))
    if kind == "compressed":
        name, ef, m = case
        n = K * m
        want = []
        for phase, topology, step in CPHASES:
            mixed, new_ef = jmix.communicate(
                _jax_tree(_ctree(4, n)), _jax_spec(n, topology, 2,
                                                   name=name),
                phase=phase, step=step,
                ef_state=_jax_tree(_cef(1, n)) if ef else None,
                seed=5 + step)
            want += _jax_flat(mixed) + (_jax_flat(new_ef) if ef else [])
        return want
    if kind == "collective":
        name, ef = case
        n = 2 * K
        want = []
        for phase in ("global", "pod_avg"):
            mixed, new_ef = jmix.communicate(
                _jax_tree(_ctree(5, n)),
                _jax_spec(n, "one_peer_exp", 2, global_name=name),
                phase=phase, step=0,
                ef_state=_jax_tree(_cef(2, n)) if ef else None, seed=9)
            want += _jax_flat(mixed) + (_jax_flat(new_ef) if ef else [])
        return want
    topology, step = case
    x = jnp.asarray(_tree(6, K, [(3, 4)])["leaf0"])
    return [np.asarray(jmix.mix_array(
                x, jtopo.shift_weights(topology, K, step))),
            np.asarray(jmix.global_average_pytree(x))]


@pytest.fixture(scope="module")
def runs():
    """``{"ranks", "local", "jax"}``: every rank's results (4 gloo ranks
    spawned once for the module), the one-process sharded rounds (every
    shard here) on all rows, and the JAX stacked references, the last two
    computed here while the ranks run."""
    import threading
    box = {}

    def spawn():
        try:
            box["ranks"] = run_ranks(_rank_worker, K, timeout_s=120)
        except BaseException as e:             # re-raised below
            box["error"] = e

    th = threading.Thread(target=spawn)
    th.start()
    try:
        mesh = make_mesh((K,), ("data",), device="cpu")
        out = {"local": {(kind, case): RUN[kind](case, mesh, slice(None))
                         for kind, case in CASES},
               "jax": {(kind, case): _jax_reference(kind, case)
                       for kind, case in CASES}}
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    out["ranks"] = box["ranks"]
    return out


def _bitwise(runs, kind, case):
    m = _m(kind, case)
    want = runs["local"][(kind, case)]
    for r in range(K):
        got = runs["ranks"][r][(kind, case)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            # node-stacked outputs: this rank's rows; x̄ and the residual
            # are whole on every rank
            ww = w[r * m:(r + 1) * m] if w.dim() and w.shape[0] == K * m \
                and g.shape[0] == m else w
            assert g.dtype == ww.dtype and g.shape == ww.shape
            assert torch.equal(g, ww), (kind, case, r)


def _stacked_outputs(runs, kind, case, count=None):
    """The first ``count`` outputs (all by default) of a case whose
    outputs are node-stacked, concatenated in rank order."""
    ranks = runs["ranks"]
    outs = ranks[0][(kind, case)]
    return [torch.cat([ranks[r][(kind, case)][i] for r in range(K)])
            for i in range(len(outs) if count is None else count)]


def _close(want, got, atol, rtol=0.0):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol)


# ---------------------------------------------------------------------------
# Uncompressed rounds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ROUNDS, ids=_id)
def test_rank_round_is_the_one_process_round_bitwise(runs, case):
    """communicate on 4 ranks: each rank's rows are the one-process
    sharded round's, bit for bit (8 phase x topology cases, fp32 and the
    bf16 wire, m = 1 and 2 nodes a rank)."""
    _bitwise(runs, "round", case)


@pytest.mark.parametrize("case", ROUNDS, ids=_id)
def test_rank_round_matches_jax_stacked_reference(runs, case):
    _close(runs["jax"][("round", case)],
           _stacked_outputs(runs, "round", case),
           atol=1e-5 if case[3] is None else 3e-2)


@pytest.mark.parametrize("case", RESIDUAL, ids=_id)
def test_rank_residual_is_the_one_process_residual_bitwise(runs, case):
    """with_residual: the mixed rows, x̄ (the fold of the gathered column
    sums) and Σ‖x_i − x̄‖² (the fold of the per-shard parts) on every
    rank."""
    _bitwise(runs, "residual", case)


@pytest.mark.parametrize("case", RESIDUAL, ids=_id)
def test_rank_residual_matches_jax_stacked_reference(runs, case):
    want_mixed, want_xbar, want_r = runs["jax"][("residual", case)]
    nl = len(want_mixed)
    # the mixed leaves are node-stacked; x̄ and the residual whole
    got = runs["ranks"][0][("residual", case)]
    _close(want_mixed, _stacked_outputs(runs, "residual", case, nl),
           atol=1e-5)
    _close(want_xbar, got[nl:2 * nl], atol=1e-5)
    if case[0] == "global":
        assert float(got[2 * nl]) == 0.0
    else:
        np.testing.assert_allclose(float(got[2 * nl]), want_r, rtol=1e-4,
                                   atol=1e-6)


def test_rank_half_step_is_the_one_process_round_bitwise(runs):
    _bitwise(runs, "half_step", ("ring",))


def test_rank_half_step_matches_jax_stacked_reference(runs):
    _close(runs["jax"][("half_step", ("ring",))],
           _stacked_outputs(runs, "half_step", ("ring",)), atol=1e-5)


# ---------------------------------------------------------------------------
# Compressed gossip and the compressed collective
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", COMPRESSED, ids=_id)
def test_rank_compressed_gossip_is_the_one_process_round_bitwise(runs,
                                                                 case):
    """The wire arrays (codes and scales; randk's shared indices ride
    whole) cross the halo; B.4's plain twin applies them on each rank."""
    _bitwise(runs, "compressed", case)


@pytest.mark.parametrize("case", COMPRESSED, ids=_id)
def test_rank_compressed_gossip_matches_jax_stacked_reference(runs, case):
    _close(runs["jax"][("compressed", case)],
           _stacked_outputs(runs, "compressed", case), atol=2e-5)


@pytest.mark.parametrize("case", COLLECTIVE, ids=_id)
def test_rank_collective_is_the_one_process_collective_bitwise(runs, case):
    """The stage-1 codes and exponent bytes by all_to_all, the owners'
    stage-2 codes by all_gather; global and pod_avg."""
    _bitwise(runs, "collective", case)


@pytest.mark.parametrize("case", COLLECTIVE, ids=_id)
def test_rank_collective_matches_jax_stacked_reference(runs, case):
    _close(runs["jax"][("collective", case)],
           _stacked_outputs(runs, "collective", case), atol=2e-5)


# ---------------------------------------------------------------------------
# The explicit ppermute runtime
# ---------------------------------------------------------------------------
def test_perm_for_shift_is_the_references():
    from repro.core import mixing as jmix
    for n in (1, 4, 8):
        for s in range(-2, n + 2):
            assert tmix._perm_for_shift(n, s) == jmix._perm_for_shift(n, s)


@pytest.mark.parametrize("where", ("ranks", "local"))
@pytest.mark.parametrize("case", PPERMUTE, ids=_id)
def test_shard_map_mixer_matches_jax_mix_array(runs, case, where):
    """make_shard_map_mixer (gossip_ppermute) with one node a shard, on 4
    ranks and on the one-process mesh, against JAX's mix_array on the
    stacked nodes; global_average_ppermute against global_average_pytree.
    The two mesh kinds agree bitwise."""
    local = runs["local"][("ppermute", case)]
    if where == "ranks":
        got = _stacked_outputs(runs, "ppermute", case)
        for g, w in zip(got, local):
            assert torch.equal(g, w)
    else:
        got = local
    _close(runs["jax"][("ppermute", case)], got, atol=1e-6)


def test_ppermute_runtime_checks_its_node_count():
    mesh = make_mesh((K,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="shards"):
        tmix.gossip_ppermute(torch.zeros(8, 2), "data", 8, {0: 1.0},
                             mesh=mesh)


# ---------------------------------------------------------------------------
# The launcher: a rank that raises or hangs
# ---------------------------------------------------------------------------
def _raise_on_two(rank: int):
    import torch.distributed as dist
    if rank == 2:
        raise RuntimeError("rank two gives up")
    dist.barrier()
    return rank


def _hang_on_one(rank: int):
    import time

    import torch.distributed as dist
    if rank == 1:
        time.sleep(3600)
    dist.barrier()
    return rank


def test_run_ranks_raises_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank two gives up"):
        run_ranks(_raise_on_two, K, timeout_s=60)


def test_run_ranks_kills_a_hung_rank_within_its_limit():
    import time
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        run_ranks(_hang_on_one, K, timeout_s=3)
    assert time.monotonic() - t0 < 20


def test_rank_rounds_meter_the_whole_round(runs):
    """A rank meters the whole round, as one process does: every
    ``comm_round`` record's fields (analytic and measured bytes of all n
    nodes, the sharded flag) equal the one-process mesh's."""
    want = _meter_records(make_mesh((K,), ("data",), device="cpu"),
                          slice(None))
    assert len(want) == 4

    def fields(recs):
        return [{k: v for k, v in rec.items() if k != "ts"} for rec in recs]
    for r in range(K):
        assert fields(runs["ranks"][r][("meter",)]) == fields(want)


def test_rank_mesh_refuses_what_it_cannot_run(runs):
    """On a rank mesh: the exchange names its transport (gloo with CPU
    tensors here; gloo staged or nccl with CUDA tensors), so another
    device raises; the stacked rounds (the reference backend, shard_mode
    "stacked") raise, a rank holding only its own rows."""
    for r in range(K):
        assert runs["ranks"][r][("refusals",)] == ["Exchange", "reference",
                                           "stacked"]
