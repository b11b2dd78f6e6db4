"""Port parity: ``repro_torch`` mixing vs the JAX reference on the CPU.

The same numpy inputs (seeded) go through the JAX function and its port.
The fused entry points run the JAX Pallas kernel in interpret mode (the
default off-TPU) against the port's wrapper, which on CPU tensors takes
the kernel's plain PyTorch twin.

Tolerances: rtol/atol 1e-6 on mixed values and x̄ — both packages do the
same fp32 operations on the same inputs, but the node-axis matmul and the
means may sum in another order (a few ulps); 1e-5 relative on the
consensus residual, a sum over every column whose order differs between
XLA and PyTorch, plus an absolute floor of (1e-6·max|o|)² per element for
rounds that reach consensus, where the residual is rounding noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmix
from repro.kernels import mixing_pallas as jmp
from repro_torch.core import mixing as tmix
from repro_torch.kernels import mixing_cuda as tmc

torch.set_num_threads(2)

N = 8
RTOL = ATOL = 1e-6
RESID_RTOL = 1e-5

# (phase, topology): every topology for gossip; averaging ignores it
CASES = [("gossip", t) for t in ("ring", "exp", "one_peer_exp", "grid",
                                 "full")] + [("global", "ring"),
                                             ("pod_avg", "ring")]
DTYPES = [None, "bfloat16"]


def _tree(seed=0, n=N):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal((n,) + shape).astype(np.float32)

    # insertion order differs from sorted order on purpose
    return {"b": arr(3, 5), "a": {"w": arr(40), "z": arr(7)}, "c": arr(300)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _close(jtree, ttree, rtol=RTOL, atol=ATOL):
    jl, tl = jax.tree.leaves(jtree), jax.tree.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=rtol, atol=atol)


def _close_resid(jout, tout):
    leaves = [np.asarray(o) for o in jax.tree.leaves(jout[0])]
    size = sum(o.size for o in leaves)
    scale = max(float(np.abs(o).max()) for o in leaves)
    np.testing.assert_allclose(float(tout[2]), float(jout[2]),
                               rtol=RESID_RTOL,
                               atol=size * (RTOL * scale) ** 2)


def _dtypes(name):
    if name is None:
        return None, None
    return jnp.bfloat16, torch.bfloat16


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("phase,topology", CASES)
def test_fused_step_mix_matches_pallas(phase, topology, dtype):
    """fused_step_mix/mix_residual: every with_g × with_residual ×
    leaf-threshold combination (100 forces a per-leaf launch for "c")."""
    jd, td = _dtypes(dtype)
    x, g = _tree(0), _tree(1)
    for with_g in (False, True):
        for with_residual in (False, True):
            for thresh in (None, 100):
                kw = dict(phase=phase, topology=topology, n_nodes=N,
                          step=1, n_pods=2, with_residual=with_residual,
                          leaf_threshold=thresh)
                jargs = (_jax(g), jnp.float32(0.1)) if with_g else ()
                targs = (_torch(g), 0.1) if with_g else ()
                jout = jmp.fused_step_mix(_jax(x), *jargs, comm_dtype=jd,
                                          **kw)
                tout = tmc.fused_step_mix(_torch(x), *targs, comm_dtype=td,
                                          **kw)
                if not with_residual:
                    _close(jout, tout)
                    continue
                _close(jout[0], tout[0])
                _close(jout[1], tout[1])
                _close_resid(jout, tout)
    assert tmc.mix_flat.launches == 0   # CPU tensors: plain twin only


@pytest.mark.parametrize("dtype", DTYPES)
def test_entry_points_match_pallas(dtype):
    """global_average / pod_average / mix_residual wrappers."""
    jd, td = _dtypes(dtype)
    x = _tree(2)
    _close(jmp.global_average(_jax(x), N, comm_dtype=jd),
           tmc.global_average(_torch(x), N, comm_dtype=td))
    _close(jmp.pod_average(_jax(x), N, 4, comm_dtype=jd),
           tmc.pod_average(_torch(x), N, 4, comm_dtype=td))
    jm, jxb, jr = jmp.mix_residual(_jax(x), phase="gossip",
                                   topology="one_peer_exp", n_nodes=N,
                                   step=2, comm_dtype=jd)
    tm, txb, tr = tmc.mix_residual(_torch(x), phase="gossip",
                                   topology="one_peer_exp", n_nodes=N,
                                   step=2, comm_dtype=td)
    _close(jm, tm)
    _close(jxb, txb)
    _close_resid((jm, jxb, jr), (tm, txb, tr))


def _specs(topology, dtype, backend):
    jd, td = _dtypes(dtype)
    jspec = jmix.CommSpec(topology=topology, n_nodes=N, n_pods=2,
                          backend=backend, leaf_threshold=100,
                          comm_dtype=jd).validate()
    tspec = tmix.CommSpec(topology=topology, n_nodes=N, n_pods=2,
                          backend=backend, leaf_threshold=100,
                          comm_dtype=td).validate()
    return jspec, tspec


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("phase,topology",
                         CASES + [("none", "ring"),
                                  ("gossip", "disconnected")])
def test_communicate_matches_reference(phase, topology, dtype):
    """Port communicate (reference backend) vs the JAX reference backend,
    including the bf16 wire cast of neighbour terms / averaging
    operands."""
    jspec, tspec = _specs(topology, dtype, "reference")
    x = _tree(3)
    for step in (0, 1, 2):
        jout = jmix.communicate(_jax(x), jspec, phase=phase, step=step)
        tout = tmix.communicate(_torch(x), tspec, phase=phase, step=step)
        _close(jout, tout)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("phase,topology", [("gossip", "ring"),
                                            ("gossip", "grid"),
                                            ("global", "ring"),
                                            ("pod_avg", "ring")])
def test_communicate_fused_backend_matches_pallas(phase, topology, dtype):
    """backend="pallas" in both packages: the JAX Pallas kernel vs the
    port's fused wrapper."""
    jspec, tspec = _specs(topology, dtype, "pallas")
    x = _tree(4)
    _close(jmix.communicate(_jax(x), jspec, phase=phase, step=0),
           tmix.communicate(_torch(x), tspec, phase=phase, step=0))


def test_flatten_nodes_and_phase_matrices_match():
    """Packing offsets follow the sorted-key order of jax.tree.flatten."""
    x = _tree(5)
    jflat, junflat = jmp.flatten_nodes(_jax(x))
    tflat, tunflat = tmc.flatten_nodes(_torch(x))
    np.testing.assert_array_equal(np.asarray(tflat), np.asarray(jflat))
    _close(junflat(jflat), tunflat(tflat), rtol=0, atol=0)
    row = tflat[:1]
    _close(junflat(jflat[:1], drop_node=True),
           tunflat(row, drop_node=True), rtol=0, atol=0)
    for phase, topology in CASES:
        for step in range(3):
            jd, jM = jmp.phase_matrices(phase, topology, N, step=step,
                                        n_pods=2)
            td, tM = tmc.phase_matrices(phase, topology, N, step=step,
                                        n_pods=2)
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tM, jM)
    leaves = jax.tree.leaves(_jax(x))
    assert tmc._dispatch_groups(jax.tree.leaves(_torch(x)), 100) == \
        jmp._dispatch_groups(leaves, 100)


def test_global_round_rows_bitwise_equal_and_residual_zero():
    """A global round's rows agree bitwise and its consensus residual is
    exactly 0 (pairwise mean of equal rows, n a power of two)."""
    x = _tree(6)
    mixed, xbar, resid = tmc.mix_residual(_torch(x), phase="global",
                                          topology="ring", n_nodes=N)
    for leaf in jax.tree.leaves(mixed):
        assert torch.equal(leaf, leaf[:1].expand_as(leaf))
    assert float(resid) == 0.0


def test_inplace_staging_buffer_leaves_inputs_untouched():
    """The wrapper never writes into a caller's tensor: only a private
    concatenation is consumed in place."""
    x = _torch(_tree(7))
    before = jax.tree.map(torch.clone, x)
    tmc.fused_step_mix(x, phase="gossip", topology="ring", n_nodes=N,
                       leaf_threshold=100)
    _close(before, x, rtol=0, atol=0)


def test_round_frees_its_outputs_without_the_cyclic_collector():
    """No reference cycle holds a round's tensors: on the card the stacked
    parameters are gigabytes, and waiting for the cyclic collector ran a
    full-width run out of memory."""
    import gc
    import weakref

    x = _torch(_tree(8))
    gc.disable()
    try:
        out = tmc.mix_residual(x, phase="gossip", topology="ring",
                               n_nodes=N, leaf_threshold=100)
        refs = [weakref.ref(t) for t in jax.tree.leaves(out[:2])]
        del out
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# The rule between mix.cu's two instances (pure: shapes, strides, pointers)
# ---------------------------------------------------------------------------
def _rows(n, D, offset=0):
    """An (n, D) float32 view whose first element lies ``offset`` elements
    past a 16-byte boundary."""
    buf = torch.zeros(n * D + 8)
    start = (-buf.data_ptr() % 16) // 4 + offset
    return buf[start:start + n * D].view(n, D)


# (n, D, offset of x, offset of g (None: no g), want): want is the
# register instance's width V (mix_vector_width), 0 for the generic
# instance.  n in MIX_VECTOR_NODES takes the register instance at any D
# and alignment: at vector_width(n) where D is a multiple of it and the
# rows are 16-byte aligned, at V = 1 otherwise.
VECTOR_RULE = [
    (4, 1000, 0, None, 4), (8, 1000, 0, None, 4),
    (16, 1002, 0, None, 2), (32, 1001, 0, None, 1),
    (8, 1000, 0, 0, 4),
    (2, 1000, 0, None, 4), (5, 1000, 0, None, 0),
    (64, 1000, 0, None, 0),
    (8, 1001, 0, None, 1), (4, 1002, 0, None, 1),
    (16, 1001, 0, None, 1),
    (8, 1000, 1, None, 1), (8, 1000, 2, None, 1),
    (8, 1000, 0, 1, 1),
    # n = 2 ragged and misaligned, n = 16 at an odd width, n = 32
    # misaligned, the simulator's n = 100
    (2, 1001, 0, None, 1), (2, 1000, 3, None, 1), (2, 1000, 0, 2, 1),
    (16, 7, 0, None, 1), (32, 1000, 1, None, 1), (100, 10, 0, None, 0),
]


@pytest.mark.parametrize("n,D,x_off,g_off,want", VECTOR_RULE)
def test_use_vector_mix_rule(n, D, x_off, g_off, want):
    x = _rows(n, D, x_off)
    g = None if g_off is None else _rows(n, D, g_off)
    assert tmc.mix_vector_width(x, g) == want
    assert tmc.use_vector_mix(x, g) is (want > 0)


@pytest.mark.parametrize("D", (19_200, 7_077_888, 25_165_824, 28_311_552))
def test_use_vector_mix_takes_the_main_path_widths(D):
    """Every launch width of pga-lm-100m's fused round at 8 nodes (the
    norms' staging buffer, the attention projections, the embedding, the
    MLP matrices) takes the register instance; meta tensors stand in for
    the gigabyte operands (their pointer is 0, so aligned)."""
    x = torch.empty((8, D), device="meta")
    assert tmc.use_vector_mix(x) and tmc.use_vector_mix(x, x)


# the two-node trainers: deepseek-v2-lite's dense prefix layer and one MoE
# layer, jamba's one (mamba, dense) layer, at full width
TWO_NODE_TRAINERS = {
    "moetrain": ("deepseek-v2-lite-16b", dict(n_layers=2)),
    "jtrain": ("jamba-1.5-large-398b",
               dict(n_layers=1, pattern=(("mamba", "dense"),))),
}


@pytest.mark.parametrize("path", sorted(TWO_NODE_TRAINERS))
def test_use_vector_mix_takes_the_two_node_widths(path):
    """Every dispatch group of the two n = 2 trainers (their params' meta
    init, stacked for 2 nodes, grouped at the default leaf threshold) takes
    the register instance at V = 4: each width is a multiple of 4, and a
    packed or fresh operand is aligned."""
    import dataclasses

    from repro_torch.configs import DistConfig, get_model_config
    from repro_torch.models.model import make_model
    from repro_torch.train.state import stack_for_nodes
    from repro_torch.tree import tree_leaves

    arch, kw = TWO_NODE_TRAINERS[path]
    cfg = dataclasses.replace(get_model_config(arch), **kw)
    params, _ = make_model(cfg).abstract_init()
    leaves = tree_leaves(stack_for_nodes(params, 2))
    groups = tmc._dispatch_groups(leaves, DistConfig().pallas_leaf_threshold)
    widths = [sum(leaves[i][0].numel() for i in g) for g in groups]
    assert len(widths) == {"moetrain": 22, "jtrain": 11}[path]
    for D in widths:
        x = torch.empty((2, D), device="meta")
        assert tmc.mix_vector_width(x) == 4, D


def test_push_staging_group_takes_the_register_instance_at_width_one():
    """The push-sum paths' staging group (the norms and the weight column,
    19,201 wide: not a multiple of 4) takes the register instance at
    V = 1."""
    x = torch.empty((8, 19_201), device="meta")
    assert tmc.mix_vector_width(x) == 1
    assert tmc.mix_vector_width(x, torch.empty_like(x)) == 1


@pytest.mark.parametrize("n", (5, 64, 100))
@pytest.mark.parametrize("D", (10, 1000, 1001))
def test_other_node_counts_stay_generic(n, D):
    assert tmc.mix_vector_width(_rows(n, D)) == 0


@pytest.mark.parametrize("n,D,offset", [(2, 1000, 0), (2, 1001, 0),
                                        (8, 1001, 0), (4, 1002, 0),
                                        (16, 1001, 0), (8, 1000, 1)])
def test_use_vector_cmix_keeps_its_rule(n, D, offset):
    """cmix.cu's rule does not follow mix.cu's: n = 2, a D that is not a
    multiple of the vector width and misaligned rows stay on cmix.cu's
    generic instance, where mix.cu's register instance takes them."""
    x = _rows(n, D, offset)
    assert tmc.use_vector_mix(x)
    assert tmc.CMIX_VECTOR_NODES == (4, 8, 16, 32)
    assert not tmc.use_vector_cmix(x)
    assert not tmc.use_vector_cmix(x, x)
    assert not tmc.use_vector_cmix(x, None, x)


def test_use_vector_mix_refuses_strided_rows():
    x = _rows(8, 2000)
    assert not tmc.use_vector_mix(x[:, ::2])
    assert not tmc.use_vector_mix(x.t().contiguous().t())


@pytest.mark.parametrize("launcher", ["mix_generic", "mix_vector",
                                      "mix_nodes"])
def test_mix_direct_launchers_refuse_cpu_operands(launcher):
    """The launchers of one instance (which chip_smoke times and compares
    directly) take CUDA operands only and count nothing on the CPU."""
    x = _rows(8, 1000)
    d, M = (torch.from_numpy(a) for a in tmc.phase_matrices("gossip", "ring",
                                                            8))
    before = (tmc.mix_flat.launches, tmc.mix_flat.vector_launches,
              tmc.mix_flat.nodes_launches)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tmc, launcher)(x, None, None, d, M, with_g=False,
                               with_residual=True, wire=False)
    assert (tmc.mix_flat.launches, tmc.mix_flat.vector_launches,
            tmc.mix_flat.nodes_launches) == before


# ---------------------------------------------------------------------------
# The node-parallel instances of mix.cu and cmix.cu (csrc/nodes.cuh): the
# rules that send a round to them and the planner of their tiles and grid
# ---------------------------------------------------------------------------
def _mix_instance(x, g=None):
    if tmc.mix_vector_width(x, g):
        return "vector"
    return "nodes" if tmc.use_nodes_mix(x, g) else "generic"


def _cmix_instance(x, e=None, q=None):
    if tmc.use_vector_cmix(x, e, q):
        return "vector"
    return "nodes" if tmc.use_nodes_cmix(x, e, q) else "generic"


# (n, D, x offset, strided x, want): n outside MIX_VECTOR_NODES with
# contiguous rows takes the node-parallel instance from n = 48 at any D
# and from n = 3 up to D = NODES_NARROW_D, at any alignment; strided rows,
# n = 1 and few nodes on a wider D stay generic; n in the set stays on the
# register instance
MIX_NODES_RULE = [
    (100, 10, 0, False, "nodes"), (100, 20, 0, False, "nodes"),
    (100, 11, 0, False, "nodes"), (100, 1000, 1, False, "nodes"),
    (1, 1, 0, False, "generic"), (3, 7, 0, False, "nodes"),
    (5, 1000, 0, False, "nodes"), (64, 1001, 2, False, "nodes"),
    (256, 10, 0, False, "nodes"), (892, 3, 0, False, "nodes"),
    (3, 8_192, 0, False, "nodes"), (3, 8_193, 0, False, "generic"),
    (47, 8_193, 0, False, "generic"), (48, 8_193, 1, False, "nodes"),
    (100, 20, 0, True, "generic"), (5, 1000, 0, True, "generic"),
    (2, 1001, 0, False, "vector"), (8, 1000, 0, False, "vector"),
    (16, 7, 0, False, "vector"), (32, 10, 1, False, "vector"),
]


@pytest.mark.parametrize("n,D,offset,strided,want", MIX_NODES_RULE)
def test_mix_instance_rule(n, D, offset, strided, want):
    x = _rows(n, 2 * D, offset)[:, ::2] if strided else _rows(n, D, offset)
    assert _mix_instance(x) == want
    assert _mix_instance(x, torch.zeros(n, D)) == want


def test_mix_nodes_rule_reads_every_row_operand():
    """A strided g keeps the round off the node-parallel instance."""
    x = _rows(100, 10)
    assert tmc.use_nodes_mix(x) and tmc.use_nodes_mix(x, _rows(100, 10))
    assert not tmc.use_nodes_mix(x, _rows(100, 20)[:, ::2])
    assert not tmc.use_nodes_mix(x.t().contiguous().t())


# (n, D, x offset, strided, want): where cmix.cu's register instance
# refuses the round (n outside CMIX_VECTOR_NODES, a ragged width or a
# misaligned row), contiguous rows take the node-parallel instance from
# n = 48 at any D and from n = 3 up to D = NODES_NARROW_D; n = 2, strided
# rows and few nodes on a wider D stay generic
CMIX_NODES_RULE = [
    (2, 10, 0, False, "generic"), (2, 1001, 1, False, "generic"),
    (100, 10, 0, False, "nodes"), (5, 11, 0, False, "nodes"),
    (892, 10, 0, False, "nodes"), (100, 10, 0, True, "generic"),
    (2, 1000, 0, True, "generic"), (4, 1000, 0, False, "vector"),
    (32, 10, 0, False, "vector"), (8, 1001, 0, False, "nodes"),
    (16, 1001, 0, False, "nodes"), (8, 1000, 1, False, "nodes"),
    (8, 8_193, 0, False, "generic"), (48, 8_193, 0, False, "nodes"),
]


@pytest.mark.parametrize("n,D,offset,strided,want", CMIX_NODES_RULE)
def test_cmix_instance_rule(n, D, offset, strided, want):
    x = _rows(n, 2 * D, offset)[:, ::2] if strided else _rows(n, D, offset)
    assert _cmix_instance(x) == want
    assert _cmix_instance(x, x) == want
    assert _cmix_instance(x, None, x) == want


@pytest.mark.parametrize("n,D,want", [
    (1, 1, False), (2, 10, False), (2, 25_165_824, False), (3, 10, True),
    (3, 8_192, True), (3, 8_193, False), (33, 1_000_003, False),
    (47, 1_000_003, False), (48, 1_000_003, True),
    (100, 25_165_824, True)])
def test_nodes_rule_thresholds(n, D, want):
    """The node-parallel rule's crossovers, as timed on the H100: from
    NODES_MIN_N nodes at any D; from 3 nodes up to NODES_NARROW_D."""
    assert (tmc.NODES_MIN_N, tmc.NODES_NARROW_D) == (48, 8_192)
    assert tmc._nodes_rows(n, D, []) is want


def test_cmix_nodes_rule_reads_every_row_operand():
    x = _rows(100, 10)
    strided = _rows(100, 20)[:, ::2]
    assert tmc.use_nodes_cmix(x, _rows(100, 10))
    assert not tmc.use_nodes_cmix(x, strided)
    assert not tmc.use_nodes_cmix(x, None, strided)


def _generic_nodes():
    """Every n the generic instances take (``_block_size`` does not
    raise): 1 .. 892 at 32 threads a block."""
    out = []
    for n in range(1, 1025):
        try:
            tmc._block_size(n)
        except ValueError:
            break
        out.append(n)
    return out


def _visits(tiles: int, grid: int) -> int:
    """Tiles a grid-stride loop of ``grid`` blocks visits in all."""
    b = np.arange(grid)
    return int(np.maximum(0, -(-(tiles - b) // grid)).sum())


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("D", [1, 10, 11, 20, 1_000_003])
def test_nodes_plan_covers_every_output(D, inplace):
    """For every n the generic instance takes: the tiles span every row
    and column, the grid-stride loops visit each (column tile, row tile)
    once, the block's shared memory fits the H100, a round written over
    its input keeps every row of a column in one block (grid y = 1), and
    the residual pass has the generic instance's partial count."""
    ns = _generic_nodes()
    assert ns[-1] == 892
    for n in ns:
        plan = tmc.nodes_plan(n, D, inplace=inplace)
        tile = tmc.NODES_ROWS
        assert plan["row_tiles"] * tile >= n > (plan["row_tiles"] - 1) * tile
        cols = plan["col_tiles"]
        assert cols * tmc.NODES_COLS >= D > (cols - 1) * tmc.NODES_COLS
        gx, gy = plan["grid"]
        assert 1 <= gx <= cols and 1 <= gy <= plan["row_tiles"] <= 65535
        assert gy == (1 if inplace else plan["row_tiles"])
        assert gx * gy <= tmc.NODES_MAX_GRID or gx == 1
        assert _visits(cols, gx) == cols
        assert _visits(plan["row_tiles"], gy) == plan["row_tiles"]
        assert plan["smem"] == tmc.nodes_smem(n)
        assert plan["smem"] <= tmc.cuda_build.MAX_SMEM
        assert plan["partials"] == -(-D // tmc._block_size(n))


@pytest.mark.parametrize("n,D,grid", [
    (100, 10, (1, 4)), (256, 10, (1, 8)), (100, 11, (1, 4)),
    (100, 20, (1, 4)), (33, 10, (1, 2)), (100, 8_417, (264, 4)),
    (100, 1_000_003, (512, 4)), (256, 1_000_003, (256, 8)),
    (892, 1_000_003, (73, 28))])
def test_nodes_plan_at_the_simulators_and_wide_shapes(n, D, grid):
    """The grids nodes.cuh's header states: 1 x 4 at (100, 10), 1 x 8 at
    (256, 10); on a wide D, at most NODES_MAX_GRID blocks over every row
    tile."""
    plan = tmc.nodes_plan(n, D)
    assert plan["grid"] == grid


def test_nodes_constants_match_the_header():
    """NODES_BLOCK, NODES_COLS, NODES_ROWS and the shared memory's formula
    are csrc/nodes.cuh's."""
    import re

    src = (tmc.cuda_build.CSRC / "nodes.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (kNodes\w+) = (\d+);", src))
    assert int(consts["kNodesBlock"]) == tmc.NODES_BLOCK
    assert int(consts["kNodesCols"]) == tmc.NODES_COLS
    assert int(consts["kNodesRows"]) == tmc.NODES_ROWS
    assert "constexpr int kNodesPitch = kNodesRows + 1;" in src
    assert "(kNodesCols + kNodesPitch)" in src
    assert tmc.nodes_smem(100) == 4 * 100 * (32 + 33)


@pytest.mark.parametrize("name,symbol", [("mix_nodes", "repro_mix_nodes"),
                                         ("cmix_nodes", "repro_cmix_nodes")])
def test_nodes_entry_points_are_bound(name, symbol):
    """The node-parallel instances' C entry points have their rows in
    ENTRY_POINTS, in the library of their kernel (the rows' argument types
    are held against the C signatures by test_torch_kernels.py)."""
    library = name.split("_")[0]
    assert tmc.cuda_build.ENTRY_POINTS[name][:2] == (library, symbol)


def test_mix_flat_on_the_cpu_takes_the_plain_twin_at_any_n():
    """On CPU tensors the wrapper runs the plain twin whatever instance
    the rule would pick on the card: no launch is counted."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((100, 10)).astype(np.float32))
    d, M = (torch.from_numpy(a) for a in tmc.phase_matrices("gossip", "ring",
                                                            100))
    before = (tmc.mix_flat.launches, tmc.mix_flat.nodes_launches)
    out = tmc.mix_flat(x, None, None, d, M, with_g=False,
                       with_residual=True, wire=False)
    want = tmc.mix_flat_plain(x, None, None, d, M, with_g=False,
                              with_residual=True, wire=False)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert (tmc.mix_flat.launches, tmc.mix_flat.nodes_launches) == before


# ---------------------------------------------------------------------------
# collective.cu's narrow instance (a round one narrow scale block wide)
# ---------------------------------------------------------------------------
def _narrow_fits(n, n_pods, D):
    return tmc.collective_narrow_smem(n, n_pods, D) <= \
        tmc.cuda_build.MAX_SMEM


@pytest.mark.parametrize("n,n_pods,D,qblock,want", [
    (100, 1, 10, 1024, "narrow"), (100, 4, 10, 1024, "narrow"),
    (16, 1, 10, 1024, "narrow"), (32, 2, 10, 1024, "narrow"),
    (1, 1, 1, 1024, "narrow"), (256, 1, 1, 1024, "narrow"),
    (100, 1, 10, 256, "narrow"), (8, 1, 1_000_003, 1024, "tiled"),
    (8, 1, 138_431_232, 1024, "tiled"), (100, 1, 100_003, 1024, "untiled"),
    (16, 2, 1025, 1024, "tiled"), (100, 1, 300, 256, "tiled")])
def test_collective_instance_rule(n, n_pods, D, qblock, want):
    """The narrow instance takes a round whose whole width is one scale
    block of at most COLLECTIVE_NARROW_D columns while its tile fits; the
    tiled and untiled ones keep every other shape ([sim]'s n = 100, D = 10
    global round, the main path's n = 8 packed width, n = 100 past one
    block)."""
    assert tmc.collective_instance(n, n_pods, D, qblock) == want
    assert tmc.use_narrow_collective(n, n_pods, D, qblock) is (
        want == "narrow")


@pytest.mark.parametrize("n,n_pods", [(1, 1), (16, 2), (32, 1), (100, 4),
                                      (256, 1)])
def test_narrow_collective_width_edges(n, n_pods):
    """At the width rule's edge: D up to min(COLLECTIVE_NARROW_D, qblock)
    and no wider, and no D whose tile passes the card's shared memory."""
    edge = tmc.COLLECTIVE_NARROW_D
    for D in (edge, edge + 1):
        want = D <= edge and _narrow_fits(n, n_pods, D)
        assert tmc.use_narrow_collective(n, n_pods, D, 1024) is want
    assert not tmc.use_narrow_collective(n, n_pods, 257, 256)
    widest = max(D for D in range(1, edge + 1) if _narrow_fits(n, n_pods, D))
    assert tmc.use_narrow_collective(n, n_pods, widest, 1024)


def test_narrow_collective_smem_matches_the_source():
    """collective_narrow_smem is collective.cu's launch_narrow formula:
    the n × D tile, the n_pods × D pod means and both stages' scales."""
    src = (tmc.cuda_build.CSRC / "collective.cu").read_text()
    assert ("(static_cast<size_t>(n + n_pods) * D + 2 * n + n_pods)"
            in src)
    assert "collective_narrow_kernel<KIND, EF><<<1, block, smem, s>>>" in src
    assert "D > 4096" in src and tmc.COLLECTIVE_NARROW_D <= 4096
    assert tmc.collective_narrow_smem(100, 1, 10) == 4 * (101 * 10 + 201)
    assert tmc.COLLECTIVE_NARROW_BLOCK % 32 == 0
    assert 32 <= tmc.COLLECTIVE_NARROW_BLOCK <= 1024


@pytest.mark.parametrize("name,library,symbol", [
    ("collective_narrow", "collective", "repro_collective_narrow"),
    ("shard_cmix_nodes", "shard_cmix", "repro_shard_cmix_nodes")])
def test_new_instances_entry_points_are_bound(name, library, symbol):
    """The narrow collective's and the node-parallel shard_cmix's C entry
    points have their rows in ENTRY_POINTS, in their kernel's library."""
    assert tmc.cuda_build.ENTRY_POINTS[name][:2] == (library, symbol)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("n_pods", [1, 4])
@pytest.mark.parametrize("with_ef", [False, True])
def test_collective_flat_plain_matches_pallas_at_the_simulators_shape(
        kind, n_pods, with_ef):
    """[sim]'s compressed global (and a 4-pod) round at n = 100, D = 10,
    the narrow instance's shape: the plain twin and the CPU wrapper
    against the Pallas kernel in interpret mode (tolerance above)."""
    from repro.compress import collective as jcol
    from repro_torch.compress import collective as tcol
    rng = np.random.default_rng(36)
    x = rng.standard_normal((100, 10)).astype(np.float32)
    e = (0.01 * rng.standard_normal((100, 10))).astype(np.float32)
    s1, s2 = tcol.stage_seeds(7)
    j1, j2 = jcol.stage_seeds(jnp.uint32(7))
    kw = dict(kind=kind, with_ef=with_ef, n_pods=n_pods, qblock=1024)
    want = jmp._collective_flat(jnp.asarray(x),
                                jnp.asarray(e) if with_ef else None, j1, j2,
                                interpret=True, **kw)
    te = torch.from_numpy(e) if with_ef else None
    before = (tmc.collective_flat.launches,
              tmc.collective_flat.narrow_launches)
    for got in (tmc.collective_flat_plain(torch.from_numpy(x), te, s1, s2,
                                          **kw),
                tmc.collective_flat(torch.from_numpy(x), te, s1, s2,
                                    instance="narrow", **kw)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=RTOL, atol=ATOL)
        if with_ef:
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                       rtol=RTOL, atol=ATOL)
    assert (tmc.collective_flat.launches,
            tmc.collective_flat.narrow_launches) == before


def test_collective_flat_refuses_an_unknown_instance():
    x = torch.zeros(4, 10)
    with pytest.raises(ValueError, match="unknown instance"):
        tmc.collective_flat(x, None, 1, 2, kind="int8", with_ef=False,
                            n_pods=1, qblock=1024, instance="tiles")
