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


# (n, D, offset of x, offset of g (None: no g), want)
VECTOR_RULE = [
    (4, 1000, 0, None, True), (8, 1000, 0, None, True),
    (16, 1002, 0, None, True), (32, 1001, 0, None, True),
    (8, 1000, 0, 0, True),
    (2, 1000, 0, None, False), (5, 1000, 0, None, False),
    (64, 1000, 0, None, False),
    (8, 1001, 0, None, False), (4, 1002, 0, None, False),
    (16, 1001, 0, None, False),
    (8, 1000, 1, None, False), (8, 1000, 2, None, False),
    (8, 1000, 0, 1, False),
]


@pytest.mark.parametrize("n,D,x_off,g_off,want", VECTOR_RULE)
def test_use_vector_mix_rule(n, D, x_off, g_off, want):
    x = _rows(n, D, x_off)
    g = None if g_off is None else _rows(n, D, g_off)
    assert tmc.use_vector_mix(x, g) is want


@pytest.mark.parametrize("D", (19_200, 7_077_888, 25_165_824, 28_311_552))
def test_use_vector_mix_takes_the_main_path_widths(D):
    """Every launch width of pga-lm-100m's fused round at 8 nodes (the
    norms' staging buffer, the attention projections, the embedding, the
    MLP matrices) takes the register instance; meta tensors stand in for
    the gigabyte operands (their pointer is 0, so aligned)."""
    x = torch.empty((8, D), device="meta")
    assert tmc.use_vector_mix(x) and tmc.use_vector_mix(x, x)


def test_use_vector_mix_refuses_strided_rows():
    x = _rows(8, 2000)
    assert not tmc.use_vector_mix(x[:, ::2])
    assert not tmc.use_vector_mix(x.t().contiguous().t())


@pytest.mark.parametrize("launcher", ["mix_generic", "mix_vector"])
def test_mix_direct_launchers_refuse_cpu_operands(launcher):
    """The launchers of one instance (which chip_smoke times and compares
    directly) take CUDA operands only and count nothing on the CPU."""
    x = _rows(8, 1000)
    d, M = (torch.from_numpy(a) for a in tmc.phase_matrices("gossip", "ring",
                                                            8))
    before = (tmc.mix_flat.launches, tmc.mix_flat.vector_launches)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tmc, launcher)(x, None, None, d, M, with_g=False,
                               with_residual=True, wire=False)
    assert (tmc.mix_flat.launches, tmc.mix_flat.vector_launches) == before
