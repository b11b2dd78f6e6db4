"""Port parity: ``repro_torch.compress`` and the compressed rounds vs the
JAX reference on the CPU.

The same numpy inputs go through both packages.  The fused JAX entry
points run their Pallas kernels in interpret mode (the default off-TPU);
the port's wrappers take the kernels' plain twins on CPU tensors.

Tolerances, with their reasons:
* the counter hash, the seeds, the random bits, the scales, the int8/fp8
  codes and the power-of-two block scales are **bitwise** equal, on edge
  values included (0, 0xFFFFFFFF, ±448, the fp8 denormal tail, denormal
  entries of normal rows, all-zero rows).  One input is excluded by
  construction and pinned on its own: a row whose absmax is itself an fp32
  denormal, which XLA on the CPU flushes to zero (scale 1) while PyTorch
  and the CUDA kernels keep it;
* compressed rounds: atol 2e-5, the reference's own backend tolerance
  (``tests/test_compress.py``): the codes agree exactly, the dense mix sums
  in another order (measured: at most 2.4e-7);
* the compressed collective: atol 2e-5 (measured: 0.0 — with power-of-two
  scales and pods of a power-of-two size the anchored pod sum is exact in
  any order);
* a constant state keeps its rows equal bitwise in every compressed
  round, is returned bitwise by one-peer gossip (½ weights) and by every
  collective round, and to the reference's rtol 5e-7 elsewhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as JC
from repro.compress import base as jbase
from repro.compress import collective as jcol
from repro.compress import quantize as jq
from repro.core import mixing as jmix
from repro.kernels import mixing_pallas as jmp
from repro_torch import compress as TC
from repro_torch.compress import base as tbase
from repro_torch.compress import collective as tcol
from repro_torch.compress import quantize as tq
from repro_torch.core import mixing as tmix
from repro_torch.kernels import mixing_cuda as tmc

torch.set_num_threads(2)

N = 8
ATOL = 2e-5
LOSSY = ("int8", "fp8", "topk", "randk")
PHASES = [("gossip", "ring", 1), ("gossip", "one_peer_exp", 1),
          ("global", "ring", 1), ("pod_avg", "ring", 2)]
EDGE_U32 = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x9E3779B9,
                     0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _tree(seed=0, n=N):
    rng = np.random.default_rng(seed)
    # ragged widths; "c" spans three 1024-column collective blocks
    return {"b": rng.standard_normal((n, 3, 5)).astype(np.float32),
            "a": {"w": rng.standard_normal((n, 37)).astype(np.float32)},
            "c": rng.standard_normal((n, 2100)).astype(np.float32)}


def _ef(seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32),
        _tree())


def _jax(tree):
    return None if tree is None else jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return None if tree is None else jax.tree.map(torch.from_numpy, tree)


def _close(jtree, ttree, atol=ATOL):
    jl, tl = jax.tree.leaves(jtree), jax.tree.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                                   atol=atol)


def _bits_equal(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _edge_rows():
    """(8, 40) fp32 rows covering the quantizers' edge values."""
    rng = np.random.default_rng(3)
    y = rng.standard_normal((8, 40)).astype(np.float32)
    y[1] = 0.0                                          # all-zero row
    y[2, :6] = [448.0, -448.0, 1e-40, -3e-39, 2.0 ** -126, 0.0]
    y[3] *= 1e4                                         # wide range
    y[4, :4] = [447.99997, -0.0, 2.0 ** -10, -2.0 ** -9]
    y[5] = 448.0                                        # constant at max
    y[6] = np.float32(2.0 ** -7) * rng.integers(-3, 4, 40)
    return y


# ---------------------------------------------------------------------------
# Shared randomness, scales and codes: bitwise
# ---------------------------------------------------------------------------
def test_hash_and_seeds_bitwise():
    want = np.asarray(jbase.hash_u32(jnp.asarray(EDGE_U32)))
    got = tbase.hash_u32(torch.from_numpy(EDGE_U32.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for v, w in zip(EDGE_U32, want):
        assert tbase.hash_u32(int(v)) == int(w)       # the host-int path
    for seed in (0, 7, 0xFFFFFFFF):
        for salt in (0, 1, 10):
            assert tbase.leaf_seed(seed, salt) == int(
                jbase.leaf_seed(jnp.uint32(seed), salt))
        s1, s2 = tcol.stage_seeds(seed)
        j1, j2 = jcol.stage_seeds(jnp.uint32(seed))
        assert (s1, s2) == (int(j1), int(j2))


def test_column_bits_and_uniforms_bitwise():
    cols = np.concatenate([np.arange(64), [2 ** 24 - 1, 2 ** 31,
                                           2 ** 32 - 1]]).astype(np.uint32)
    for seed in (0, 12345, 0xFFFFFFFF):
        jb = np.asarray(jbase.column_bits(jnp.uint32(seed), jnp.asarray(cols)))
        tb = tbase.column_bits(seed, torch.from_numpy(cols.astype(np.int64)))
        np.testing.assert_array_equal(tb.numpy(), jb.astype(np.int64))
        ju = jbase.uniform_columns(jnp.uint32(seed), jnp.asarray(cols))
        tu = tbase.uniform_columns(seed, torch.from_numpy(
            cols.astype(np.int64)))
        _bits_equal(tu.numpy(), ju)
        assert float(tu.min()) >= 0.0 and float(tu.max()) < 1.0


@pytest.mark.parametrize("kind", ("int8", "fp8"))
def test_scales_and_codes_bitwise_on_edge_values(kind):
    y = _edge_rows()
    cols = np.arange(y.shape[1], dtype=np.uint32)
    if kind == "int8":
        js = jq.int8_scale(jnp.asarray(y))
        ts = tq.int8_scale(torch.from_numpy(y))
        ju = jbase.uniform_columns(jnp.uint32(5), jnp.asarray(cols))[None]
        tu = tbase.uniform_columns(5, torch.arange(y.shape[1]))[None]
        jc = jq.int8_codes(jnp.asarray(y), js, ju)
        tc = tq.int8_codes(torch.from_numpy(y), ts, tu)
        jd, td = jq.int8_dequant(jc, js), tq.int8_dequant(tc, ts)
    else:
        js = jq.fp8_scale(jnp.asarray(y))
        ts = tq.fp8_scale(torch.from_numpy(y))
        jbits = jbase.column_bits(jnp.uint32(5), jnp.asarray(cols))[None]
        tbits = tbase.column_bits(5, torch.arange(y.shape[1]))[None]
        jc = jq.fp8_codes(jnp.asarray(y), js, jbits)
        tc = tq.fp8_codes(torch.from_numpy(y), ts, tbits)
        assert tc.dtype == torch.float8_e4m3fn
        jd, td = jq.fp8_dequant(jc, js), tq.fp8_dequant(tc, ts)
        jc, tc = jc.astype(jnp.float32), tc.to(torch.float32)
    _bits_equal(ts.numpy(), js)
    assert float(ts[1, 0]) == 1.0                       # all-zero row
    _bits_equal(tc.numpy(), jc)
    _bits_equal(td.numpy(), jd)


def test_fp8_codes_bitwise_on_the_denormal_tail():
    """Every fp32 value on a 2⁻¹⁴ grid through ±2⁻⁴ (the e4m3 denormals
    are multiples of 2⁻⁹ below 2⁻⁶, so the cast rounds to nearest even),
    with zero, all-ones and random low bits."""
    z = (np.arange(-1024, 1025, dtype=np.float32) * 2.0 ** -14)[None]
    one = np.ones((1, 1), np.float32)
    rng = np.random.default_rng(4)
    for bits in (np.zeros(z.shape, np.uint32),
                 np.full(z.shape, 0xFFFFFFFF, np.uint32),
                 rng.integers(0, 2 ** 32, z.shape, dtype=np.uint32)):
        jc = jq.fp8_codes(jnp.asarray(z), jnp.asarray(one),
                          jnp.asarray(bits)).astype(jnp.float32)
        tc = tq.fp8_codes(torch.from_numpy(z), torch.from_numpy(one),
                          torch.from_numpy(bits.astype(np.int64)))
        _bits_equal(tc.to(torch.float32).numpy(), jc)


@pytest.mark.parametrize("shift", (7, 8))
def test_pow2_block_scale_and_exponents_bitwise(shift):
    y = _edge_rows().reshape(8, 4, 10)
    js = jcol.pow2_block_scale(jnp.asarray(y), shift)
    ts = tcol.pow2_block_scale(torch.from_numpy(y), shift)
    _bits_equal(ts.numpy(), js)
    exps = tcol.scale_exponents(ts)
    np.testing.assert_array_equal(exps.numpy(),
                                  np.asarray(jcol.scale_exponents(js)))
    _bits_equal(tcol.exponent_scales(exps).numpy(), ts.numpy())


def test_all_denormal_row_keeps_its_scale():
    """The one divergence: XLA on the CPU flushes a denormal absmax to zero
    (scale 1, so the row quantizes to zeros); PyTorch and the CUDA kernels
    keep the denormal scale, and the row round-trips within one step."""
    y = (np.linspace(-1, 1, 40, dtype=np.float32) * 1e-39)[None]
    assert float(np.asarray(jq.int8_scale(jnp.asarray(y)))[0, 0]) == 1.0
    ts = tq.int8_scale(torch.from_numpy(y))
    assert 0.0 < float(ts[0, 0]) < 1e-38
    u = tbase.uniform_columns(5, torch.arange(40))[None]
    q = tq.int8_dequant(tq.int8_codes(torch.from_numpy(y), ts, u), ts)
    assert float((q - torch.from_numpy(y)).abs().max()) <= float(ts[0, 0])


def test_collective_quantize_blocks_bitwise_and_column_offset():
    """quantize_blocks/dequant_blocks/anchored_mean bitwise; the random
    bits are keyed on the absolute column, so quantizing a block at its
    column offset reproduces the whole matrix's block."""
    rng = np.random.default_rng(5)
    y = rng.standard_normal((8, 256)).astype(np.float32)
    for kind in ("int8", "fp8"):
        jw, js, jqq = jcol.quantize_blocks(jnp.asarray(y), kind,
                                           jnp.uint32(9), qblock=64)
        tw, ts, tqq = tcol.quantize_blocks(torch.from_numpy(y), kind, 9,
                                           qblock=64)
        _bits_equal(tw.to(torch.float32).numpy(), jw.astype(jnp.float32))
        _bits_equal(ts.numpy(), js)
        _bits_equal(tqq.numpy(), jqq)
        _bits_equal(tcol.dequant_blocks(tw, ts, 64).numpy(), jqq)
        _, _, seg = tcol.quantize_blocks(torch.from_numpy(y[:, 128:192]),
                                         kind, 9, qblock=64, col0=128)
        _bits_equal(seg.numpy(), tqq[:, 128:192].numpy())
        for pods in (1, 2, 4):
            _bits_equal(tcol.anchored_mean(tqq, pods).numpy(),
                        jcol.anchored_mean(jqq, pods))


# ---------------------------------------------------------------------------
# Sparsifiers and the pytree codec
# ---------------------------------------------------------------------------
def test_topk_randk_selections_with_ties():
    """Ties (equal magnitudes, repeated values, zeros) select the lower
    index, as ``jax.lax.top_k`` does: a stable descending sort."""
    y = np.array([[1.0, -2.0, 2.0, 0.5, -2.0, 0.0, 0.0, 2.0],
                  [0.0] * 8,
                  [3.0, 3.0, -3.0, 3.0, 1.0, 1.0, -1.0, 1.0]], np.float32)
    for k in (1, 2, 3, 5, 8):
        jt, tt = JC.make_compressor("topk", k=k), TC.make_compressor(
            "topk", k=k)
        jw = jt.compress_leaf(jnp.asarray(y), jnp.uint32(0))
        tw = tt.compress_leaf(torch.from_numpy(y), 0)
        np.testing.assert_array_equal(tw.aux[0].numpy(),
                                      np.asarray(jw.aux[0]))
        np.testing.assert_array_equal(tw.payload[0].numpy(),
                                      np.asarray(jw.payload[0]))
        assert tw.nbytes == jw.nbytes
        for seed in (0, 3, 77):
            jr, tr = JC.make_compressor("randk", k=k), TC.make_compressor(
                "randk", k=k)
            jw = jr.compress_leaf(jnp.asarray(y), jnp.uint32(seed))
            tw = tr.compress_leaf(torch.from_numpy(y), seed)
            np.testing.assert_array_equal(tw.aux[0].numpy(),
                                          np.asarray(jw.aux[0]))
            np.testing.assert_array_equal(
                tr.decompress_leaf(tw, 8).numpy(),
                np.asarray(jr.decompress_leaf(jw, 8)))


@pytest.mark.parametrize("name", ("identity",) + LOSSY)
def test_compress_tree_and_apply_tree_with_error_feedback(name):
    x, ef = _tree(), _ef()
    jc, tc = JC.make_compressor(name, k=4), TC.make_compressor(name, k=4)
    jwires, jef = JC.compress_tree(jc, _jax(x), _jax(ef), jnp.uint32(11))
    twires, tef = TC.compress_tree(tc, _torch(x), _torch(ef), 11)
    assert [w.nbytes for w in twires] == [w.nbytes for w in jwires]
    assert TC.tree_wire_bytes(tc, _torch(x)) == JC.tree_wire_bytes(jc,
                                                                   _jax(x))
    _close(jef, tef, atol=1e-6)
    jq_, jef2 = JC.apply_tree(jc, _jax(x), _jax(ef), jnp.uint32(11))
    tq_, tef2 = TC.apply_tree(tc, _torch(x), _torch(ef), 11)
    _close(jq_, tq_, atol=1e-6)
    _close(jef2, tef2, atol=1e-6)
    zero = TC.init_ef_state(_torch(x))
    assert all(z.dtype == torch.float32 and not z.any()
               for z in jax.tree.leaves(zero))


# ---------------------------------------------------------------------------
# The fused entry points (plain twins) vs the JAX Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", LOSSY)
@pytest.mark.parametrize("phase,topology,n_pods", PHASES)
def test_compressed_step_mix_matches_pallas(name, phase, topology, n_pods):
    """Every kind × phase, EF on and off, and the global phase's bf16 wire
    cast (which applies to both occurrences of q)."""
    x, ef = _tree(0), _ef()
    wires = ((None, None), (jnp.bfloat16, torch.bfloat16)) \
        if phase == "global" else ((None, None),)
    for use_ef in (False, True):
        for jd, td in wires:
            kw = dict(seed=7, phase=phase, topology=topology, n_nodes=N,
                      step=1, n_pods=n_pods)
            jo, je = jmp.compressed_step_mix(
                _jax(x), compressor=JC.make_compressor(name, k=3),
                ef_state=_jax(ef) if use_ef else None, comm_dtype=jd, **kw)
            to, te = tmc.compressed_step_mix(
                _torch(x), compressor=TC.make_compressor(name, k=3),
                ef_state=_torch(ef) if use_ef else None, comm_dtype=td, **kw)
            _close(jo, to)
            if use_ef:
                _close(je, te)
            else:
                assert je is None and te is None
    assert tmc.cmix_flat.launches == 0   # CPU tensors: plain twin only


@pytest.mark.parametrize("name", ("int8", "fp8"))
@pytest.mark.parametrize("phase,n_pods", (("global", 1), ("pod_avg", 2),
                                          ("pod_avg", 4)))
def test_collective_step_mix_matches_pallas(name, phase, n_pods):
    """Packed tree of 2,152 columns: the last 1024-column block is ragged
    (the reference pads it, the port's kernel masks it)."""
    x, ef = _tree(2), _ef()
    for use_ef in (False, True):
        kw = dict(seed=7, phase=phase, n_nodes=N, n_pods=n_pods)
        jo, je = jmp.collective_step_mix(
            _jax(x), compressor=JC.make_compressor(name),
            ef_state=_jax(ef) if use_ef else None, **kw)
        to, te = tmc.collective_step_mix(
            _torch(x), compressor=TC.make_compressor(name),
            ef_state=_torch(ef) if use_ef else None, **kw)
        _close(jo, to)
        if use_ef:
            _close(je, te)
    # a small qblock: many blocks, each padded the same way
    jo, _ = jmp.collective_step_mix(_jax(x), compressor=JC.make_compressor(
        name), seed=3, phase=phase, n_nodes=N, n_pods=n_pods, qblock=128)
    to, _ = tmc.collective_step_mix(_torch(x), compressor=TC.make_compressor(
        name), seed=3, phase=phase, n_nodes=N, n_pods=n_pods, qblock=128)
    _close(jo, to)
    assert tmc.collective_flat.launches == 0


@pytest.mark.parametrize("name", LOSSY)
def test_constant_state_is_a_bitwise_fixed_point(name):
    """Equal rows transmit equal q, so the rows of a compressed round stay
    equal bitwise for every kind and phase; with the one-peer ½ weights
    the compensation cancels bitwise (elsewhere to ulps, the reference's
    rtol 5e-7); the collective returns a consensus state bitwise for every
    kind and pod split."""
    rng = np.random.default_rng(8)
    row = torch.from_numpy(rng.standard_normal((1, 1500)).astype(np.float32))
    const = {"w": torch.full((N, 5, 3), -2.25), "b": torch.full((N, 7), 0.1),
             "c": row.expand(N, 1500).contiguous()}
    zeros = TC.init_ef_state(const)
    comp = TC.make_compressor(name, k=3)
    for phase, topology, n_pods in PHASES:
        for ef in (None, zeros):
            got, _ = tmc.compressed_step_mix(
                const, compressor=comp, ef_state=ef, seed=9, phase=phase,
                topology=topology, n_nodes=N, step=3, n_pods=n_pods)
            for g, c in zip(jax.tree.leaves(got), jax.tree.leaves(const)):
                assert torch.equal(g, g[:1].expand_as(g)), (name, phase)
                if topology == "one_peer_exp":
                    assert torch.equal(g, c), (name, phase)
                else:
                    np.testing.assert_allclose(g.numpy(), c.numpy(),
                                               rtol=5e-7, atol=0)
    if name in ("int8", "fp8"):
        for phase, n_pods in (("global", 1), ("pod_avg", 2), ("pod_avg", 4)):
            for ef in (None, zeros):
                got, _ = tmc.collective_step_mix(
                    const, compressor=comp, ef_state=ef, seed=9,
                    phase=phase, n_nodes=N, n_pods=n_pods)
                for g, c in zip(jax.tree.leaves(got),
                                jax.tree.leaves(const)):
                    assert torch.equal(g, c), (name, phase)


def test_wrappers_take_plain_twins_on_cpu_and_reject_bad_operands():
    x = torch.randn(4, 100)
    w, M = (torch.from_numpy(a) for a in tmix.compensated_round_factors(
        "gossip", "ring", 4))
    scale = tq.int8_scale(x)
    o, e = tmc.cmix_flat(x, None, None, 3, scale, w, M, kind="int8",
                         with_ef=False, wire=False)
    po, _ = tmc.cmix_flat_plain(x, None, None, 3, scale, w, M, kind="int8",
                                with_ef=False, wire=False)
    assert torch.equal(o, po) and e is None
    assert tmc.cmix_flat.launches == tmc.collective_flat.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tmc.cmix_flat(x.to("meta"), None, None, 3, scale.to("meta"),
                      w.to("meta"), M.to("meta"), kind="int8",
                      with_ef=False, wire=False)
    with pytest.raises(ValueError, match="unknown kind"):
        tmc.cmix_flat(x, None, None, 3, scale, w, M, kind="int4",
                      with_ef=False, wire=False)
    with pytest.raises(ValueError, match="unsupported kind"):
        tmc.collective_flat(x, None, 1, 2, kind="topk", with_ef=False,
                            n_pods=1, qblock=1024)
    with pytest.raises(ValueError, match="bfloat16 only"):
        tmc.compressed_step_mix({"w": x}, compressor=TC.make_compressor(
            "int8"), phase="global", n_nodes=4, comm_dtype=torch.float16)


# ---------------------------------------------------------------------------
# communicate, both backends, and the config vocabularies
# ---------------------------------------------------------------------------
def _specs(backend, name="none", global_name="none", comm_dtype=None):
    jd = None if comm_dtype is None else jnp.bfloat16
    td = None if comm_dtype is None else torch.bfloat16
    jspec = jmix.CommSpec(
        topology="one_peer_exp", n_nodes=N, n_pods=2, backend=backend,
        comm_dtype=jd, compressor=JC.make_compressor(name, k=3),
        global_compressor=JC.make_compressor(global_name)).validate()
    tspec = tmix.CommSpec(
        topology="one_peer_exp", n_nodes=N, n_pods=2, backend=backend,
        comm_dtype=td, compressor=TC.make_compressor(name, k=3),
        global_compressor=TC.make_compressor(global_name)).validate()
    return jspec, tspec


@pytest.mark.parametrize("backend", ("reference", "pallas"))
@pytest.mark.parametrize("name,global_name", (
    ("int8", "none"), ("fp8", "fp8"), ("topk", "int8"), ("randk", "none"),
    ("identity", "int8"), ("int8", "identity"), ("none", "fp8")))
def test_communicate_matches_reference(backend, name, global_name):
    """``communicate(params, spec, phase=, step=)`` with EF through every
    phase; the identity codecs take the exact paths."""
    x, ef = _tree(4), _ef()
    jspec, tspec = _specs(backend, name, global_name)
    for phase in ("none", "gossip", "global", "pod_avg"):
        for step in (0, 1):
            jout = jmix.communicate(_jax(x), jspec, phase=phase, step=step,
                                    ef_state=_jax(ef), seed=5 + step)
            tout = tmix.communicate(_torch(x), tspec, phase=phase, step=step,
                                    ef_state=_torch(ef), seed=5 + step)
            _close(jout[0], tout[0])
            _close(jout[1], tout[1])


def test_communicate_identity_is_bit_identical_to_uncompressed():
    x = _torch(_tree(6))
    for backend in ("reference", "pallas"):
        _, plain = _specs(backend)
        _, ident = _specs(backend, "identity", "identity")
        for phase in ("gossip", "global", "pod_avg"):
            want = tmix.communicate(x, plain, phase=phase, step=1)
            got, ef = tmix.communicate(x, ident, phase=phase, step=1)
            assert ef is None
            for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                assert torch.equal(g, w)


def test_distconfig_vocabularies_and_wire_bytes_match_reference():
    from repro.configs import DistConfig as JDist
    from repro_torch.configs import DistConfig as TDist
    assert TC.COMPRESSORS == JC.COMPRESSORS
    assert TC.COLLECTIVE_COMPRESSORS == JC.COLLECTIVE_COMPRESSORS
    assert TC.QBLOCK == jcol.QBLOCK
    for name in TC.COMPRESSORS:
        TDist(comm_compression=name).validate()
        JDist(comm_compression=name).validate()
    for name in TC.COLLECTIVE_COMPRESSORS:
        TDist(comm_global_compression=name).validate()
    for bad in (dict(comm_compression="int4"),
                dict(comm_global_compression="topk"),
                dict(comm_compression_k=0),
                dict(comm_error_feedback=True),
                dict(comm_error_feedback=True, comm_compression="identity")):
        with pytest.raises(ValueError):
            TDist(**bad).validate()
        with pytest.raises(ValueError):
            JDist(**bad).validate()
    spec = TDist(comm_compression="topk", comm_compression_k=5,
                 comm_global_compression="fp8").comm_spec(8)
    assert spec.lossy and spec.compressor.k == 5
    assert spec.global_compressor.name == "fp8"
    sizes = [15, 37, 2100]
    for phase, topo in (("gossip", "ring"), ("gossip", "one_peer_exp"),
                        ("gossip", "grid"), ("global", "ring"),
                        ("pod_avg", "ring")):
        for comp, gcomp in (("none", "none"), ("int8", "none"),
                            ("topk", "fp8"), ("randk", "none")):
            kw = dict(compression=comp, global_compression=gcomp, k=3,
                      leaf_sizes=sizes, n_pods=2, step=1)
            assert TC.round_wire_bytes(phase, topo, N, sum(sizes), **kw) \
                == JC.round_wire_bytes(phase, topo, N, sum(sizes), **kw)
    assert TC.collective_wire_bytes("int8", 2152) == \
        jcol.collective_wire_bytes("int8", 2152)


# ---------------------------------------------------------------------------
# The compressed round on the card: the rule between cmix.cu's instances,
# and the rows' maxima its scales come from
# ---------------------------------------------------------------------------
def _rows(n, D, offset=0):
    """An (n, D) float32 view whose first element lies ``offset`` elements
    past a 16-byte boundary."""
    buf = torch.zeros(n * D + 8)
    start = (-buf.data_ptr() % 16) // 4 + offset
    return buf[start:start + n * D].view(n, D)


# (n, D, offsets of x, e, q (None: not passed), want)
CMIX_VECTOR_RULE = [
    (8, 1000, (0, None, None), True), (8, 1000, (0, 0, None), True),
    (8, 1000, (0, None, 0), True), (4, 1000, (0, 0, None), True),
    (16, 1002, (0, 0, None), True), (32, 1001, (0, 0, None), True),
    (3, 1000, (0, 0, None), False), (8, 1001, (0, 0, None), False),
    (8, 1000, (1, 0, None), False), (8, 1000, (0, 1, None), False),
    (8, 1000, (0, None, 3), False),
]


@pytest.mark.parametrize("n,D,offsets,want", CMIX_VECTOR_RULE)
def test_use_vector_cmix_rule(n, D, offsets, want):
    x, e, q = (None if o is None else _rows(n, D, o) for o in offsets)
    assert tmc.use_vector_cmix(x, e, q) is want


def test_use_vector_cmix_takes_the_main_path_leaf():
    x = torch.empty((8, 25_165_824), device="meta")
    assert tmc.use_vector_cmix(x, x) and tmc.use_vector_cmix(x, None, x)


def _maxima_edge_rows():
    """(8, 41) x and e whose rows hold a NaN, +inf, -inf, only zeros, a
    denormal maximum, only negative values, and inf + (-inf)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((8, 41)).astype(np.float32)
    e = (0.01 * rng.standard_normal((8, 41))).astype(np.float32)
    x[0, 7] = np.nan
    x[1, 40] = np.inf
    x[2, 0] = -np.inf
    x[3] = e[3] = 0.0
    x[4] *= np.float32(1e-39)
    e[4] *= np.float32(1e-39)
    x[5] = -np.abs(x[5])
    x[6, 3], e[6, 3] = np.inf, -np.inf
    return torch.from_numpy(x), torch.from_numpy(e)


@pytest.mark.parametrize("with_ef", (False, True))
def test_absmax_plain_matches_the_amax_of_x_plus_e(with_ef):
    """The maxima kernel's plain version (and the CPU wrapper) equal
    ``absmax_rows(x + e)`` bitwise, NaN rows included; the NaN, infinite,
    zero and denormal rows come out as torch.amax makes them."""
    x, e = _maxima_edge_rows()
    ef = e if with_ef else None
    want = tq.absmax_rows(x + e if with_ef else x)
    launches = tmc.cmix_flat.absmax_launches
    for got in (tmc.cmix_absmax_plain(x, ef), tmc.cmix_absmax(x, ef)):
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.isnan(got[0, 0]) and float(got[1, 0]) == np.inf
        assert float(got[2, 0]) == np.inf and float(got[3, 0]) == 0.0
        assert 0.0 < float(got[4, 0]) < 2.0 ** -126
        assert bool(torch.isnan(got[6, 0])) is with_ef
    assert tmc.cmix_flat.absmax_launches == launches
    with pytest.raises(ValueError, match="ef must match"):
        tmc.cmix_absmax(x, e[:, :40])


@pytest.mark.parametrize("kind", ("int8", "fp8"))
def test_scales_of_the_maxima_equal_the_scales(kind):
    """``int8_scale``/``fp8_scale`` split as a function of the rows'
    maxima: bitwise the same scales (NaN and infinite rows included), and
    on the edge rows bitwise the reference's."""
    of_max, scale, jscale = ((tq.int8_scale_of_max, tq.int8_scale,
                              jq.int8_scale) if kind == "int8" else
                             (tq.fp8_scale_of_max, tq.fp8_scale,
                              jq.fp8_scale))
    x, e = _maxima_edge_rows()
    for y in (x, x + e, torch.from_numpy(_edge_rows())):
        _bits_equal(of_max(tq.absmax_rows(y)).numpy(), scale(y).numpy())
    y = _edge_rows()
    _bits_equal(of_max(tq.absmax_rows(torch.from_numpy(y))).numpy(),
                jscale(jnp.asarray(y)))


@pytest.mark.parametrize("launcher", ["cmix_generic", "cmix_vector",
                                      "cmix_nodes"])
def test_cmix_direct_launchers_refuse_cpu_operands(launcher):
    x = _rows(8, 1000)
    w, M = (torch.from_numpy(a) for a in tmix.compensated_round_factors(
        "gossip", "ring", 8))
    before = (tmc.cmix_flat.launches, tmc.cmix_flat.vector_launches,
              tmc.cmix_flat.nodes_launches)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tmc, launcher)(x, None, None, 3, tq.int8_scale(x), w, M,
                               kind="int8", with_ef=False, wire=False)
    assert (tmc.cmix_flat.launches, tmc.cmix_flat.vector_launches,
            tmc.cmix_flat.nodes_launches) == before


@pytest.mark.parametrize("n,n_pods,tiled,fits", [
    (8, 1, True, True), (56, 1, True, True), (56, 4, True, True),
    (57, 1, True, False), (100, 1, True, False), (100, 1, False, True),
    (100, 4, False, True), (4096, 1, False, True)])
def test_collective_shared_memory_picks_the_instance(n, n_pods, tiled, fits):
    """collective.cu's shared memory per block: the tiled instance holds
    n × 1024 stage-1 codes and fits up to n = 56; the untiled one holds
    only the warp partials and both stages' scales, so n = 100 (the
    paper's largest network) runs on it."""
    need = tmc.collective_smem(n, n_pods, 1024, tiled)
    nwarps = tmc.COLLECTIVE_BLOCK // 32
    assert need == 4 * ((n * 1024 if tiled else 0)
                        + (n_pods + n) * nwarps + n_pods + 2 * n)
    assert (need <= 232_448) == fits


@pytest.mark.parametrize("n", (1, 2, 3, 7, 8, 16, 100))
def test_pairwise_mean_halves_in_the_kernels_order(n):
    """tree.pairwise_mean sums s[i] += s[m − h + i] level by level, as
    csrc/mix.cu does: equal to that sum written out, exact on equal rows
    when n is a power of two, and it leaves its input untouched."""
    from repro_torch.tree import pairwise_mean

    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, 33)).astype(np.float32))
    keep = x.clone()
    rows, m = [x[i] for i in range(n)], n
    while m > 1:
        h = m // 2
        rows = [rows[i] + rows[m - h + i] for i in range(h)] + rows[h:m - h]
        m -= h
    got = pairwise_mean(x)
    assert got.shape == (1, 33)
    assert torch.equal(got[0], rows[0] / n)
    assert torch.equal(x, keep)
    same = x[:1].expand(n, 33).contiguous()
    if n & (n - 1) == 0:
        assert torch.equal(pairwise_mean(same), same[:1])
