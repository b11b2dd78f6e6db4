"""Port parity: the substrate kernel entry points (``repro_torch.kernels.ops``)
and oracles (``repro_torch.kernels.ref``), JAX vs ``repro_torch`` on the CPU.

Inputs are made with numpy from a seed; bf16 inputs cast the same float32
array in both frameworks (round to nearest even in both).  On the CPU the
ops take their kernels' plain twins; the JAX ops run the Pallas kernels in
interpret mode.

Tolerances, atol and rtol, the reference kernel suite's own: flash
attention 2e-5 (float32) and 2e-2 (bf16); RMSNorm 1e-5 and 1e-2; the
mLSTM op 5e-5 and 3e-2 (rtol ten times that).  Measured: float32 flash
within 8e-7, one bf16 output ulp at most.

The CUDA dispatch rules (``flash_attention_cuda.use_wgmma``,
``rmsnorm_cuda.use_vector``) and the kernels' shared-memory sizes are pure
Python and pinned here.  The tensor-core flash kernel rounds p to q's type
before p·v; ``test_wgmma_rounding_emulation_holds_the_card_tolerance``
emulates that rounding on the CPU and holds it to the check the card run
applies (``flash_attention_cuda.wgmma_tolerance`` and ``WGMMA_RMS_RATIO``
against the float64 twin).
"""
import ctypes
import math
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jk
from repro.configs import get_model_config as jax_config
from repro.kernels import ops as jops
from repro.models.layers import softcap as jax_softcap
from repro_torch import kernels as tk
from repro_torch.configs import get_model_config
from repro_torch.kernels import (flash_attention_cuda, mlstm_cuda, ops,
                                 ref, rmsnorm_cuda)
from repro_torch.models import attention as tattn
from repro_torch.models import blocks, layers
from repro_torch.kernels import cuda_build
from repro_torch.models.layers import softcap
from repro_torch.models.model import make_model

torch.set_num_threads(2)

FLASH_SWEEP = [
    # B, Sq, Sk, H, KH, D, causal, window, softcap, bq, bk: the JAX kernel
    # test's sweep
    (1, 64, 64, 4, 2, 32, True, None, None, 32, 32),
    (2, 100, 100, 4, 4, 16, True, 32, None, 32, 32),
    (1, 48, 48, 2, 1, 64, True, None, 50.0, 16, 16),
    (2, 32, 32, 8, 8, 8, False, None, None, 32, 32),
    (1, 128, 128, 2, 2, 128, True, None, None, 128, 128),
    (1, 17, 33, 3, 1, 24, False, None, None, 8, 16),   # ragged + cross-len
    (1, 256, 256, 1, 1, 64, True, 64, 30.0, 64, 64),   # window + softcap
]
# rows 20..39 have no valid key (causal, window 4, only 16 keys)
MASKED_ROWS = (1, 40, 16, 2, 1, 16, True, 4, None, 8, 8)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _flash_inputs(case, dtype, seed=0):
    """numpy float32 q, k, v; the JAX and torch arrays cast from them."""
    B, Sq, Sk, H, KH, D = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D))]
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _kw(case):
    return dict(causal=case[6], window=case[7], softcap=case[8])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else jnp.asarray(got, jnp.float32)),
        np.asarray(jnp.asarray(want, jnp.float32)), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_SWEEP + [MASKED_ROWS])
def test_flash_op_matches_jax_ref(case, dtype):
    (jq, jk_, jv), (q, k, v) = _flash_inputs(case, dtype)
    got = ops.flash_attention_op(q, k, v, block_q=case[9],
                                 block_k=case[10], **_kw(case))
    want = jk.flash_attention_ref(jq, jk_, jv, **_kw(case))
    assert got.dtype == DTYPES[dtype][1] and got.shape == q.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("case", [FLASH_SWEEP[0], FLASH_SWEEP[2],
                                  FLASH_SWEEP[5], MASKED_ROWS])
def test_flash_op_matches_jax_pallas_kernel(case):
    """Against the Pallas kernel itself (interpret mode), at the same
    blocking: rows without a valid key are exactly 0 on both sides."""
    (jq, jk_, jv), (q, k, v) = _flash_inputs(case, "float32", seed=1)
    kw = dict(block_q=case[9], block_k=case[10], **_kw(case))
    got = ops.flash_attention_op(q, k, v, **kw)
    want = jops.flash_attention_op(jq, jk_, jv, interpret=True, **kw)
    _close(got, want, 2e-5)
    if case is MASKED_ROWS:
        assert torch.equal(got[:, 20:], torch.zeros_like(got[:, 20:]))
        assert np.array_equal(np.asarray(want[:, 20:]), np.zeros_like(
            np.asarray(want[:, 20:])))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_SWEEP + [MASKED_ROWS])
def test_flash_ref_matches_jax_ref(case, dtype):
    (jq, jk_, jv), (q, k, v) = _flash_inputs(case, dtype, seed=2)
    got = ref.flash_attention_ref(q, k, v, **_kw(case))
    want = jk.flash_attention_ref(jq, jk_, jv, **_kw(case))
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("blocks_qk", [(8, 8), (16, 64), (128, 128)])
def test_flash_twin_is_independent_of_blocking(blocks_qk):
    """The twin's tiles change only the summation order (the kernel picks
    its own)."""
    case = FLASH_SWEEP[6]
    _, (q, k, v) = _flash_inputs(case, "float32", seed=3)
    want = ref.flash_attention_ref(q, k, v, **_kw(case))
    got = flash_attention_cuda.flash_attention_plain(
        q, k, v, block_q=blocks_qk[0], block_k=blocks_qk[1], **_kw(case))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_flash_twin_matches_port_attention_layer():
    """Counterpart of the reference's test_flash_matches_model_attention_layer:
    the twin against the port model's ``_sdpa`` (one node) with the
    window-16 mask, at float32 (the model's mask value and ours differ;
    both underflow to p = 0)."""
    B, S, KH, g, D = 1, 64, 2, 2, 32
    H = KH * g
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))
    pos = torch.arange(S)[None].expand(B, S)
    mask = tattn.attention_mask(pos, pos, causal=True, window=16)
    want = tattn._sdpa(q.reshape(1, B, S, KH, g, D), k[None], v[None], mask,
                       scale=D ** -0.5).reshape(B, S, H, D)
    got = ops.flash_attention_op(q, k, v, causal=True, window=16,
                                 block_q=16, block_k=16)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_flash_op_reads_strided_views():
    """q sliced from a wider tensor (strides of the (B, S, H) axes, unit
    stride on D) gives what its contiguous copy gives."""
    rng = np.random.default_rng(6)
    wide = torch.from_numpy(rng.standard_normal((2, 50, 6, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 50, 2, 16)).astype(
        np.float32))
    q = wide[:, :, 1:5]
    assert not q.is_contiguous()
    got = ops.flash_attention_op(q, k, k, window=8)
    want = ops.flash_attention_op(q.contiguous(), k, k, window=8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [0.0, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 64), (3, 7, 96), (1, 128), (5, 256)])
def test_rmsnorm_op_and_ref_match_jax(shape, dtype, offset):
    """The reference's rmsnorm sweep: the port's op (the twin) and oracle
    against the reference's oracle and its Pallas kernel (interpret)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    tol = 1e-5 if dtype == "float32" else 1e-2
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(w)
    want = jk.rmsnorm_ref(jx, jnp.asarray(w), offset=offset)
    kernel = jops.rmsnorm_op(jx, jnp.asarray(w), offset=offset, block_rows=4,
                             interpret=True)
    got = ops.rmsnorm_op(tx, tw, offset=offset, block_rows=4)
    oracle = ref.rmsnorm_ref(tx, tw, offset=offset)
    for out in (got, oracle):
        assert out.dtype == tdt and out.shape == tx.shape
        _close(out, want, tol)
        _close(out, kernel, tol)


@pytest.mark.parametrize("case", [(1, 37, 2, 8, 16, 8), (2, 64, 2, 16, 16,
                                                         16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_chunk_op_matches_jax(case, dtype):
    """Two cases of the reference's MLSTM_SWEEP: the port's op (h only)
    against the reference's op (interpret) and both oracles."""
    B, S, nh, dk, dv, chunk = case
    rng = np.random.default_rng(8)
    jdt, tdt, _ = DTYPES[dtype]
    q = (rng.standard_normal((B, S, nh, dk)) / np.sqrt(dk)).astype(
        np.float32)
    k = rng.standard_normal((B, S, nh, dk)).astype(np.float32)
    v = rng.standard_normal((B, S, nh, dv)).astype(np.float32)
    li = (2.0 * rng.standard_normal((B, S, nh))).astype(np.float32)
    lf = np.array(jax.nn.log_sigmoid(
        (2.0 * rng.standard_normal((B, S, nh))).astype(np.float32)))
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, k, v)] + [
        jnp.asarray(li), jnp.asarray(lf)]
    targs = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + [
        torch.from_numpy(li), torch.from_numpy(lf)]
    tol = 5e-5 if dtype == "float32" else 3e-2
    got = ops.mlstm_chunk_op(*targs, chunk=chunk)
    want = jops.mlstm_chunk_op(*jargs, chunk=chunk, interpret=True)
    assert got.dtype == tdt and got.shape == (B, S, nh, dv)
    for a, b in ((got, want), (ref.mlstm_chunk_ref(*targs),
                               jk.mlstm_chunk_ref(*jargs))):
        np.testing.assert_allclose(np.asarray(a.float()),
                                   np.asarray(jnp.asarray(b, jnp.float32)),
                                   atol=tol, rtol=10 * tol)


def test_softcap_matches_jax():
    x = np.random.default_rng(9).standard_normal(1000).astype(np.float32)
    x *= 200.0
    got = softcap(torch.from_numpy(x), 50.0)
    want = jax_softcap(jnp.asarray(x), 50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    assert softcap(torch.from_numpy(x), None) is not None
    assert torch.equal(softcap(torch.from_numpy(x), None),
                       torch.from_numpy(x))


def test_ops_on_cpu_take_the_twins_and_count_no_launch():
    _, (q, k, v) = _flash_inputs(FLASH_SWEEP[0], "float32", seed=10)
    x = torch.randn(6, 32)
    w = torch.randn(32)
    fa, rn = flash_attention_cuda.flash_attention, rmsnorm_cuda.rmsnorm

    def launches():
        return (fa.launches, fa.wgmma_launches, rn.launches,
                rn.vector_launches, mlstm_cuda.mlstm_chunk.launches,
                mlstm_cuda.mlstm_chunk.wgmma_launches)

    before = launches()
    assert torch.equal(ops.flash_attention_op(q, k, v),
                       flash_attention_cuda.flash_attention_plain(q, k, v))
    assert torch.equal(ops.flash_attention_op(q.bfloat16(), k.bfloat16(),
                                              v.bfloat16()),
                       flash_attention_cuda.flash_attention_plain(
                           q.bfloat16(), k.bfloat16(), v.bfloat16()))
    assert torch.equal(ops.rmsnorm_op(x, w), rmsnorm_cuda.rmsnorm_plain(x, w))
    assert before == (0, 0, 0, 0, 0, 0)
    assert launches() == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_unsupported_dtypes_raise(dtype):
    q = torch.zeros((1, 8, 2, 16), dtype=dtype)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention_op(q, q, q)
    with pytest.raises(ValueError, match="must be one of"):
        ops.rmsnorm_op(torch.zeros((4, 16), dtype=dtype), torch.ones(16))
    with pytest.raises(ValueError, match="float32 or x's dtype"):
        ops.rmsnorm_op(torch.zeros((4, 16), dtype=torch.bfloat16),
                       torch.ones(16, dtype=torch.float16))


def test_other_devices_raise_and_never_take_the_twin():
    q = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention_op(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rmsnorm_op(torch.zeros((4, 16), device="meta"),
                       torch.ones(16, device="meta"))


@pytest.mark.parametrize("D,need", [(12, 66_176), (64, 66_176),
                                    (128, 115_328), (160, 140_416),
                                    (256, 140_416), (257, None),
                                    (512, None)])
def test_head_dim_past_shared_memory_raises(D, need):
    """The fp32 kernel's tiles by head-dim bucket: q (64 rows), k and v
    (64 kv rows at D padded to 64 or 128, 32 at 256) and p in fp32, each
    skewed by 16 bytes a row group: 66,176, 115,328 and 140,416 bytes.
    D = 256 is the widest head it takes; past it the wrapper raises before
    any launch."""
    if need is None:
        with pytest.raises(ValueError, match="shared memory"):
            flash_attention_cuda.check_smem(D)
    else:
        assert flash_attention_cuda.check_smem(D) == need


@pytest.mark.parametrize("D_pad,bk,threads,blocks", [(64, 64, 128, 3),
                                                     (128, 64, 128, 2),
                                                     (256, 32, 256, 1)])
def test_simt_tiles(D_pad, bk, threads, blocks):
    """csrc/flash_attention.cu's ``Tile<D_pad>``, mirrored: kv rows a
    tile, threads a block (a row group of 8 lanes for every 4 query rows,
    2 at D_pad = 256), the tiles' floats with one 16-byte skew a row group
    (8 lanes' keys for k), and the blocks a multiprocessor holds by shared
    memory (the H100's 228 KB an SM, 1 KB of it reserved for each
    block)."""
    fa = flash_attention_cuda
    assert fa.SIMT_TILES[D_pad][:2] == (bk, threads)
    assert fa.block_k(D_pad) == bk
    rows_a_lane = fa.SIMT_TILES[D_pad][2]
    assert fa.BLOCK_Q // rows_a_lane * 8 == threads
    need = fa.smem_bytes(D_pad)
    assert need == 4 * (fa.BLOCK_Q * D_pad + 4 * (fa.BLOCK_Q // rows_a_lane)
                        + bk * D_pad + 4 * 8 + bk * D_pad
                        + fa.BLOCK_Q * bk + 4 * (fa.BLOCK_Q // rows_a_lane))
    assert need <= cuda_build.MAX_SMEM
    per_sm = 228 * 1024
    assert blocks * (need + 1024) <= per_sm < (blocks + 1) * (need + 1024)


@pytest.mark.parametrize("D_pad,need", [(64, 83_072), (128, 164_992),
                                        (256, 197_760)])
def test_wgmma_smem_bytes(D_pad, need):
    """csrc/flash_attention_wgmma.cu's smem_bytes, mirrored: Q (128 rows)
    and a ring of K and V tiles (four stages of 64 rows at D_pad = 64, two
    of 128 at 128, two of 64 at 256) in 16-bit, 1024 bytes of alignment and
    128 of barriers, within the card's budget (twice at D_pad = 64, whose
    blocks run two a multiprocessor)."""
    assert flash_attention_cuda.wgmma_smem_bytes(D_pad) == need
    blocks = 2 if D_pad == 64 else 1
    assert blocks * need <= cuda_build.MAX_SMEM
    bk = flash_attention_cuda.wgmma_block_k(D_pad)
    stages = flash_attention_cuda.wgmma_stages(D_pad)
    assert need == 1024 + 128 + 2 * D_pad * (128 + 2 * stages * bk)


@pytest.mark.parametrize("D,D_pad", [(8, 64), (64, 64), (72, 128),
                                     (128, 128), (160, 256), (256, 256)])
def test_head_dim_pad(D, D_pad):
    assert flash_attention_cuda.head_dim_pad(D) == D_pad


def _qkv(dtype, D, B=2, S=24, H=4, KH=2):
    return (torch.zeros((B, S, H, D), dtype=dtype),
            torch.zeros((B, S, KH, D), dtype=dtype),
            torch.zeros((B, S, KH, D), dtype=dtype))


@pytest.mark.parametrize("D", [8, 64, 160, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_use_wgmma_takes_16bit_aligned_heads(dtype, D):
    assert flash_attention_cuda.use_wgmma(*_qkv(dtype, D))


@pytest.mark.parametrize("case", ["fp32", "D12", "D264", "misaligned view",
                                  "misaligned pointer"])
def test_use_wgmma_leaves_the_rest_to_the_fp32_kernel(case):
    """fp32, a head dim that is not a multiple of 8 or past 256, a view
    whose (B, S, H) strides are not 16-byte multiples, a pointer off 16
    bytes: all take csrc/flash_attention.cu."""
    if case == "fp32":
        qkv = _qkv(torch.float32, 64)
    elif case == "D12":
        qkv = _qkv(torch.bfloat16, 12)
    elif case == "D264":
        qkv = _qkv(torch.bfloat16, 264)
    elif case == "misaligned view":
        wide = torch.zeros((2, 24, 6, 20), dtype=torch.bfloat16)
        qkv = (wide[..., :16], wide[:, :, :2, :16], wide[:, :, 2:4, :16])
        assert qkv[0].stride(2) * 2 == 40
    else:
        flat = torch.zeros(2 * 24 * 4 * 64 + 8, dtype=torch.bfloat16)
        q = flat[8:].view(2, 24, 4, 64)
        q_off = flat[1:1 + q.numel()].view(2, 24, 4, 64)
        assert q.data_ptr() % 16 == 0 and q_off.data_ptr() % 16 == 2
        _, k, v = _qkv(torch.bfloat16, 64)
        assert flash_attention_cuda.use_wgmma(q, k, v)
        qkv = (q_off, k, v)
    assert not flash_attention_cuda.use_wgmma(*qkv)


@pytest.mark.parametrize("shape,dtype,w_dtype,want", [
    ((8, 64), torch.bfloat16, torch.float32, True),
    ((16, 768), torch.bfloat16, torch.float32, True),
    ((4, 3584), torch.bfloat16, torch.bfloat16, True),
    ((3, 96), torch.float32, torch.float32, True),
    ((5, 256), torch.float16, torch.float32, True),
    ((4, 4096), torch.bfloat16, torch.float32, True),    # 8192 bytes a row
    ((4, 4104), torch.bfloat16, torch.float32, False),   # past the widest
    ((7, 100), torch.bfloat16, torch.float32, False),    # 200-byte rows
    ((6, 2050), torch.float32, torch.float32, False),    # 8200-byte rows
])
def test_use_vector_rule(shape, dtype, w_dtype, want):
    x2 = torch.zeros(shape, dtype=dtype)
    w = torch.zeros(shape[-1], dtype=w_dtype)
    assert rmsnorm_cuda.use_vector(x2, w) is want


def test_use_vector_refuses_misaligned_rows_and_pointers():
    wide = torch.zeros((8, 100), dtype=torch.bfloat16)
    rows = wide[:, :96]          # 192-byte rows 200 bytes apart
    assert rows.stride(0) * 2 == 200
    assert not rmsnorm_cuda.use_vector(rows, torch.zeros(96))
    flat = torch.zeros(8 * 64 + 8, dtype=torch.bfloat16)
    assert rmsnorm_cuda.use_vector(flat[8:].view(8, 64), torch.zeros(64))
    assert not rmsnorm_cuda.use_vector(flat[1:513].view(8, 64),
                                       torch.zeros(64))
    wflat = torch.zeros(65)
    assert not rmsnorm_cuda.use_vector(flat[8:].view(8, 64), wflat[1:])


def _emulate_wgmma(q, k, v, *, causal, window, softcap, scale=None):
    """The tensor-core kernel's arithmetic on the CPU: the fp32 twin's
    online softmax at the kernel's tiles (128 query rows, ``wgmma_block_k``
    keys), with p rounded to q's type before p·v and l summed from the
    fp32 p."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    g = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    bk = flash_attention_cuda.wgmma_block_k(
        flash_attention_cuda.head_dim_pad(D))
    qf = q.float().reshape(B, Sq, KH, g, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    out = torch.zeros((B, KH, g, Sq, D))
    neg = flash_attention_cuda.NEG_INF
    for q0 in range(0, Sq, 128):
        q1 = min(q0 + 128, Sq)
        q_pos = torch.arange(q0, q1)[:, None]
        m = torch.full((B, KH, g, q1 - q0), neg)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KH, g, q1 - q0, D))
        lo, hi = flash_attention_cuda.kv_range(q0, q1, Sk, causal, window)
        for k0 in range(lo, hi, bk):
            k1 = min(k0 + bk, Sk)
            s = layers.softcap(qf[..., q0:q1, :] @ kf[..., k0:k1, :].transpose(
                -1, -2) * scale, softcap)
            k_pos = torch.arange(k0, k1)[None, :]
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool)
            if causal:
                mask &= k_pos <= q_pos
            if window is not None:
                mask &= k_pos > q_pos - window
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            acc = acc * alpha[..., None] + p.to(q.dtype).float() @ vf[
                ..., k0:k1, :]
            l = alpha * l + p.sum(dim=-1)
            m = m_new
        out[..., q0:q1, :] = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


WIDE_CASES = [(2, 300, 300, 4, 2, 256, True, None, 50.0, 128, 128),
              (1, 77, 200, 4, 1, 256, False, None, None, 128, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", FLASH_SWEEP + [MASKED_ROWS] + WIDE_CASES)
def test_wgmma_rounding_emulation_holds_the_card_tolerance(case, dtype):
    """The check the card run holds the tensor-core kernel to, applied to
    its rounding emulated here: within ``wgmma_tolerance`` of the fp32
    twin, and an RMS error against the float64 twin at most
    ``WGMMA_RMS_RATIO`` times the fp32 twin's rounded to q's type
    (measured 1.07-1.29)."""
    B, Sq, Sk, H, KH, D = case[:6]
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype) for s in ((B, Sq, H, D), (B, Sk, KH, D),
                                         (B, Sk, KH, D)))
    twin = flash_attention_cuda.flash_attention_plain(q, k, v, **_kw(case))
    exact = flash_attention_cuda.flash_attention_plain(
        q.double(), k.double(), v.double(), **_kw(case))
    got = _emulate_wgmma(q, k, v, **_kw(case))
    atol, rtol = flash_attention_cuda.wgmma_tolerance(v)
    torch.testing.assert_close(got.float(), twin.float(), atol=atol,
                               rtol=rtol)
    ratio = flash_attention_cuda.rms_ratio(got, twin, exact)
    assert ratio <= flash_attention_cuda.WGMMA_RMS_RATIO, ratio
    if case is MASKED_ROWS:
        assert torch.equal(got[:, 20:], torch.zeros_like(got[:, 20:]))


@pytest.mark.parametrize("launcher", ["flash_simt", "flash_wgmma",
                                      "rmsnorm_scalar", "rmsnorm_vector",
                                      "mlstm_simt", "mlstm_wgmma"])
def test_direct_launchers_refuse_cpu_operands(launcher):
    """The launchers of one kernel (which chip_smoke times directly) take
    CUDA operands only: a CPU tensor raises before anything launches."""
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    x2, w = torch.zeros((4, 64), dtype=torch.bfloat16), torch.ones(64)
    gate = torch.zeros((1, 8, 2))
    module = {"flash": flash_attention_cuda, "rmsnorm": rmsnorm_cuda,
              "mlstm": mlstm_cuda}[launcher.split("_")[0]]
    fn = getattr(module, launcher)
    with pytest.raises(ValueError, match="CUDA"):
        if module is rmsnorm_cuda:
            fn(x2, w)
        elif module is mlstm_cuda:
            fn(q, q, q, gate, gate)
        else:
            fn(q, q, q)
    assert mlstm_cuda.mlstm_chunk.launches == 0
    assert mlstm_cuda.mlstm_chunk.wgmma_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [12, 64, 160, 256])
def test_flash_simt_refuses_cpu_operands_and_counts_nothing(dtype, D):
    """csrc/flash_attention.cu's launcher takes CUDA operands only, at
    every head dim its tiles take: a CPU q raises before anything
    launches, and no launch is counted."""
    q = torch.zeros((1, 8, 2, D), dtype=dtype)
    before = (flash_attention_cuda.flash_attention.launches,
              flash_attention_cuda.flash_attention.wgmma_launches)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda.flash_simt(q, q, q)
    assert (flash_attention_cuda.flash_attention.launches,
            flash_attention_cuda.flash_attention.wgmma_launches) == before


def test_kv_range_skips_only_masked_tiles():
    """Every key outside ``kv_range`` is masked for every query of the
    tile, and ``kv_range`` is no wider than the unmasked keys need."""
    Sq, Sk = 70, 90
    q_pos = torch.arange(Sq)[:, None]
    k_pos = torch.arange(Sk)[None, :]
    for causal in (True, False):
        for window in (None, 1, 7, 200):
            mask = torch.ones((Sq, Sk), dtype=torch.bool)
            if causal:
                mask &= k_pos <= q_pos
            if window is not None:
                mask &= k_pos > q_pos - window
            for q0 in range(0, Sq, 16):
                q1 = min(q0 + 16, Sq)
                lo, hi = flash_attention_cuda.kv_range(q0, q1, Sk, causal,
                                                       window)
                cols = mask[q0:q1].any(dim=0).nonzero().flatten()
                if len(cols):
                    assert lo <= int(cols.min()) and hi > int(cols.max())
                    assert lo == int(cols.min()) or lo == 0
                    assert hi == int(cols.max()) + 1 or hi == Sk


def test_kernels_package_exports_the_references_names():
    names = {"flash_attention_op", "rmsnorm_op", "mlstm_chunk_op",
             "flash_attention_ref", "rmsnorm_ref", "mlstm_chunk_ref",
             "fused_step_mix", "global_average", "mix_residual",
             "pod_average"}
    assert names <= set(dir(jk))
    assert names <= set(dir(tk))


@pytest.mark.parametrize("variant", ["full", "reduced"])
def test_gemma2_config_matches_reference(variant):
    kw = {"full": {}, "reduced": dict(reduced=True)}[variant]
    got = get_model_config("gemma2-9b", **kw)
    want = jax_config("gemma2-9b", **kw)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_gemma2_model_is_refused():
    """Since the dense features (ROADMAP A.8, first bullet) the gemma2-9b
    model builds, full and reduced; its reduced model runs a forward with
    logits under the final softcap.  Since the blocked path, attention
    at S ≥ 8192 runs too: an input of zeros attends uniformly, so the
    attention's output is zero."""
    for cfg in (get_model_config("gemma2-9b"),
                get_model_config("gemma2-9b", reduced=True)):
        blocks.check_supported(cfg)
        assert make_model(cfg).cfg == cfg
    model = make_model(get_model_config("gemma2-9b", reduced=True))
    from repro_torch.tree import tree_map
    node = tree_map(lambda t: t[None],
                    model.init(torch.Generator().manual_seed(0), "cpu"))
    logits, _, _ = model.forward(
        node, {"inputs": torch.zeros((1, 2, 5), dtype=torch.int32)})
    assert logits.shape == (1, 2, 5, 512)
    assert float(logits.abs().max()) < 30.0
    x = torch.zeros((1, 1, 8192, 256))
    out, cache = tattn.attn_forward(tree_map(lambda t: t[:, 0],
                                             node["stack"]["scan"]
                                             ["entry_1"]["mixer"]),
                                    model.cfg, x, layer_kind="attn")
    assert out.shape == x.shape and cache["k"].shape == (1, 1, 8192, 2, 64)
    assert float(out.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# The ctypes rows of the C entry points
# ---------------------------------------------------------------------------
_C_SCALARS = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint,
              "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _c_entry_points() -> dict:
    """``{symbol: (library, argtypes)}`` parsed from every ``extern "C"
    int repro_*(...)`` in ``csrc/*.cu``: a pointer is a c_void_p, a scalar
    its ctypes type."""
    found = {}
    for path in sorted(cuda_build.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C" int (repro_\w+)\(([^)]*)\)',
                             path.read_text()):
            types = []
            for param in m.group(2).split(","):
                words = param.replace("const", " ").split()
                if "*" in param:
                    types.append(ctypes.c_void_p)
                else:
                    types.append(_C_SCALARS[" ".join(words[:-1])])
            found[m.group(1)] = (path.stem, types)
    return found


@pytest.mark.parametrize("name", sorted(cuda_build.ENTRY_POINTS))
def test_entry_point_rows_match_the_c_signatures(name):
    """Each ``cuda_build.ENTRY_POINTS`` row names its source's library and
    has the C function's arity, with c_void_p for every pointer and
    c_longlong for every long long: a 64-bit argument passed as a 32-bit
    int would be cut without a word."""
    library, symbol, argtypes = cuda_build.ENTRY_POINTS[name]
    found = _c_entry_points()
    assert symbol in found, f"{symbol} is in no csrc/*.cu"
    assert found[symbol][0] == library
    assert argtypes == found[symbol][1]


def test_every_c_entry_point_has_a_row():
    assert set(_c_entry_points()) == {
        symbol for _, symbol, _ in cuda_build.ENTRY_POINTS.values()}
    assert set(cuda_build.LIBRARIES) == {
        p.stem for p in cuda_build.CSRC.glob("*.cu")}
