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
"""
import dataclasses

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
from repro_torch.models import blocks
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
    before = (flash_attention_cuda.flash_attention.launches,
              rmsnorm_cuda.rmsnorm.launches, mlstm_cuda.mlstm_chunk.launches)
    assert torch.equal(ops.flash_attention_op(q, k, v),
                       flash_attention_cuda.flash_attention_plain(q, k, v))
    assert torch.equal(ops.rmsnorm_op(x, w), rmsnorm_cuda.rmsnorm_plain(x, w))
    assert before == (0, 0, 0)
    assert (flash_attention_cuda.flash_attention.launches,
            rmsnorm_cuda.rmsnorm.launches,
            mlstm_cuda.mlstm_chunk.launches) == before


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


def test_head_dim_past_shared_memory_raises():
    """The kernel's tiles are fp32: D = 256 fits (209,664 bytes), D = 512
    does not, and the wrapper raises before any launch."""
    assert flash_attention_cuda.check_smem(256) == 209_664
    assert flash_attention_cuda.check_smem(64) == 87_040
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention_cuda.check_smem(512)


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
    for cfg in (get_model_config("gemma2-9b"),
                get_model_config("gemma2-9b", reduced=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
            blocks.check_supported(cfg)
        with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
            make_model(cfg)
