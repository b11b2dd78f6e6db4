"""Port parity: the xLSTM mixers and the chunkwise mLSTM kernel's plain
twin, JAX vs ``repro_torch`` on the CPU.

Inputs are made with numpy from a seed; weights are drawn by the JAX
package and carried across with ``repro_torch.interop``.  Every JAX kernel
call runs the Pallas kernel in interpret mode.

Tolerances (each stated where it is used):
* kernel twin vs the Pallas kernel: the JAX kernel test's own, atol 5e-5
  and rtol 5e-4 at float32, atol 3e-2 and rtol 0.3 at bf16 q/k/v (the h
  output is rounded to bf16 on both sides);
* final state (C, n, m) and float32 mixers: max abs error ≤ 2e-5 · max|ref|
  (measured ≤ 3e-6: the same math, sums in another order, F summed in
  double by the twin);
* bf16 mixers: the port rounds where the reference rounds, but matmuls and
  casts fuse differently, so outputs agree to a few bf16 ulps: max abs
  error ≤ 3e-2 · max|ref| (measured ≤ 1.1e-2);
* the tensor-core kernel's arithmetic (``csrc/mlstm_wgmma.cu``: P and C
  rounded to bf16, k·kg as three bf16 terms), emulated by
  ``chunkwise(wgmma=True)``: the gates the card run holds it to,
  ``mlstm_cuda.wgmma_excess`` ≤ 0 element by element, |h − ref| ≤
  8e-3·|ex| + (2^-8 + acc)·(|ex| + scale), acc 1e-5 against the float64
  twin and 2e-5 against the fp32 twin and the Pallas kernel; the state
  within 1e-5 · max|ref| and m bit for bit; at model-scale gates
  max|h − ex| ≤ 8e-3 · max|ex|.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_model_config as jax_config
from repro.kernels.ops import mlstm_chunk_op as jax_mlstm_chunk_op
from repro.models import ssm as jssm
from repro_torch import interop
from repro_torch.configs import get_model_config
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import cuda_build, mlstm_cuda
from repro_torch.models import blocks
from repro_torch.models import ssm as tssm
from repro_torch.models.model import make_model
from repro_torch.tree import tree_map

torch.set_num_threads(2)

MLSTM_SWEEP = [
    # B, S, nh, dk, dv, chunk: the JAX kernel test's sweep, and a prompt
    # shorter than the kernel's minimum chunk of 8
    (1, 37, 2, 8, 16, 8),
    (2, 64, 2, 16, 16, 16),
    (1, 100, 3, 8, 8, 32),
    (2, 16, 1, 4, 4, 16),
    (1, 6, 2, 8, 16, 64),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(case, dtype: str, seed=0, gate_scale=2.0):
    """numpy q, k, v (rounded to ``dtype``), log_i, log_f as the JAX kernel
    test draws them."""
    B, S, nh, dk, dv, _ = case
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dtype][0]

    def rnd(x):
        return np.asarray(jnp.asarray(x, jnp.float32).astype(jdt))

    q = rnd(rng.standard_normal((B, S, nh, dk)) / np.sqrt(dk))
    k = rnd(rng.standard_normal((B, S, nh, dk)))
    v = rnd(rng.standard_normal((B, S, nh, dv)))
    li = (gate_scale * rng.standard_normal((B, S, nh))).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(
        (gate_scale * rng.standard_normal((B, S, nh))).astype(np.float32)))
    return q, k, v, li, lf


def _to_jax(arrays, dtype):
    jdt = DTYPES[dtype][0]
    q, k, v, li, lf = arrays
    return ([jnp.asarray(t).astype(jdt) for t in (q, k, v)]
            + [jnp.asarray(li), jnp.asarray(lf)])


def _to_torch(arrays, dtype):
    tdt = DTYPES[dtype][1]
    q, k, v, li, lf = arrays
    return ([torch.from_numpy(np.array(t, np.float32)).to(tdt)
             for t in (q, k, v)]
            + [torch.from_numpy(np.array(li)), torch.from_numpy(np.array(lf))])


_jax_scan = jax.jit(jssm._mlstm_chunk_scan, static_argnums=5)


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * max(scale, 1e-30), (err, scale)


# ---------------------------------------------------------------------------
# (a), (b): the kernel's plain twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", MLSTM_SWEEP, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_pallas_kernel(case, dtype):
    """h of the twin (through the wrapper ``mlstm_chunk`` on CPU tensors)
    against the Pallas kernel in interpret mode; the JAX kernel test's
    tolerance."""
    arrays = _inputs(case, dtype)
    chunk = case[-1]
    want = jax_mlstm_chunk_op(*_to_jax(arrays, dtype), chunk=chunk,
                              interpret=True)
    got, _ = mlstm_cuda.mlstm_chunk(*_to_torch(arrays, dtype), chunk=chunk)
    assert got.dtype == DTYPES[dtype][1]
    tol = 5e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol,
                               rtol=10 * tol)


@pytest.mark.parametrize("case", MLSTM_SWEEP, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_state_matches_scan_state(case, dtype):
    """The twin's final (C, n, m) is the reference scan's state: float32
    on both sides from the same (bf16-rounded) inputs, 2e-5 · max|ref|."""
    arrays = _inputs(case, dtype, seed=1)
    chunk = case[-1]
    _, (C, n, m) = _jax_scan(*_to_jax(arrays, dtype), chunk)
    _, state = mlstm_cuda.mlstm_chunk_plain(*_to_torch(arrays, dtype),
                                            chunk=chunk)
    for got, want in zip(state, (C, n, m)):
        assert got.dtype == torch.float32
        _close(got, want, 2e-5)


def test_twin_agrees_with_recurrent_oracle_on_wide_gates():
    """Wide gates (log i ~ 5·N(0, 2²)) drive the stabilizer hard: the twin
    still matches the step-by-step oracle (2e-5 · max|ref| on h)."""
    case = (2, 50, 2, 8, 16, 16)
    q, k, v, li, lf = _to_torch(_inputs(case, "float32", seed=2), "float32")
    li = 5 * li
    h, _ = mlstm_cuda.mlstm_chunk_plain(q, k, v, li, lf, chunk=16)
    _close(h, tssm.mlstm_recurrent_reference(q, k, v, li, lf)[0], 2e-5)


@pytest.mark.parametrize("gate_scale", [1.0, 10.0])
def test_error_scale_bounds_the_float32_error(gate_scale):
    """``error_scale`` (the yardstick ``chip_smoke.py`` holds the kernel's
    h to): the float32 twin stays within 1e-5 · (|h| + scale) of the
    float64 twin element by element, the scale is at least |h| for most
    elements, and a 1e-3 error in h fails the bound somewhere."""
    case = (2, 100, 3, 16, 16, 32)
    q, k, v, li, lf = _to_torch(_inputs(case, "float32", seed=7,
                                        gate_scale=gate_scale), "float32")
    h, _ = mlstm_cuda.mlstm_chunk_plain(q, k, v, li, lf, chunk=32)
    ex, _, scale = mlstm_cuda.mlstm_chunk_plain(
        *(t.double() for t in (q, k, v, li, lf)), chunk=32, error_scale=True)
    assert scale.shape == ex.shape and bool((scale >= 0).all())
    unit = ex.abs() + scale
    assert float(((h.double() - ex).abs() / unit).max()) <= 1e-5
    assert float(((1.001 * h.double() - ex).abs() / unit).max()) > 1e-5
    assert float((scale / ex.abs().clamp_min(1e-300)).median()) >= 1.0


def test_chunk_rule_is_the_kernels():
    """The twin's chunk length is the TPU kernel's max(min(chunk, S), 8),
    not the scan's min(chunk, S)."""
    assert mlstm_cuda.chunk_len(64, 6) == 8
    assert mlstm_cuda.chunk_len(64, 2048) == 64
    assert mlstm_cuda.chunk_len(16, 37) == 16


def test_wrapper_takes_twin_on_cpu_and_counts_no_launch():
    """On CPU tensors the wrapper is the twin, also for bf16 operands that
    ``use_wgmma`` would give the tensor-core instance; no count moves."""
    fn = mlstm_cuda.mlstm_chunk
    before = (fn.launches, fn.wgmma_launches)
    for case, dtype, chunk in ((MLSTM_SWEEP[0], "float32", 8),
                               (MLSTM_SWEEP[4], "bfloat16", 64)):
        arrays = _to_torch(_inputs(case, dtype), dtype)
        h, state = mlstm_cuda.mlstm_chunk(*arrays, chunk=chunk)
        h2, state2 = mlstm_cuda.mlstm_chunk_plain(*arrays, chunk=chunk)
        assert torch.equal(h, h2)
        assert all(torch.equal(a, b) for a, b in zip(state, state2))
    assert mlstm_cuda.use_wgmma(*arrays[:3], 8)
    assert (fn.launches, fn.wgmma_launches) == before == (0, 0)


def test_wrapper_rejects_gradients_and_bad_operands():
    q, k, v, li, lf = _to_torch(_inputs(MLSTM_SWEEP[0], "float32"),
                                "float32")
    with pytest.raises(ValueError, match="no gradient"):
        mlstm_cuda.mlstm_chunk(q.requires_grad_(True), k, v, li, lf,
                               chunk=8)
    q = q.detach()
    with pytest.raises(ValueError, match="one dtype"):
        mlstm_cuda.mlstm_chunk(q.double(), k, v, li, lf, chunk=8)
    with pytest.raises(ValueError, match="float32"):
        mlstm_cuda.mlstm_chunk(q, k, v, li.double(), lf, chunk=8)
    with pytest.raises(ValueError, match="unsupported device"):
        mlstm_cuda.mlstm_chunk(*(t.to("meta") for t in (q, k, v, li, lf)),
                               chunk=8)


# ---------------------------------------------------------------------------
# The tensor-core kernel's rule and arithmetic (csrc/mlstm_wgmma.cu)
# ---------------------------------------------------------------------------
# the sweep case use_wgmma takes (one chunk of 6), a ragged one, and the
# full width (xlstm-125m: nh 8, dk 96, dv 192) over 200 positions
WGMMA_CASES = [MLSTM_SWEEP[4], (2, 130, 2, 16, 24, 64),
               (1, 200, 8, 96, 192, 64)]


def _wide(case, seed, gates="wide"):
    """bf16 q, k, v and float32 gates, drawn as chip_smoke.py draws them:
    wide (log i ~ 10·N(0, 1), log f = logsigmoid(2·N(0, 1))) or at the
    model's scale (log i ~ N(0, 1), log f = logsigmoid(3 + N(0, 1)))."""
    B, S, nh, dk, dv, _ = case
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q = (draw(B, S, nh, dk) / np.sqrt(dk)).bfloat16()
    k, v = draw(B, S, nh, dk).bfloat16(), draw(B, S, nh, dv).bfloat16()
    if gates == "wide":
        li, lf = 10 * draw(B, S, nh), F.logsigmoid(2 * draw(B, S, nh))
    else:
        li, lf = draw(B, S, nh), F.logsigmoid(3 + draw(B, S, nh))
    return q, k, v, li, lf


def _emulate(args):
    return mlstm_cuda.chunkwise(*args, mlstm_cuda.WGMMA_CHUNK, wgmma=True)


@pytest.mark.parametrize("gates", ["wide", "model"])
@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_wgmma_emulation_holds_the_card_gates(case, gates):
    """The tensor-core instance's roundings, emulated, against the fp32
    and float64 twins under the gates chip_smoke.py applies on the card:
    h element by element (``wgmma_excess`` ≤ 0 with acc 1e-5 against
    float64, 2e-5 against float32), the state within 1e-5 · max|ref|, m
    bit for bit, and at model-scale gates max|h − ex| ≤ 8e-3 · max|ex|."""
    args = _wide(case, seed=12, gates=gates)
    assert mlstm_cuda.use_wgmma(*args[:3], mlstm_cuda.chunk_len(64,
                                                                case[1]))
    h, state = _emulate(args)
    twin, tstate = mlstm_cuda.mlstm_chunk_plain(*args)
    ex, _, scale = mlstm_cuda.mlstm_chunk_plain(
        *(t.double() for t in args), error_scale=True)
    assert h.dtype == torch.bfloat16 and bool(torch.isfinite(h).all())
    assert float(mlstm_cuda.wgmma_excess(h, ex, ex, scale, 1e-5).max()) <= 0
    assert float(mlstm_cuda.wgmma_excess(h, twin, ex, scale,
                                         2e-5).max()) <= 0
    for got, want in zip(state, tstate):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    assert torch.equal(state[2], tstate[2])
    if gates == "model":
        err = float((h.double() - ex).abs().max())
        assert err <= 8e-3 * float(ex.abs().max())


def test_wgmma_gates_catch_an_error():
    """The gates have teeth at the serving width with model-scale gates:
    h scaled by 1 + 2^-6 fails max|h − ex| ≤ 8e-3 · max|ex|, h one
    allowance past ex fails ``wgmma_excess``, and C scaled by 1 + 1e-4
    fails the state gate.  (The element gate alone is loose where the
    error scale is far above |h|, rows whose numerator cancels.)"""
    args = _wide(WGMMA_CASES[2], seed=13, gates="model")
    h, state = _emulate(args)
    ex, xstate, scale = mlstm_cuda.mlstm_chunk_plain(
        *(t.double() for t in args), error_scale=True)
    bad = h.double() * (1 + 2.0 ** -6)
    assert float((bad - ex).abs().max()) > 8e-3 * float(ex.abs().max())
    tol = 8e-3 * ex.abs() + (mlstm_cuda.WGMMA_UNIT + 1e-5) * (ex.abs()
                                                              + scale)
    assert float(mlstm_cuda.wgmma_excess(ex + 1.01 * tol, ex, ex, scale,
                                         1e-5).min()) > 0
    C_bad = state[0] * (1 + 1e-4)
    assert float((C_bad - xstate[0]).abs().max()) > 1e-5 * float(
        xstate[0].abs().max())


@pytest.mark.parametrize("case", [MLSTM_SWEEP[4], MLSTM_SWEEP[1]], ids=str)
def test_wgmma_emulation_matches_pallas_kernel(case):
    """The emulation (one chunk of 64 rows for these S ≤ 64) against the
    JAX Pallas kernel in interpret mode at the case's own chunk, bf16 q,
    k, v: within the h gate against the fp32 twin (acc 2e-5), ex the
    float64 twin."""
    arrays = _inputs(case, "bfloat16", seed=14)
    chunk = case[-1]
    want = jax_mlstm_chunk_op(*_to_jax(arrays, "bfloat16"), chunk=chunk,
                              interpret=True)
    args = _to_torch(arrays, "bfloat16")
    h, _ = _emulate(args)
    ex, _, scale = mlstm_cuda.mlstm_chunk_plain(
        *(t.double() for t in args), chunk=chunk, error_scale=True)
    jh = torch.from_numpy(np.array(_f32(want)))
    assert float(mlstm_cuda.wgmma_excess(h, jh, ex, scale, 2e-5).max()) <= 0


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("what,want", [
    ("bf16 full width", True), ("float32", False), ("float16", False),
    ("L 32", False), ("one chunk of 6", True), ("S 37 at L 16", False),
    ("one chunk of 64 at L 16", False), ("dk 4", False), ("dk 264", False),
    ("dv 200", True), ("dv 12", False), ("head-major views", True),
    ("misaligned head stride", False), ("misaligned pointer", False),
    ("non-unit last stride", False)])
def test_use_wgmma_rule(what, want):
    """``use_wgmma``: bf16 only, chunk 64 or a single chunk of S ≤ 64,
    dk and dv multiples of 8 up to 256, strides and pointers TMA takes."""
    B, S, nh, dk, dv, L = 2, 128, 4, 96, 192, 64
    q, k, v = _bf16(B, S, nh, dk), _bf16(B, S, nh, dk), _bf16(B, S, nh, dv)
    if what in ("float32", "float16"):
        q, k, v = (t.to(getattr(torch, what)) for t in (q, k, v))
    elif what == "L 32":
        L = 32
    elif what in ("one chunk of 6", "S 37 at L 16",
                  "one chunk of 64 at L 16"):
        S = {"one chunk of 6": 6, "S 37 at L 16": 37,
             "one chunk of 64 at L 16": 64}[what]
        L = mlstm_cuda.chunk_len(64 if S == 6 else 16, S)
        q, k, v = q[:, :S], k[:, :S], v[:, :S]
    elif what.startswith("dk"):
        dk = int(what.split()[1])
        q, k = _bf16(B, S, nh, dk), _bf16(B, S, nh, dk)
    elif what.startswith("dv"):
        v = _bf16(B, S, nh, int(what.split()[1]))
    elif what == "head-major views":   # (B, nh, S, d) buffers as (B, S, nh, d)
        q, k = (_bf16(B, nh, S, dk).transpose(1, 2) for _ in range(2))
        v = _bf16(B, nh, S, dv).transpose(1, 2)
    elif what == "misaligned head stride":   # heads of a width-100 buffer
        q = _bf16(B, S, nh, 100)[..., :dk]
    elif what == "misaligned pointer":
        q = _bf16(B * S * nh * dk + 8).flatten()[1:][:B * S * nh * dk].view(
            B, S, nh, dk)
    elif what == "non-unit last stride":
        q = _bf16(B, S, nh, dk, 2)[..., 0]
    assert mlstm_cuda.use_wgmma(q, k, v, L) is want


@pytest.mark.parametrize("dk,pad", [(8, 64), (64, 64), (96, 128),
                                    (128, 128), (200, 256), (256, 256)])
def test_wgmma_smem_bytes(dk, pad):
    """csrc/mlstm_wgmma.cu's smem_bytes, mirrored: within the card's
    232,448 bytes a block at every dk_pad, and two blocks a multiprocessor
    (2 × (bytes + 1 KB reserved) ≤ 233,472) at dk_pad ≤ 128, the serving
    shape's."""
    assert mlstm_cuda.dk_pad(dk) == pad
    need = mlstm_cuda.wgmma_smem_bytes(pad)
    assert need == (1024 + 2 * (2 * pad * 128 + 8192) + pad * 128 + 8192
                    + 4 * pad + 3072 + 16)
    assert need <= 232_448
    assert (2 * (need + 1024) <= 233_472) == (pad <= 128)


# ---------------------------------------------------------------------------
# The fp32 kernel's layout, grid rule and F order (csrc/mlstm.cu)
# ---------------------------------------------------------------------------
_MLSTM_CU = (Path(mlstm_cuda.__file__).resolve().parent.parent / "csrc"
             / "mlstm.cu").read_text()


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _MLSTM_CU)
               .group(1))


def _old_smem_bytes(dk, L):
    """The first version's smem_bytes: every operand in shared memory."""
    return 4 * (dk * 64 + dk + 2 * L * (dk + 1) + L * 64 + L * (L + 1)
                + 6 * L + 2)


@pytest.mark.parametrize("dk,L,need", [(96, 64, 67_200), (13, 8, 15_168),
                                       (255, 64, 88_320),
                                       (100, 128, 158_208)])
def test_simt_smem_bytes(dk, L, need):
    """csrc/mlstm.cu's smem_bytes and constants, mirrored: C[:, tile] and n
    (dk padded to 32), the q and k pieces (rows of 36 floats), the v tile
    and kg v, P (rows padded to 16, stride Lr + 4), seven per-row vectors
    and four warps' shares of a piece's n update; three blocks a
    multiprocessor (228 KB, 1 KB reserved for each block) at the serving
    shape (dk 96, L 64)."""
    assert (mlstm_cuda.SIMT_TILE_V, mlstm_cuda.SIMT_PIECE,
            mlstm_cuda.SIMT_MAX_CLUSTER, mlstm_cuda.MAX_CHUNK) == (
        _cu_const("kTileV"), _cu_const("kPiece"), _cu_const("kMaxCluster"),
        _cu_const("kMaxChunk"))
    assert "constexpr int kPieceStride = kPiece + 4;" in _MLSTM_CU
    Lr, dkp = -(-L // 16) * 16, -(-dk // 32) * 32
    assert mlstm_cuda._smem_bytes(dk, L) == need == 4 * (
        dkp * 33 + 2 * Lr * 36 + 2 * Lr * 32 + Lr * (Lr + 4) + 7 * Lr + 128)
    assert need <= cuda_build.MAX_SMEM
    if (dk, L) == (96, 64):
        assert 3 * (need + 1024) <= 228 * 1024 < 4 * (need + 1024)


def test_simt_takes_every_shape_the_first_version_took():
    """Every (dk, L) within the first version's shared memory fits the new
    layout, whose widest dk (a multiple of 32, the C rows grow with it) is
    far past the old one's 255 at L = 64 and 100 at L = 128."""
    for L in range(8, mlstm_cuda.MAX_CHUNK + 1):
        dk = 1
        while _old_smem_bytes(dk + 1, L) <= cuda_build.MAX_SMEM:
            dk += 1
        assert mlstm_cuda._smem_bytes(dk, L) <= cuda_build.MAX_SMEM, (dk, L)
        assert mlstm_cuda.max_simt_dk(L) >= dk
    assert mlstm_cuda.max_simt_dk(64) == 1344
    assert mlstm_cuda.max_simt_dk(128) == 672
    assert mlstm_cuda._smem_bytes(673, 128) > cuda_build.MAX_SMEM


@pytest.mark.parametrize("dv,max_cluster,want", [
    (192, 8, (6, 6)), (192, 2, (2, 6)), (192, 1, (1, 6)), (200, 8, (7, 7)),
    (200, 2, (2, 8)), (33, 8, (2, 2)), (16, 8, (1, 1)), (300, 8, (5, 10)),
    (1000, 8, (8, 32))])
def test_simt_grid(dv, max_cluster, want):
    """csrc/mlstm.cu's cluster_shape: 32-column v tiles, as many clusters
    as the cap needs, of equal size (a spare block where they do not
    divide, which only scores)."""
    cs, gy = mlstm_cuda.simt_grid(dv, max_cluster)
    assert (cs, gy) == want
    assert gy % cs == 0 and gy >= -(-dv // 32) > gy - cs


@pytest.mark.parametrize("blocks,want", [(48, 8), (132, 8), (133, 2),
                                         (384, 2)])
def test_simt_max_cluster(blocks, want):
    """The cluster cap: up to 8 while the grid has at most one block a
    multiprocessor (B = 1 at the serving width: 48 of 132), pairs on a
    fuller card (B = 8: 384 blocks)."""
    assert mlstm_cuda.simt_max_cluster(blocks, 132) == want


@pytest.mark.parametrize("what", ["chunk 200", "dk 673 at L 128",
                                  "max_cluster 9", "max_cluster 0"])
def test_simt_refuses_shapes_past_its_limits(what):
    """Past csrc/mlstm.cu's limits the launcher raises ValueError on its
    operands' shapes, before it looks at their device (CPU here) or
    launches anything; no launch is counted."""
    dk, S, chunk, kw = 8, 300, 64, {}
    if what == "chunk 200":
        chunk = 200
    elif what.startswith("dk"):
        dk, chunk = 673, 128
    else:
        kw["max_cluster"] = int(what.split()[1])
    q = torch.zeros((1, S, 1, dk))
    v, gate = torch.zeros((1, S, 1, 16)), torch.zeros((1, S, 1))
    before = (mlstm_cuda.mlstm_chunk.launches,
              mlstm_cuda.mlstm_chunk.wgmma_launches)
    with pytest.raises(ValueError, match="mlstm kernel"):
        mlstm_cuda.mlstm_simt(q, q, v, gate, gate, chunk=chunk, **kw)
    assert (mlstm_cuda.mlstm_chunk.launches,
            mlstm_cuda.mlstm_chunk.wgmma_launches) == before


@pytest.mark.parametrize("gates", ["wide", "model"])
@pytest.mark.parametrize("L", [8, 37, 64, 100, 128])
def test_scan_cumsum_is_the_twins_double_cumsum(L, gates):
    """F in csrc/mlstm.cu's order (each lane's positions in order, the
    lanes' totals by a shuffle scan; ``scan_cumsum``) rounds to the same
    float32 values as the twin's left-to-right double cumsum, bit for bit,
    on chip_smoke.py's wide and model-scale log f: the partial sums are
    exact in double in either order."""
    case = (64, L, 8, 4, 4, 64)
    log_f = _wide(case, seed=L, gates=gates)[4].movedim(1, -1)
    got = mlstm_cuda.scan_cumsum(log_f)
    want = torch.cumsum(log_f.double(), dim=-1).float()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


def test_scan_cumsum_follows_the_kernels_order():
    """Where the double sums are not exact the order shows.  Of 2^60,
    -2^60, 1, 1 left to right, F_3 = 2; in the kernel's order (one position
    a lane at L = 8) the scan's first step adds 1 to -2^60 and loses it,
    so F_3 = 1."""
    x = torch.tensor([[2.0 ** 60, -2.0 ** 60, 1.0, 1.0, 0, 0, 0, 0]])
    left = torch.cumsum(x.double(), dim=-1).float()
    got = mlstm_cuda.scan_cumsum(x)
    assert (float(left[0, 3]), float(got[0, 3])) == (2.0, 1.0)


# ---------------------------------------------------------------------------
# (c): the reference's scan and recurrent oracle, ported
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", MLSTM_SWEEP[:3], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_scan_matches_reference(case, dtype):
    """h and (C, n, m) of the port's scan against the reference's: 2e-5 ·
    max|ref| at float32; at bf16 the port rounds the scores and the
    probabilities to bf16 where the reference's einsums do, so h agrees to
    bf16 rounding (1e-2 · max|ref|) and the float32 state to 2e-5."""
    arrays = _inputs(case, dtype, seed=3)
    chunk = case[-1]
    jh, jstate = _jax_scan(*_to_jax(arrays, dtype), chunk)
    th, tstate = tssm._mlstm_chunk_scan(*_to_torch(arrays, dtype), chunk)
    assert th.dtype == DTYPES[dtype][1]
    _close(th, jh, 2e-5 if dtype == "float32" else 1e-2)
    for got, want in zip(tstate, jstate):
        _close(got, want, 2e-5)


def test_chunk_scan_rounds_where_the_reference_rounds():
    """At bf16 the reference's scan rounds the intra-chunk products, which
    the twin (float32 throughout, like the kernel) does not.  The port's
    scan reproduces the rounding: it lands nearer the reference's scan than
    the twin does."""
    case = (2, 64, 2, 16, 16, 16)
    arrays = _inputs(case, "bfloat16", seed=4)
    jh, _ = _jax_scan(*_to_jax(arrays, "bfloat16"), 16)
    th, _ = tssm._mlstm_chunk_scan(*_to_torch(arrays, "bfloat16"), 16)
    twin, _ = mlstm_cuda.mlstm_chunk_plain(*_to_torch(arrays, "bfloat16"),
                                           chunk=16)
    ref = _f32(jh)
    scan_err = np.abs(_f32(th) - ref).mean()
    twin_err = np.abs(_f32(twin) - ref).mean()
    assert scan_err < 0.5 * twin_err, (scan_err, twin_err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_reference_matches(dtype):
    arrays = _inputs((2, 23, 2, 8, 16, 8), dtype, seed=5)
    jh, jstate = jssm.mlstm_recurrent_reference(*_to_jax(arrays, dtype))
    th, tstate = tssm.mlstm_recurrent_reference(*_to_torch(arrays, dtype))
    _close(th, jh, 2e-5 if dtype == "float32" else 1e-2)
    for got, want in zip(tstate, jstate):
        _close(got, want, 2e-5)


# ---------------------------------------------------------------------------
# Hazards: conv precision, log-sigmoid
# ---------------------------------------------------------------------------
def test_causal_conv_is_full_float32():
    """The depthwise conv is an explicit 4-tap float32 sum (no cuDNN, so no
    TF32 on the card): it matches a float64 evaluation to float32 rounding
    (rtol 1e-6 of max|ref|) and the reference's conv to 2e-7 · max|ref|."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    xp = np.concatenate([np.zeros((2, 3, 5)), x.astype(np.float64)], axis=1)
    exact = sum(xp[:, j:j + 9] * w[j].astype(np.float64)
                for j in range(4)) + b
    got = tssm._causal_conv(*(torch.from_numpy(a)[None] for a in (x, w, b)))
    _close(got[0], exact, 1e-6)
    _close(got[0], jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b)), 2e-7)


def test_logsigmoid_matches_jax():
    """F.logsigmoid against jax.nn.log_sigmoid from -1e4 to 1e4, zero and
    denormals: relative error ≤ 2e-7 (a float32 ulp or so)."""
    x = np.concatenate([np.linspace(-100, 100, 4001),
                        [-1e4, -88.7, -20.0, 0.0, 1e-40, -1e-40, 20.0,
                         88.7, 1e4]]).astype(np.float32)
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)), np.float64)
    got = F.logsigmoid(torch.from_numpy(x)).numpy().astype(np.float64)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-30)


# ---------------------------------------------------------------------------
# (d): the mixers, forward and decode, at the reduced config
# ---------------------------------------------------------------------------
def _configs(dtype="float32", pallas=False):
    jc = jax_config("xlstm-125m", reduced=True)
    tc = get_model_config("xlstm-125m", reduced=True)
    jc = dataclasses.replace(jc, dtype=dtype, ssm=dataclasses.replace(
        jc.ssm, use_pallas_mlstm=pallas))
    tc = dataclasses.replace(tc, dtype=dtype, ssm=dataclasses.replace(
        tc.ssm, use_pallas_mlstm=pallas))
    return jc, tc


def _mixer(kind, jc, seed=0):
    init = {"mlstm": jssm.init_mlstm, "slstm": jssm.init_slstm}[kind]
    params, _ = init(jax.random.PRNGKey(seed), jc, jnp.float32)
    host = jax.device_get(params)
    node = jax.tree.map(lambda a: np.asarray(a)[None], host)
    return params, interop.from_numpy(node, "cpu")


def _x(dtype, shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x).astype(DTYPES[dtype][0]),
            torch.from_numpy(x).to(DTYPES[dtype][1])[None])


def _check_state(tstate, jstate, rel):
    assert sorted(tstate) == sorted(jstate)
    for name, want in jstate.items():
        got = tstate[name][0]
        assert got.dtype == {jnp.dtype(jnp.float32): torch.float32,
                             jnp.dtype(jnp.bfloat16): torch.bfloat16}[
            want.dtype], name
        _close(got, want, rel)


@pytest.mark.parametrize("dtype,pallas", [("float32", False),
                                          ("float32", True),
                                          ("bfloat16", False),
                                          ("bfloat16", True)])
def test_mlstm_forward_and_decode_match(dtype, pallas):
    """mlstm_forward (scan or kernel twin) then two decode steps, against
    the reference (its kernel in interpret mode).  The state keeps the
    reference's dtypes: C and n in the compute dtype, m in float32."""
    jc, tc = _configs(dtype, pallas)
    jp, tp = _mixer("mlstm", jc)
    rel = 2e-5 if dtype == "float32" else 3e-2
    jx, tx = _x(dtype, (2, 21, jc.d_model), 7)
    jout, jstate = jax.jit(jssm.mlstm_forward, static_argnums=1)(jp, jc, jx)
    tout, tstate = tssm.mlstm_forward(tp, tc, tx)
    _close(tout[0], jout, rel)
    _check_state(tstate, jstate, rel)
    # decode from the reference's state carried across, so each step
    # checks the decode alone
    tstate = {k: interop.from_numpy(np.asarray(jnp.asarray(v).astype(
        jnp.float32))[None], "cpu").to(tstate[k].dtype)
        for k, v in jstate.items()}
    for step in range(2):
        jx, tx = _x(dtype, (2, 1, jc.d_model), 8 + step)
        jout, jstate = jax.jit(jssm.mlstm_decode, static_argnums=1)(
            jp, jc, jx, jstate)
        tout, tstate = tssm.mlstm_decode(tp, tc, tx, tstate)
        _close(tout[0], jout, rel)
        _check_state(tstate, jstate, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_and_decode_match(dtype):
    jc, tc = _configs(dtype)
    jp, tp = _mixer("slstm", jc, seed=1)
    rel = 2e-5 if dtype == "float32" else 3e-2
    jx, tx = _x(dtype, (2, 13, jc.d_model), 9)
    jout, jstate = jax.jit(jssm.slstm_forward, static_argnums=1)(jp, jc, jx)
    tout, tstate = tssm.slstm_forward(tp, tc, tx)
    _close(tout[0], jout, rel)
    _check_state(tstate, jstate, rel)
    for step in range(2):
        jx, tx = _x(dtype, (2, 1, jc.d_model), 10 + step)
        jout, jstate = jax.jit(jssm.slstm_decode, static_argnums=1)(
            jp, jc, jx, jstate)
        tout, tstate = tssm.slstm_decode(tp, tc, tx, tstate)
        _close(tout[0], jout, rel)
        _check_state(tstate, jstate, rel)


def test_init_states_match_reference():
    jc, tc = _configs("bfloat16")
    for jinit, tinit in ((jssm.init_mlstm_state, tssm.init_mlstm_state),
                         (jssm.init_slstm_state, tssm.init_slstm_state)):
        want = jinit(jc, 3, jnp.bfloat16)
        got = tinit(tc, 3, torch.bfloat16, "cpu")
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape
            np.testing.assert_array_equal(_f32(got[name]), _f32(w))


# ---------------------------------------------------------------------------
# (h): what the port does not serve yet raises
# ---------------------------------------------------------------------------
def test_mamba_raises():
    """Mamba is ported (ROADMAP A.8): a pure Mamba LM of the ssm family
    builds, and its prefill's logits are the forward's with its
    ``{conv, h}`` states in the cache."""
    cfg = ModelConfig(name="m", family="ssm", citation="t", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
                      vocab_size=64, pattern=(("mamba", "none"),),
                      ssm=SSMConfig(), tie_embeddings=True, dtype="float32")
    model = make_model(cfg)
    node = tree_map(lambda t: t[None], model.init(
        torch.Generator().manual_seed(0), "cpu"))
    toks = {"inputs": torch.arange(10, dtype=torch.int32).reshape(1, 1, 10)}
    full, _, _ = model.forward(node, toks)
    pre, caches, _ = model.forward(node, toks, mode="prefill",
                                   want_cache=True)
    assert torch.equal(full, pre) and bool(torch.isfinite(full).all())
    state = caches["scan"]["entry_0"]
    assert sorted(state) == ["conv", "h"]
    assert state["h"].shape == (1, 2, 1, 128, 16)


def test_attention_decode_raises():
    """Attention decode is ported (ROADMAP A.9): the dense model's empty
    caches, its prefill cache and one decode step run, and a prefill
    without a cache is the plain forward."""
    model = make_model(get_model_config("pga-lm-100m", reduced=True))
    node = tree_map(lambda t: t[None], model.init(
        torch.Generator().manual_seed(0), "cpu"))
    empty = model.init_cache(2, 16, device="cpu")
    assert tuple(empty["scan"]["entry_0"]["k"].shape) == (1, 2, 2, 16, 4,
                                                          64)
    tokens = torch.zeros((1, 2, 4), dtype=torch.int32)
    full, caches, _ = model.forward(node, {"inputs": tokens},
                                    mode="prefill", want_cache=True)
    assert tuple(caches["scan"]["entry_0"]["v"].shape) == (1, 2, 2, 4, 4,
                                                           64)
    block = tree_map(lambda t: t[:, 0], node["stack"]["scan"]["entry_0"])
    cache = {k: torch.cat([t[:, 0], t.new_zeros((1, 2, 4, 4, 64))], dim=2)
             for k, t in caches["scan"]["entry_0"].items()}
    out, new, lb = blocks.apply_block(
        block, model.cfg, ("attn", "dense"),
        torch.zeros((1, 2, 1, 256), dtype=torch.bfloat16), mode="decode",
        cache=cache, pos=torch.full((2,), 4, dtype=torch.int32))
    assert new is cache and out.shape == (1, 2, 1, 256)
    assert lb is None
    assert bool(torch.isfinite(out).all())
    # a prefill without a cache is the plain forward
    logits, caches, _ = model.forward(node, {"inputs": tokens},
                                      mode="prefill")
    assert caches is None and logits.shape == (1, 2, 4, 512)
    assert torch.equal(logits, full)
