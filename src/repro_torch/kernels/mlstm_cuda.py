"""Chunkwise mLSTM forward — the port of ``repro/kernels/mlstm_chunk.py``.

:func:`mlstm_chunk` launches one of two hand-written CUDA kernels
(``_mlstm_kernel``'s counterparts) for CUDA tensors and takes its plain
twin :func:`mlstm_chunk_plain` for CPU tensors.  Both return ``(h, (C, n,
m))``: h ``(B, S, nh, dv)`` in q's dtype and the final state ``C (B, nh,
dk, dv)``, ``n (B, nh, dk)``, ``m (B, nh)`` in float32, the quantity the
reference's ``_mlstm_chunk_scan`` returns for the decode hand-off.  The
twin is :func:`chunkwise`, the routine the reference scan's port
(``models.ssm._mlstm_chunk_scan``) also runs, at another chunk length and
with the scan's bf16 rounding.

Which kernel a CUDA call launches is one rule, :func:`use_wgmma`, decided
after a tensor whose last stride is not 1 is made contiguous:

* ``csrc/mlstm_wgmma.cu`` (counted in ``mlstm_chunk.wgmma_launches``) for
  bf16 q, k, v at the kernel's chunk length 64 (or one chunk of at most 64
  positions), dk and dv multiples of 8 up to 256, and views TMA takes: the
  four products on the tensor cores (``wgmma``), tiles by TMA.  It rounds
  P and C to bf16 before their products and carries the state's operand
  k·kg as three bf16 terms (:data:`WGMMA_UNIT`, :func:`wgmma_excess`);
* ``csrc/mlstm.cu`` (counted in ``mlstm_chunk.launches``) for everything
  else: float32 (fp32 FMAs; TF32 or bf16 products would break its gates),
  other chunk lengths and widths, and views TMA refuses.  Everything inside
  is float32: q, k, v are cast on load.

Nothing falls back from one kernel to the other: a launch error raises.

The chunk length follows the TPU kernel's rule ``max(min(chunk, S), 8)``
(the scan's is ``min(chunk, S)``); positions past S get ``log i = -1e9``
and ``log f = 0``, which leaves the state untouched.  The reference kernel
has no gradient, so neither version takes inputs that require one.  The
kernels are built on first use by :mod:`repro_torch.kernels.cuda_build`;
importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_build

NEG_BIG = -1e9
MAX_CHUNK = 128          # csrc/mlstm.cu's kMaxChunk
SIMT_TILE_V = 32         # csrc/mlstm.cu's kTileV: v columns a block
SIMT_PIECE = 32          # csrc/mlstm.cu's kPiece: dk columns at a time
SIMT_MAX_CLUSTER = 8     # csrc/mlstm.cu's kMaxCluster
WGMMA_CHUNK = 64         # csrc/mlstm_wgmma.cu's kL
_DTYPES = (torch.float32, torch.bfloat16)

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def chunk_len(chunk: int, S: int) -> int:
    """The TPU kernel's chunk length for a sequence of S positions."""
    return max(min(chunk, S), 8)


def _check(q, k, v, log_i, log_f, chunk: int) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"mlstm_chunk: q, k (B, S, nh, dk) and v "
                         f"(B, S, nh, dv) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if log_i.shape != q.shape[:3] or log_f.shape != q.shape[:3]:
        raise ValueError("mlstm_chunk: log_i and log_f must be (B, S, nh)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mlstm_chunk: q, k, v must share one dtype of "
                         f"{_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if log_i.dtype != torch.float32 or log_f.dtype != torch.float32:
        raise ValueError("mlstm_chunk: log_i and log_f must be float32")
    devices = {t.device for t in (q, k, v, log_i, log_f)}
    if len(devices) != 1:
        raise ValueError(f"mlstm_chunk: operands on several devices "
                         f"{devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mlstm_chunk: unsupported device {q.device}")
    if any(t.requires_grad for t in (q, k, v, log_i, log_f)):
        raise ValueError("mlstm_chunk: the chunkwise kernel has no gradient "
                         "(nor has the reference's); use the scan")
    if chunk < 1 or q.shape[1] < 1:
        raise ValueError("mlstm_chunk: chunk and S must be >= 1")


def chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_i: torch.Tensor, log_f: torch.Tensor, L: int, *,
              low: Optional[torch.dtype] = None, error_scale: bool = False,
              wgmma: bool = False):
    """The chunkwise mLSTM in PyTorch at chunk length L: the body of both
    the kernel's plain twin (:func:`mlstm_chunk_plain`) and the reference's
    scan (``models.ssm._mlstm_chunk_scan``).  Returns ``(h, (C, n, m))``.

    It accumulates in float32, or in float64 for float64 q (the exact-as-
    can-be yardstick ``chip_smoke.py`` holds the kernel to); F is a double
    cumsum rounded to that type, as the kernel sums it.  ``low`` rounds the
    intra-chunk scores, probabilities and h_intra to that dtype where the
    reference's bf16 einsums round them (the scan; the kernel does not).
    ``wgmma`` rounds as ``csrc/mlstm_wgmma.cu`` does: P and C to bf16
    before P·V and q·C, and the state's operand k·kg as three bf16 terms
    (the tensor-core instance's arithmetic, for the CPU tests).

    ``error_scale`` appends, per element of h, the magnitude its rounding
    error scales with: ``(Σ_τ |p_tτ| |v_τj| + Σ_i |q_ti| |C|_ij s_t
    + |h_tj| (Σ_τ |p_tτ| + Σ_i |q_ti| |n|_i s_t)) / den_t``, with
    ``|p| = (|q|·|k|ᵀ) · gate`` and ``|C|``, ``|n|`` the state carried on
    ``|k|``, ``|v|``.  It is about |h| where nothing cancels and far above
    it in rows whose numerator or denominator cancels."""
    B, S, nh, dk = q.shape
    dv = v.shape[-1]
    nc = -(-S // L)
    pad = nc * L - S
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    dev = q.device

    def heads_major(t):
        # (B, S, nh, …) -> (B, nh, nc, L, …), zero padded past S
        t = t.to(acc)
        if pad:
            t = torch.cat([t, t.new_zeros((B, pad) + t.shape[2:])], dim=1)
        t = t.reshape((B, nc, L) + t.shape[2:])
        return t.movedim(3, 1)

    def rounded(t):
        return t if low is None else t.to(low).to(acc)

    def bf16(t):
        return t.to(torch.bfloat16).to(acc) if wgmma else t

    qc, kc, vc = heads_major(q), heads_major(k), heads_major(v)
    valid = (torch.arange(nc * L, device=dev) < S).reshape(nc, L)
    li = torch.where(valid, heads_major(log_i), NEG_BIG)
    F = torch.cumsum(heads_major(log_f).double(), dim=-1).to(acc)
    tril = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
    C = torch.zeros((B, nh, dk, dv), dtype=acc, device=dev)
    n = torch.zeros((B, nh, dk), dtype=acc, device=dev)
    m = torch.full((B, nh), NEG_BIG, dtype=acc, device=dev)
    C_abs, n_abs = C.clone(), n.clone()
    hs, scales = [], []
    for c in range(nc):
        qi, ki, vi, lic, Fc = (t[:, :, c] for t in (qc, kc, vc, li, F))
        w = Fc[..., :, None] - Fc[..., None, :] + lic[..., None, :]
        w = torch.where(tril, w, -torch.inf)
        m_in = m[..., None] + Fc
        m_t = torch.maximum(w.amax(dim=-1), m_in)
        gates = torch.where(tril, torch.exp(w - m_t[..., None]), 0.0)
        probs = rounded(qi @ ki.transpose(-1, -2)) * gates
        sgate = torch.exp(m_in - m_t)
        den_state = (qi @ n[..., None])[..., 0] * sgate
        den = torch.maximum(torch.abs(probs.sum(dim=-1) + den_state),
                            torch.exp(-m_t))
        h_state = (qi @ bf16(C)) * sgate[..., None]
        h_c = (rounded(rounded(bf16(probs)) @ vi) + h_state) / den[..., None]
        hs.append(h_c)
        F_L = Fc[..., -1]
        w_end = F_L[..., None] - Fc + lic
        m_end = torch.maximum(w_end.amax(dim=-1), m + F_L)
        kg = torch.exp(w_end - m_end[..., None])
        decay = torch.exp(m + F_L - m_end)
        kw = ki * kg[..., None]
        if wgmma:   # k·kg as bf16 hi + mid + lo, each remainder exact
            C, rest = C * decay[..., None, None], kw
            for _ in range(3):
                part = bf16(rest)
                C = C + part.transpose(-1, -2) @ vi
                rest = rest - part
        else:
            C = C * decay[..., None, None] + kw.transpose(-1, -2) @ vi
        n = n * decay[..., None] + kw.sum(dim=-2)
        m = m_end
        if error_scale:
            aq, ak, av = qi.abs(), ki.abs(), vi.abs()
            p_abs = (aq @ ak.transpose(-1, -2)) * gates
            num = p_abs @ av + (aq @ C_abs) * sgate[..., None]
            den_abs = p_abs.sum(dim=-1) + (aq @ n_abs[..., None])[..., 0] \
                * sgate
            scales.append((num + h_c.abs() * den_abs[..., None])
                          / den[..., None])
            akw = ak * kg[..., None]
            C_abs = C_abs * decay[..., None, None] \
                + akw.transpose(-1, -2) @ av
            n_abs = n_abs * decay[..., None] + akw.sum(dim=-2)

    def seq_major(parts):                       # -> (B, S, nh, dv)
        t = torch.stack(parts, dim=2)           # (B, nh, nc, L, dv)
        return t.movedim(1, 3).reshape(B, nc * L, nh, dv)[:, :S]

    out = (seq_major(hs).to(q.dtype), (C, n, m))
    return out + (seq_major(scales),) if error_scale else out


def mlstm_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_i: torch.Tensor, log_f: torch.Tensor, *,
                      chunk: int = 64, error_scale: bool = False):
    """The kernel's function in PyTorch: :func:`chunkwise` at the kernel's
    chunk length, without the scan's rounding."""
    return chunkwise(q, k, v, log_i, log_f, chunk_len(chunk, q.shape[1]),
                     error_scale=error_scale)


def _smem_bytes(dk: int, L: int) -> int:
    """csrc/mlstm.cu's ``smem_bytes``: C[:, tile] and n with dk padded to
    :data:`SIMT_PIECE`, the q and k pieces (rows of SIMT_PIECE + 4), the v
    tile and kg·v, P (L padded to 16 rows, rows of Lr + 4), seven per-row
    vectors and the four warps' shares of a piece's n update, in
    float32."""
    Lr = -(-L // 16) * 16
    dkp = -(-dk // SIMT_PIECE) * SIMT_PIECE
    return 4 * (dkp * (SIMT_TILE_V + 1) + 2 * Lr * (SIMT_PIECE + 4)
                + 2 * Lr * SIMT_TILE_V + Lr * (Lr + 4) + 7 * Lr
                + 4 * SIMT_PIECE)


def simt_grid(dv: int, max_cluster: int = SIMT_MAX_CLUSTER
              ) -> Tuple[int, int]:
    """csrc/mlstm.cu's ``cluster_shape``: ``(cluster size, grid.y)``.  A
    block owns :data:`SIMT_TILE_V` columns of v; the tiles of a (b, h)
    form clusters of equal size, at most ``max_cluster`` blocks, that
    share the chunk's score tiles (a cluster's spare block, where the
    tiles do not divide, only scores)."""
    tiles = -(-dv // SIMT_TILE_V)
    clusters = -(-tiles // max_cluster)
    cs = -(-tiles // clusters)
    return cs, clusters * cs


def simt_max_cluster(blocks: int, sms: int) -> int:
    """The cluster cap a call of csrc/mlstm.cu gets: :data:`SIMT_MAX_CLUSTER`
    when the grid's ``blocks`` (B · nh · ⌈dv / 32⌉) are at most one a
    multiprocessor (``sms`` of them), else 2.  Clusters of more blocks
    share more of the scores, but on a full card they leave slots empty:
    a cluster's blocks must sit in one GPC, and at the serving shape
    (384 blocks, three an SM) the H100 seats every pair at once but not
    every cluster of 6 or 3, whose last blocks then run as a second wave
    (``chip_smoke.py`` times the clusters of 6 there)."""
    return SIMT_MAX_CLUSTER if blocks <= sms else 2


def scan_cumsum(log_f: torch.Tensor) -> torch.Tensor:
    """F, the inclusive cumulative sum of float32 ``log_f (..., L)`` over
    its last axis, in csrc/mlstm.cu's order: lane l of a warp sums its
    positions l·per … l·per + per − 1 (per = ⌈L / 32⌉) left to right in
    double, the 32 lanes' totals are scanned by shuffles (step d adds lane
    l − d's running total to lane l's, d = 1, 2, 4, 8, 16), and each
    position adds the lanes before its own to its lane's running sum.
    Rounded to float32."""
    L = log_f.shape[-1]
    per = -(-L // 32)
    x = log_f.double()
    x = torch.cat([x, x.new_zeros(x.shape[:-1] + (32 * per - L,))], -1)
    x = x.reshape(x.shape[:-1] + (32, per))
    runs = [x[..., 0]]
    for j in range(1, per):
        runs.append(runs[-1] + x[..., j])
    s = torch.stack(runs, -1)                       # (..., 32, per)
    incl = s[..., -1].clone()
    lane = torch.arange(32, device=x.device)
    for d in (1, 2, 4, 8, 16):
        shifted = torch.cat([incl[..., :d], incl[..., :-d]], -1)
        incl = torch.where(lane >= d, incl + shifted, incl)
    excl = torch.cat([incl[..., :1], incl[..., :-1]], -1)
    F = torch.where((lane > 0)[:, None], excl[..., None] + s, s)
    return F.reshape(F.shape[:-2] + (32 * per,))[..., :L].float()


def max_simt_dk(L: int) -> int:
    """The widest dk csrc/mlstm.cu takes at chunk length L (a multiple of
    :data:`SIMT_PIECE`; the padded C rows grow with it)."""
    dk = SIMT_PIECE
    while _smem_bytes(dk + SIMT_PIECE, L) <= cuda_build.MAX_SMEM:
        dk += SIMT_PIECE
    return dk


def dk_pad(dk: int) -> int:
    """csrc/mlstm_wgmma.cu's dk_pad: dk padded (in shared memory only) to
    64, 128 or 256."""
    return 64 if dk <= 64 else 128 if dk <= 128 else 256


def wgmma_smem_bytes(dk_pad: int) -> int:
    """csrc/mlstm_wgmma.cu's ``smem_bytes``: two stages of the bf16 Q, K
    (64 × dk_pad) and V (64 × 64) tiles, the bf16 Cᵀ tile (64 × dk_pad) and
    h tile (64 × 64), n, each of four warps' F, log i and kg, two
    mbarriers, and 1024 bytes of alignment slack."""
    return (1024 + 2 * (2 * dk_pad * 128 + 8192) + dk_pad * 128 + 8192
            + 4 * dk_pad + 4 * 3 * 64 * 4 + 16)


# The tensor-core instance's roundings beyond the fp32 twin's: P and C,
# each rounded once to bf16 before P·V and q·C, each add at most
# 2^-9·(Σ_u |p||v| or Σ_i |q||C|·sgate)/den to an element of h, within 2^-9
# of the twin's error scale (``chunkwise(error_scale=True)``).  So its h is
# held, element by element, to |h − ref| ≤ 8e-3·|ex| + (WGMMA_UNIT +
# acc)·(|ex| + scale): ex the float64 twin, 8e-3 one bf16 ulp of h,
# acc = 1e-5 against the float64 twin (ref = ex) and 2e-5 against the fp32
# twin, mlstm.cu's float32 allowances.  Its state operand k·kg goes in as
# three bf16 terms hi + mid + lo (each remainder exact, the rest at most
# 2^-27·|k·kg|), so C, n and m keep mlstm.cu's gate, max abs error ≤
# 1e-5·max|ref|: with a hi + lo pair (2^-18 of each term) the emulated C
# came within a small factor of that gate, with three terms it keeps the
# twin's own float32 error.  The CPU emulation (``chunkwise(wgmma=True)``,
# tests/test_torch_ssm.py) holds both gates.
WGMMA_UNIT = 2.0 ** -8
H_ULP = 8e-3


def wgmma_excess(h: torch.Tensor, ref: torch.Tensor, ex: torch.Tensor,
                 scale: torch.Tensor, acc: float) -> torch.Tensor:
    """Per element of h, ``|h − ref| − 8e-3·|ex| − (WGMMA_UNIT + acc)·(|ex|
    + scale)`` in float64: positive where the tensor-core instance's h is
    outside its gate."""
    h, ref, ex = h.double(), ref.double(), ex.double()
    return ((h - ref).abs() - H_ULP * ex.abs()
            - (WGMMA_UNIT + acc) * (ex.abs() + scale.double()))


def use_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              L: int) -> bool:
    """Whether a CUDA call on these operands at chunk length L (the
    :func:`chunk_len` of the call) launches the tensor-core instance: bf16
    q, k, v; L = 64 or a single chunk of S ≤ 64 positions (padded to 64,
    the same rows and end state); dk and dv multiples of 8, at most 256; a
    unit stride on the last axis, every stride of the (B, S, nh) axes
    times 2 bytes a positive multiple of 16, and 16-byte aligned data
    pointers (what TMA takes).  Pure: reads dtypes, shapes, strides and
    pointers only."""
    S, dk, dv = q.shape[1], q.shape[-1], v.shape[-1]
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return False
    if not (L == WGMMA_CHUNK or (S <= L and S <= WGMMA_CHUNK)):
        return False
    if dk % 8 or dv % 8 or dk > 256 or dv > 256:
        return False
    for t in (q, k, v):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                s <= 0 or s * 2 % 16 for s in t.stride()[:3]):
            return False
    return True


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_i: torch.Tensor, log_f: torch.Tensor, *,
                chunk: int = 64) -> Tuple[torch.Tensor, State]:
    """Chunkwise mLSTM: ``(h, (C, n, m))``.  A CUDA q launches exactly one
    kernel, the one :func:`use_wgmma` picks, or raises; a CPU q takes
    :func:`mlstm_chunk_plain`."""
    _check(q, k, v, log_i, log_f, chunk)
    if q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, log_i, log_f, chunk=chunk)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if use_wgmma(q, k, v, chunk_len(chunk, q.shape[1])):
        return mlstm_wgmma(q, k, v, log_i, log_f, chunk=chunk)
    return mlstm_simt(q, k, v, log_i, log_f, chunk=chunk)


def _launch(lib: str, q, k, v, log_i, log_f, *extra):
    _check(q, k, v, log_i, log_f, 1)
    if q.device.type != "cuda" or any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{lib}: CUDA operands with a unit stride on the "
                         f"last axis expected")
    B, S, nh, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    h = torch.empty((B, S, nh, dv), dtype=q.dtype, device=dev)
    C = torch.empty((B, nh, dk, dv), dtype=torch.float32, device=dev)
    n = torch.empty((B, nh, dk), dtype=torch.float32, device=dev)
    m = torch.empty((B, nh), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (q, k, v, log_i, log_f) for s in t.stride()[:3]))
    err = cuda_build.entry(lib)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
        log_f.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
        m.data_ptr(), ctypes.addressof(strides), B, S, nh, dk, dv, *extra,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"repro_torch: {lib} kernel launch failed with "
                           f"error {err}")
    return h, (C, n, m)


def mlstm_simt(q, k, v, log_i, log_f, *, chunk: int = 64,
               max_cluster: Optional[int] = None
               ) -> Tuple[torch.Tensor, State]:
    """Launch ``csrc/mlstm.cu`` (fp32 FMAs, float32 or bf16 q, k, v) on
    CUDA operands with a unit stride on the last axis; counted in
    ``mlstm_chunk.launches``.  ``max_cluster`` caps the v tiles that share
    a chunk's scores (:func:`simt_grid`): :func:`simt_max_cluster` by
    default, 1 for every block scoring the whole chunk itself (the layout
    ``chip_smoke.py`` times the clusters against).  Shapes past the
    kernel's shared memory raise ValueError before anything is
    launched."""
    dk, S = q.shape[-1], q.shape[1]
    L = chunk_len(chunk, S)
    if L > MAX_CHUNK or _smem_bytes(dk, L) > cuda_build.MAX_SMEM:
        raise ValueError(f"mlstm kernel: chunk {L} with dk={dk} needs "
                         f"{_smem_bytes(dk, L)} bytes of shared memory per "
                         f"block (at most {cuda_build.MAX_SMEM}, chunk <= "
                         f"{MAX_CHUNK})")
    if max_cluster is not None and not 1 <= max_cluster <= SIMT_MAX_CLUSTER:
        raise ValueError(f"mlstm kernel: max_cluster {max_cluster} outside "
                         f"1 .. {SIMT_MAX_CLUSTER}")
    if max_cluster is None and q.device.type == "cuda":
        blocks = q.shape[0] * q.shape[2] * -(-v.shape[-1] // SIMT_TILE_V)
        max_cluster = simt_max_cluster(blocks, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
    out = _launch("mlstm", q, k, v, log_i, log_f, L,
                  int(q.dtype == torch.bfloat16), max_cluster)
    mlstm_chunk.launches += 1
    return out


def mlstm_wgmma(q, k, v, log_i, log_f, *, chunk: int = 64
                ) -> Tuple[torch.Tensor, State]:
    """Launch ``csrc/mlstm_wgmma.cu`` on CUDA operands that
    :func:`use_wgmma` accepts at this chunk (raises otherwise); counted in
    ``mlstm_chunk.wgmma_launches``."""
    if q.device.type != "cuda":
        raise ValueError("mlstm_wgmma: CUDA operands expected")
    if not use_wgmma(q, k, v, chunk_len(chunk, q.shape[1])):
        raise ValueError("mlstm_wgmma: operands outside use_wgmma's rule")
    out = _launch("mlstm_wgmma", q, k, v, log_i, log_f)
    mlstm_chunk.wgmma_launches += 1
    return out


mlstm_chunk.launches = 0
mlstm_chunk.wgmma_launches = 0
