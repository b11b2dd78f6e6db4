"""Chunkwise mLSTM forward — the port of ``repro/kernels/mlstm_chunk.py``.

:func:`mlstm_chunk` launches the hand-written CUDA kernel
``repro_torch/csrc/mlstm.cu`` (``_mlstm_kernel``'s counterpart) for CUDA
tensors, counting each launch in ``mlstm_chunk.launches``, and takes its
plain twin :func:`mlstm_chunk_plain` for CPU tensors.  Both return
``(h, (C, n, m))``: h ``(B, S, nh, dv)`` in q's dtype and the final state
``C (B, nh, dk, dv)``, ``n (B, nh, dk)``, ``m (B, nh)`` in float32, the
quantity the reference's ``_mlstm_chunk_scan`` returns for the decode
hand-off.  Everything inside is float32: q, k, v are cast on load.  The
twin is :func:`chunkwise`, the routine the reference scan's port
(``models.ssm._mlstm_chunk_scan``) also runs, at another chunk length and
with the scan's bf16 rounding.

The chunk length follows the TPU kernel's rule ``max(min(chunk, S), 8)``
(the scan's is ``min(chunk, S)``); positions past S get ``log i = -1e9``
and ``log f = 0``, which leaves the state untouched.  The reference kernel
has no gradient, so neither version takes inputs that require one.  The
kernel is built on first use by :mod:`repro_torch.kernels.cuda_build`;
importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_build

NEG_BIG = -1e9
MAX_CHUNK = 128          # csrc/mlstm.cu's kMaxChunk
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
              low: Optional[torch.dtype] = None, error_scale: bool = False):
    """The chunkwise mLSTM in PyTorch at chunk length L: the body of both
    the kernel's plain twin (:func:`mlstm_chunk_plain`) and the reference's
    scan (``models.ssm._mlstm_chunk_scan``).  Returns ``(h, (C, n, m))``.

    It accumulates in float32, or in float64 for float64 q (the exact-as-
    can-be yardstick ``chip_smoke.py`` holds the kernel to); F is a double
    cumsum rounded to that type, as the kernel sums it.  ``low`` rounds the
    intra-chunk scores, probabilities and h_intra to that dtype where the
    reference's bf16 einsums round them (the scan; the kernel does not).

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
        h_state = (qi @ C) * sgate[..., None]
        h_c = (rounded(rounded(probs) @ vi) + h_state) / den[..., None]
        hs.append(h_c)
        F_L = Fc[..., -1]
        w_end = F_L[..., None] - Fc + lic
        m_end = torch.maximum(w_end.amax(dim=-1), m + F_L)
        kg = torch.exp(w_end - m_end[..., None])
        decay = torch.exp(m + F_L - m_end)
        kw = ki * kg[..., None]
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
    """csrc/mlstm.cu's ``smem_bytes``."""
    return 4 * (dk * 64 + dk + 2 * L * (dk + 1) + L * 64 + L * (L + 1)
                + 6 * L + 2)


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_i: torch.Tensor, log_f: torch.Tensor, *,
                chunk: int = 64) -> Tuple[torch.Tensor, State]:
    """Chunkwise mLSTM: ``(h, (C, n, m))``.  A CUDA q launches
    ``mlstm.cu`` (counted in ``mlstm_chunk.launches``) or raises; a CPU q
    takes :func:`mlstm_chunk_plain`."""
    _check(q, k, v, log_i, log_f, chunk)
    if q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, log_i, log_f, chunk=chunk)
    B, S, nh, dk = q.shape
    dv = v.shape[-1]
    L = chunk_len(chunk, S)
    if L > MAX_CHUNK or _smem_bytes(dk, L) > cuda_build.MAX_SMEM:
        raise ValueError(f"mlstm kernel: chunk {L} with dk={dk} needs "
                         f"{_smem_bytes(dk, L)} bytes of shared memory per "
                         f"block (at most {cuda_build.MAX_SMEM}, chunk <= "
                         f"{MAX_CHUNK})")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    dev = q.device
    h = torch.empty((B, S, nh, dv), dtype=q.dtype, device=dev)
    C = torch.empty((B, nh, dk, dv), dtype=torch.float32, device=dev)
    n = torch.empty((B, nh, dk), dtype=torch.float32, device=dev)
    m = torch.empty((B, nh), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (q, k, v, log_i, log_f) for s in t.stride()[:3]))
    err = cuda_build.entry("mlstm")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
        log_f.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
        m.data_ptr(), ctypes.addressof(strides), B, S, nh, dk, dv, L,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"repro_torch: mlstm kernel launch failed with "
                           f"cudaError {err}")
    mlstm_chunk.launches += 1
    return h, (C, n, m)


mlstm_chunk.launches = 0
