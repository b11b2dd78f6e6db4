"""Flash attention forward, the port of
``repro/kernels/flash_attention.py``.

:func:`flash_attention` launches one of two hand-written CUDA kernels
(``_flash_kernel``'s counterparts) for CUDA tensors and takes its plain
twin :func:`flash_attention_plain` for CPU tensors.  Both take q ``(B, Sq,
H, D)`` and k, v ``(B, Sk, KH, D)`` with ``H % KH == 0`` (query head h
reads kv head ``h // (H // KH)``) and return ``(B, Sq, H, D)`` in q's
dtype: online-softmax attention in float32 with causal masking, a sliding
window and the Gemma-2 logit softcap, positions of q and k both from 0,
rows with no valid key 0.

Which kernel a CUDA call launches is one rule, :func:`use_wgmma`, decided
after a tensor whose last stride is not 1 is made contiguous:

* ``csrc/flash_attention_wgmma.cu`` (counted in
  ``flash_attention.wgmma_launches``) for bf16 and fp16 q, k, v with
  ``D % 8 == 0``, ``D <= 256``, every (B, S, H) stride a positive multiple
  of 16 bytes and 16-byte aligned pointers: both products on the tensor
  cores (``wgmma``), tiles by TMA.  It rounds p to q's type before p·v,
  which the fp32 twin does not;
* ``csrc/flash_attention.cu`` (counted in ``flash_attention.launches``)
  for everything else: float32 (held to the reference's 2e-5, which a
  TF32 product cannot meet), other head dims and misaligned views.  Its
  fp32 tiles refuse ``D >= 285`` (:func:`check_smem`).

Nothing falls back from one kernel to the other: a launch error raises.

The twin computes what ``_flash_kernel`` computes, tile by tile in plain
PyTorch: ``block_q`` × ``block_k`` tiles by the TPU kernel's rule
``max(min(block, S), 8)``, the running ``(m, l, acc)`` per row with the
``-1e30`` sentinel, ``p`` zeroed where masked.  Results do not depend on
the blocking beyond summation order; the CUDA kernels pick their own tiles
(:func:`block_k`, :func:`wgmma_block_k`), so ``block_q`` and ``block_k``
set only the twin's blocking.  All skip the kv tiles wholly outside the
causal or window band, which is exact.  There is no gradient (the
reference kernel has none).  The kernels are built on first use by
:mod:`repro_torch.kernels.cuda_build`; importing this module builds
nothing.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_build
from repro_torch.models.layers import softcap as _softcap

NEG_INF = -1e30
BLOCK_Q = 64             # csrc/flash_attention.cu's kBlockQ
WGMMA_BLOCK_Q = 128      # csrc/flash_attention_wgmma.cu's kBlockQ
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: q (B, Sq, H, D) and k, v "
                         f"(B, Sk, KH, D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if min(q.shape) < 1 or k.shape[1] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: empty axis or H={q.shape[2]} "
                         f"not a multiple of KH={k.shape[2]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{tuple(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: operands on several devices "
                         f"{devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel has no gradient (nor "
                         "has the reference's)")


def kv_range(q0: int, q1: int, Sk: int, causal: bool,
             window: Optional[int]) -> Tuple[int, int]:
    """The keys ``[lo, hi)`` the mask may let through for the queries
    ``[q0, q1)``; every kv tile outside it is wholly masked."""
    lo = max(0, q0 - window + 1) if window is not None else 0
    hi = min(Sk, q1) if causal else Sk
    return lo, hi


def block_k(D: int) -> int:
    """csrc/flash_attention.cu's ``block_k``: kv rows per tile."""
    return 64 if D <= 128 else 32


def smem_bytes(D: int) -> int:
    """csrc/flash_attention.cu's ``smem_bytes``: fp32 tiles of q, k, v, p
    and acc."""
    bk = block_k(D)
    acc_ld = -(-D // 32) * 32 + 16
    return 4 * (BLOCK_Q * (D + 1) + 2 * bk * (D + 1) + BLOCK_Q * (bk + 1)
                + BLOCK_Q * acc_ld)


def check_smem(D: int) -> int:
    """The kernel's shared memory at head dim D; raises past the card's
    budget (``cuda_build.MAX_SMEM``)."""
    need = smem_bytes(D)
    if need > cuda_build.MAX_SMEM:
        raise ValueError(f"flash_attention kernel: head dim {D} needs {need} "
                         f"bytes of shared memory per block (at most "
                         f"{cuda_build.MAX_SMEM})")
    return need


def head_dim_pad(D: int) -> int:
    """csrc/flash_attention_wgmma.cu's D_pad: the head dim padded (in
    shared memory only) to 64, 128 or 256."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def wgmma_block_k(D_pad: int) -> int:
    """csrc/flash_attention_wgmma.cu's ``block_k``: kv rows per tile."""
    return 128 if D_pad == 128 else 64


def wgmma_stages(D_pad: int) -> int:
    """csrc/flash_attention_wgmma.cu's ``stages``: kv tiles in flight."""
    return 4 if D_pad == 64 else 2


def wgmma_smem_bytes(D_pad: int) -> int:
    """csrc/flash_attention_wgmma.cu's ``smem_bytes``: bf16/fp16 tiles of
    Q (128 rows) and of the K and V ring, 1024 bytes of alignment slack and
    128 of barriers."""
    return 1024 + 2 * D_pad * (WGMMA_BLOCK_Q + 2 * wgmma_stages(D_pad)
                               * wgmma_block_k(D_pad)) + 128


# The tensor-core kernel's one rounding beyond the fp32 twin's is p to q's
# type before p·v, wgmma's A operand.  Per output element it adds at most
# u·(Σ_j p_j |v_j|) / l <= u·max|v|, u the unit roundoff (2^-9 bf16, 2^-11
# fp16).  So against the fp32 twin: atol 1e-5 + u·max|v| and rtol one
# output ulp (2^-7, 2^-10), the twin's own rounding to q's type.  That
# worst case is loose, so the typical error is held too: the kernel's RMS
# error against the float64 twin, over the fp32 twin's (rounded to q's
# type), at most WGMMA_RMS_RATIO.  The CPU emulation of the kernel's
# rounding (tests/test_torch_kernels.py) gives 1.07-1.29 on the reference
# sweep and at D = 256.
WGMMA_RMS_RATIO = 1.5
_UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -9, torch.float16: 2.0 ** -11}
_OUTPUT_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def wgmma_tolerance(v: torch.Tensor) -> Tuple[float, float]:
    """``(atol, rtol)`` of the tensor-core kernel against the fp32 twin
    for values v (bf16 or fp16): ``1e-5 + u·max|v|`` and one output ulp."""
    u = _UNIT_ROUNDOFF[v.dtype]
    return 1e-5 + u * float(v.float().abs().max()), _OUTPUT_ULP[v.dtype]


def rms_ratio(out: torch.Tensor, twin: torch.Tensor,
              exact: torch.Tensor) -> float:
    """RMS(out − exact) / RMS(twin − exact), with ``exact`` the float64
    twin: how much larger the kernel's typical error is than the fp32
    twin's rounded to the same type (0 where both are exact)."""
    num = float((out.double() - exact).pow(2).mean().sqrt())
    den = float((twin.double() - exact).pow(2).mean().sqrt())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def use_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a CUDA call on these operands launches the tensor-core
    kernel: bf16 or fp16, ``D % 8 == 0`` and ``D <= 256``, a unit stride
    on D, every stride of the (B, S, H) axes times the item size a positive
    multiple of 16 bytes, and 16-byte aligned data pointers (what TMA
    takes).  Pure: reads dtypes, shapes, strides and pointers only."""
    D = q.shape[-1]
    if q.dtype not in (torch.bfloat16, torch.float16) or D % 8 or D > 256:
        return False
    for t in (q, k, v):
        size = t.element_size()
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                s <= 0 or s * size % 16 for s in t.stride()[:3]):
            return False
    return True


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          block_q: int = 128,
                          block_k: int = 128) -> torch.Tensor:
    """``_flash_kernel``'s blockwise online softmax in plain PyTorch, on
    q's device, in float32 (float64 for float64 q)."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    g = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    bq, bk = max(min(block_q, Sq), 8), max(min(block_k, Sk), 8)
    acc_t = torch.float64 if q.dtype == torch.float64 else torch.float32
    dev = q.device
    # (B, KH, g, S, D): the g query heads of a kv head batch over its k, v
    qf = q.to(acc_t).reshape(B, Sq, KH, g, D).permute(0, 2, 3, 1, 4)
    kf = k.to(acc_t).permute(0, 2, 1, 3)[:, :, None]
    vf = v.to(acc_t).permute(0, 2, 1, 3)[:, :, None]
    out = torch.zeros((B, KH, g, Sq, D), dtype=acc_t, device=dev)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        qt = qf[..., q0:q1, :]
        q_pos = torch.arange(q0, q1, device=dev)[:, None]
        m = torch.full((B, KH, g, q1 - q0), NEG_INF, dtype=acc_t, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KH, g, q1 - q0, D), dtype=acc_t, device=dev)
        lo, hi = kv_range(q0, q1, Sk, causal, window)
        for k0 in range(lo, hi, bk):
            k1 = min(k0 + bk, Sk)
            s = (qt @ kf[..., k0:k1, :].transpose(-1, -2)) * scale
            s = _softcap(s, softcap)
            k_pos = torch.arange(k0, k1, device=dev)[None, :]
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= k_pos <= q_pos
            if window is not None:
                mask &= k_pos > q_pos - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            acc = acc * alpha[..., None] + p @ vf[..., k0:k1, :]
            l = alpha * l + p.sum(dim=-1)
            m = m_new
        safe_l = torch.where(l > 0.0, l, 1.0)
        out[..., q0:q1, :] = acc / safe_l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Flash attention forward.  A CUDA q launches exactly one kernel, the
    one :func:`use_wgmma` picks, or raises; a CPU q takes
    :func:`flash_attention_plain` (``block_q``/``block_k`` set only its
    blocking)."""
    _check(q, k, v)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, block_q=block_q,
                                     block_k=block_k, **kw)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if use_wgmma(q, k, v):
        return flash_wgmma(q, k, v, **kw)
    return flash_simt(q, k, v, **kw)


def _launch(lib: str, q, k, v, causal, window, softcap, scale):
    _check(q, k, v)
    if q.device.type != "cuda" or any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{lib}: CUDA operands with a unit stride on D "
                         f"expected")
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        *(s for t in (q, k, v) for s in t.stride()[:3]))
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    err = cuda_build.entry(lib)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        ctypes.addressof(strides), B, Sq, Sk, H, KH, D, scale,
        int(softcap is not None), softcap if softcap is not None else 0.0,
        int(causal), int(window is not None),
        window if window is not None else 0, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"repro_torch: {lib} kernel launch failed with "
                           f"error {err}")
    return o


def flash_simt(q, k, v, *, causal=True, window=None, softcap=None,
               scale=None) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` (fp32 FMAs, any dtype of
    ``_DTYPES``) on CUDA operands with a unit stride on D; counted in
    ``flash_attention.launches``."""
    check_smem(q.shape[-1])
    o = _launch("flash_attention", q, k, v, causal, window, softcap, scale)
    flash_attention.launches += 1
    return o


def flash_wgmma(q, k, v, *, causal=True, window=None, softcap=None,
                scale=None) -> torch.Tensor:
    """Launch ``csrc/flash_attention_wgmma.cu`` on CUDA operands that
    :func:`use_wgmma` accepts (raises otherwise); counted in
    ``flash_attention.wgmma_launches``."""
    if not use_wgmma(q, k, v):
        raise ValueError("flash_wgmma: operands outside use_wgmma's rule")
    o = _launch("flash_attention_wgmma", q, k, v, causal, window, softcap,
                scale)
    flash_attention.wgmma_launches += 1
    return o


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
