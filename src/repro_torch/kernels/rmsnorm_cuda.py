"""Fused RMSNorm — the port of ``repro/kernels/rmsnorm.py``.

:func:`rmsnorm` launches the hand-written CUDA kernel
``repro_torch/csrc/rmsnorm.cu`` (``_rmsnorm_kernel``'s counterpart) for
CUDA tensors, counting each launch in ``rmsnorm.launches``, and takes its
plain twin :func:`rmsnorm_plain` for CPU tensors.  x ``(..., D)`` is
float32, bfloat16 or float16, w ``(D,)`` float32 or x's dtype; the result
has x's shape and dtype: ``x * rsqrt(mean(x²) + eps) * (offset + w)`` with
the mean in float32.  The kernel is built on first use by
:mod:`repro_torch.kernels.cuda_build`; importing this module builds
nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ref import rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(x, w) -> None:
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1] \
            or x.shape[-1] < 1:
        raise ValueError(f"rmsnorm: x (..., D) and w (D,) expected, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm: x must be one of {tuple(_DTYPES)}, got "
                         f"{x.dtype}")
    if w.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"rmsnorm: w must be float32 or x's dtype "
                         f"{x.dtype}, got {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"rmsnorm: operands on several devices "
                         f"{x.device}, {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if x.requires_grad or w.requires_grad:
        raise ValueError("rmsnorm: the kernel has no gradient (nor has the "
                         "reference's)")


# The kernel's plain twin is the oracle itself: the row's fp32 mean of
# squares, then ``(x · rsqrt(var + eps)) · (offset + w)``.
rmsnorm_plain = rmsnorm_ref


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            offset: float = 0.0, block_rows: int = 256) -> torch.Tensor:
    """RMSNorm over the last axis.  A CUDA x launches ``rmsnorm.cu``
    (counted in ``rmsnorm.launches``) or raises; a CPU x takes
    :func:`rmsnorm_plain`.  ``block_rows`` is the reference's row tiling,
    taken for its call shape and unused (rows are independent)."""
    _check(x, w)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps=eps, offset=offset)
    D = x.shape[-1]
    x2 = x.reshape(-1, D)
    if x2.shape[0] == 0:
        return torch.empty_like(x)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    w = w.contiguous()
    y = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    err = cuda_build.entry("rmsnorm")(
        x2.data_ptr(), w.data_ptr(), y.data_ptr(), x2.shape[0], D,
        x2.stride(0), eps, offset, _DTYPES[x.dtype],
        int(w.dtype == x.dtype and x.dtype != torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"repro_torch: rmsnorm kernel launch failed with "
                           f"cudaError {err}")
    rmsnorm.launches += 1
    return y.reshape(x.shape)


rmsnorm.launches = 0
