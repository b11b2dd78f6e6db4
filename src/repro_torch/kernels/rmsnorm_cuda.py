"""Fused RMSNorm — the port of ``repro/kernels/rmsnorm.py``.

:func:`rmsnorm` launches the hand-written CUDA kernel
``repro_torch/csrc/rmsnorm.cu`` (``_rmsnorm_kernel``'s counterpart) for
CUDA tensors and takes its plain twin :func:`rmsnorm_plain` for CPU
tensors.  The kernel has two instances, picked by one rule,
:func:`use_vector`: the vector instance (16-byte loads and stores, the row
held in registers; counted in ``rmsnorm.vector_launches``) for rows whose
bytes and stride are multiples of 16 from 16-byte aligned pointers, at most
:data:`VECTOR_MAX_ROW_BYTES` a row; the scalar instance (counted in
``rmsnorm.launches``) for every other row.  x ``(..., D)`` is
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
# csrc/rmsnorm.cu's kMaxVecBytes: 16 pieces of 16 bytes for each of 32 lanes
VECTOR_MAX_ROW_BYTES = 16 * 32 * 16


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


def use_vector(x2: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether a CUDA call on rows ``x2`` (n_rows, D), unit stride on D,
    and weights ``w`` (D,) launches the vector instance: D and the row
    stride times the item size multiples of 16, 16-byte aligned x and w,
    and at most :data:`VECTOR_MAX_ROW_BYTES` a row.  Pure: reads shapes,
    strides and pointers only."""
    size = x2.element_size()
    D = x2.shape[-1]
    return (x2.stride(-1) == 1 and D * size % 16 == 0
            and x2.stride(0) * size % 16 == 0
            and D * size <= VECTOR_MAX_ROW_BYTES
            and x2.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            offset: float = 0.0, block_rows: int = 256) -> torch.Tensor:
    """RMSNorm over the last axis.  A CUDA x launches one instance of
    ``rmsnorm.cu``, the one :func:`use_vector` picks, or raises; a CPU x
    takes :func:`rmsnorm_plain`.  ``block_rows`` is the reference's row
    tiling, taken for its call shape and unused (rows are independent)."""
    _check(x, w)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps=eps, offset=offset)
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[0] == 0:
        return torch.empty_like(x)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    w = w.contiguous()
    launch = rmsnorm_vector if use_vector(x2, w) else rmsnorm_scalar
    return launch(x2, w, eps=eps, offset=offset).reshape(x.shape)


def _launch(x2, w, eps, offset, vector: bool) -> torch.Tensor:
    _check(x2, w)
    if x2.device.type != "cuda" or x2.dim() != 2 or x2.stride(-1) != 1 \
            or not w.is_contiguous():
        raise ValueError("rmsnorm kernel: CUDA rows (n_rows, D) with a unit "
                         "stride on D and a contiguous w expected")
    y = torch.empty(x2.shape, dtype=x2.dtype, device=x2.device)
    err = cuda_build.entry("rmsnorm")(
        x2.data_ptr(), w.data_ptr(), y.data_ptr(), x2.shape[0], x2.shape[1],
        x2.stride(0), eps, offset, _DTYPES[x2.dtype],
        int(w.dtype == x2.dtype and x2.dtype != torch.float32), int(vector),
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"repro_torch: rmsnorm kernel launch failed with "
                           f"cudaError {err}")
    return y


def rmsnorm_scalar(x2: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                   offset: float = 0.0) -> torch.Tensor:
    """Launch the scalar instance on CUDA rows ``x2`` (n_rows, D) with a
    unit stride on D and a contiguous w; counted in ``rmsnorm.launches``."""
    y = _launch(x2, w, eps, offset, vector=False)
    rmsnorm.launches += 1
    return y


def rmsnorm_vector(x2: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                   offset: float = 0.0) -> torch.Tensor:
    """Launch the vector instance on CUDA rows that :func:`use_vector`
    accepts (raises otherwise); counted in ``rmsnorm.vector_launches``."""
    if not use_vector(x2, w):
        raise ValueError("rmsnorm_vector: rows outside use_vector's rule")
    y = _launch(x2, w, eps, offset, vector=True)
    rmsnorm.vector_launches += 1
    return y


rmsnorm.launches = 0
rmsnorm.vector_launches = 0
