"""Public entry points of the substrate kernels (counterpart of
``repro/kernels/ops.py``, same names and keywords).

Each takes the kernel's plain PyTorch twin for CPU tensors and launches
the hand-written CUDA kernel for CUDA tensors, or raises.  The
reference's ``interpret`` keyword (Pallas interpret mode off the TPU) has
no counterpart here and is not taken.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import flash_attention_cuda, mlstm_cuda, rmsnorm_cuda


def flash_attention_op(q, k, v, *, causal: bool = True,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None,
                       block_q: int = 128, block_k: int = 128):
    """q (B, Sq, H, D), k and v (B, Sk, KH, D) → (B, Sq, H, D)."""
    return flash_attention_cuda.flash_attention(
        q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
        block_q=block_q, block_k=block_k)


def rmsnorm_op(x, w, *, eps: float = 1e-6, offset: float = 0.0,
               block_rows: int = 256):
    """x (..., D), w (D,) → x's shape and dtype."""
    return rmsnorm_cuda.rmsnorm(x, w, eps=eps, offset=offset,
                                block_rows=block_rows)


def mlstm_chunk_op(q, k, v, log_i, log_f, *, chunk: int = 64):
    """Chunkwise mLSTM; returns h (B, S, nh, dv) only, as the reference's
    op does (``mlstm_cuda.mlstm_chunk`` also returns the final state)."""
    return mlstm_cuda.mlstm_chunk(q, k, v, log_i, log_f, chunk=chunk)[0]
