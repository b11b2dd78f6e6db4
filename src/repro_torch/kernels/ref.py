"""Plain PyTorch oracles for the substrate kernels (counterpart of
``repro/kernels/ref.py``, same names and call shapes)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.layers import softcap as _softcap

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Sk,KH,D) -> (B,Sq,H,D); direct fp32 softmax,
    rows with no valid key zeroed (as the kernel leaves them)."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    group = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KH, group, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    s = _softcap(s, softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    any_valid = mask.any(dim=-1)                          # (Sq,)
    p = p * any_valid[None, None, None, :, None]
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                offset: float = 0.0) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (offset + w.to(torch.float32))).to(x.dtype)


def mlstm_chunk_ref(q, k, v, log_i, log_f):
    """Oracle for the chunkwise-mLSTM kernel: the step-by-step stabilized
    recurrence from ``repro_torch.models.ssm``; returns h only."""
    from repro_torch.models.ssm import mlstm_recurrent_reference
    h, _ = mlstm_recurrent_reference(q, k, v, log_i, log_f)
    return h
