"""Attention mixer: dense MHA/GQA with RoPE (counterpart of the GQA path of
``repro/models/attention.py``).

Plain ``matmul`` + fp32 softmax, as the reference computes it outside any
Pallas kernel.  MLA, sliding windows, logit softcaps, qk-norm, qkv biases,
decode and the blocked long-sequence path are not ported yet (ROADMAP
A.8); nor is the flash-attention kernel (ROADMAP B.6).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, not_ported
from repro_torch.models.layers import ParamBuilder, apply_rope, make_rope

PyTree = Any
NEG_INF = -2.3819763e38  # the reference's (XLA's) mask value
BLOCKED_THRESHOLD = 8192


def init_attention(b: ParamBuilder, cfg: ModelConfig) -> None:
    d, nh, nkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    b.add("w_q", (d, nh, hd))
    b.add("w_k", (d, nkv, hd))
    b.add("w_v", (d, nkv, hd))
    b.add("w_o", (nh, hd, d))


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                   causal: bool, window: Optional[int]) -> torch.Tensor:
    """Boolean (…, Sq, Sk) mask; ``window`` = sliding-window width."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                      dtype=torch.bool, device=q_pos.device)
    if causal:
        mask = mask & (k <= q)
    if window is not None:
        mask = mask & (k > q - window)
    return mask


def _sdpa(q, k, v, mask, *, scale):
    """q: (n,B,Sq,nkv,g,hd); k,v: (n,B,Sk,nkv,hd); mask (B,Sq,Sk)."""
    logits = torch.einsum("nbqhgd,nbkhd->nbhgqk", q, k).to(
        torch.float32) * scale
    # a Python float fill: no host tensor to copy to the device
    logits = logits.masked_fill(~mask[None, :, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("nbhgqk,nbkhd->nbqhgd", probs, v)


def _project_qkv(params, cfg: ModelConfig, x, positions):
    hd = cfg.resolved_head_dim
    q = torch.einsum("nbsd,ndhk->nbshk", x, params["w_q"].to(x.dtype))
    k = torch.einsum("nbsd,ndhk->nbshk", x, params["w_k"].to(x.dtype))
    v = torch.einsum("nbsd,ndhk->nbshk", x, params["w_v"].to(x.dtype))
    cos, sin = make_rope(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor, *,
                 layer_kind: str,
                 positions: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (train).  x (n, B, S, d); returns
    ``(out, {"k", "v"})``."""
    n, B, S, _ = x.shape
    if layer_kind != "attn":
        raise not_ported(f"attention layer kind {layer_kind!r}", "A.8")
    if S >= BLOCKED_THRESHOLD:
        raise not_ported(f"blocked attention for S={S}", "A.8")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x, positions)
    g = nh // nkv
    qg = q.reshape(n, B, S, nkv, g, hd)
    mask = attention_mask(positions, positions, causal=cfg.causal,
                          window=None)
    out = _sdpa(qg, k, v, mask, scale=1.0 / math.sqrt(hd))
    out = out.reshape(n, B, S, nh, hd)
    out = torch.einsum("nbshk,nhkd->nbsd", out, params["w_o"].to(x.dtype))
    return out, {"k": k, "v": v}
