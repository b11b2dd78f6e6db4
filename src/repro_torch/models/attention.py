"""Attention mixers (counterpart of ``repro/models/attention.py``): dense
MHA/GQA with RoPE, sliding window, logit softcap, qk-norm and qkv biases,
and Multi-head Latent Attention (DeepSeek-V2), with their caches.

Plain ``matmul`` + fp32 softmax, as the reference computes it outside any
Pallas kernel.  Two entry modes share one weight set: the full sequence
(train / prefill, :func:`attn_forward`) and one query position against a
cache (:func:`attn_decode`).  From ``BLOCKED_THRESHOLD`` positions on, the
full sequence runs through :func:`_sdpa_blocked` (MLA:
:func:`_mla_attend_blocked`), the reference's memory-bounded host path:
the same math over query chunks, so no S × S score tensor is ever live.
MLA caches the compressed latent ``c_kv`` and the shared RoPE key
``k_rope`` and expands them into per-head keys and values on every call,
as the reference does.  No model calls the flash-attention kernel
(ROADMAP B.6), here or in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (ParamBuilder, apply_rope, built,
                                       make_rope, node_matmul, rms_norm,
                                       softcap)

PyTree = Any
NEG_INF = -2.3819763e38  # the reference's (XLA's) mask value
# S >= BLOCKED_THRESHOLD takes the blocked path, query chunks of _Q_CHUNK
BLOCKED_THRESHOLD = 8192
_Q_CHUNK = 512
LAYER_KINDS = ("attn", "attn_sw")


def init_attention(generator: Optional[torch.Generator], cfg: ModelConfig,
                   param_dtype: torch.dtype, *, device="cuda"
                   ) -> Tuple[PyTree, PyTree]:
    """The attention mixer's ``(params, axes)``: MLA's or dense (the
    reference's call shape)."""
    return built(_init_attention_into, generator, param_dtype, device, cfg)


def _init_attention_into(b: ParamBuilder, cfg: ModelConfig) -> None:
    if cfg.mla is not None:
        m = cfg.mla
        d, nh = cfg.d_model, cfg.n_heads
        b.add("w_q", (d, nh, m.nope_head_dim + m.rope_head_dim),
              ("embed", "heads", None))
        b.add("w_dkv", (d, m.kv_lora_rank), ("embed", None))
        b.add("w_kr", (d, m.rope_head_dim), ("embed", None))
        b.add("kv_norm", (m.kv_lora_rank,), (None,), init="ones")
        b.add("w_uk", (m.kv_lora_rank, nh, m.nope_head_dim),
              (None, "heads", None))
        b.add("w_uv", (m.kv_lora_rank, nh, m.v_head_dim),
              (None, "heads", None))
        b.add("w_o", (nh, m.v_head_dim, d), ("heads", None, "embed"))
        return
    d, nh, nkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    b.add("w_q", (d, nh, hd), ("embed", "heads", None))
    b.add("w_k", (d, nkv, hd), ("embed", "kv_heads", None))
    b.add("w_v", (d, nkv, hd), ("embed", "kv_heads", None))
    b.add("w_o", (nh, hd, d), ("heads", None, "embed"))
    if cfg.qkv_bias:
        b.add("b_q", (nh, hd), ("heads", None), init="zeros")
        b.add("b_k", (nkv, hd), ("kv_heads", None), init="zeros")
        b.add("b_v", (nkv, hd), ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        b.add("q_norm", (hd,), (None,), init="ones")
        b.add("k_norm", (hd,), (None,), init="ones")


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                   causal: bool, window: Optional[int],
                   k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean (…, Sq, Sk) mask; ``window`` = sliding-window width."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                      dtype=torch.bool, device=q_pos.device)
    if causal:
        mask = mask & (k <= q)
    if window is not None:
        mask = mask & (k > q - window)
    if k_valid is not None:
        mask = mask & k_valid[..., None, :]
    return mask


def _sdpa(q, k, v, mask, *, scale, cap=None):
    """q: (n,B,Sq,nkv,g,hd); k,v: (n,B,Sk,nkv,hd); mask (B,Sq,Sk).  The
    fp32 logits are scaled, softcapped, then masked, as in the
    reference."""
    logits = torch.einsum("nbqhgd,nbkhd->nbhgqk", q, k).to(
        torch.float32) * scale
    logits = softcap(logits, cap)
    # a Python float fill: no host tensor to copy to the device
    logits = logits.masked_fill(~mask[None, :, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("nbhgqk,nbkhd->nbqhgd", probs, v)


def _sdpa_blocked(q, k, v, q_pos, k_pos, *, causal: bool,
                  window: Optional[int], scale: float, cap=None,
                  chunk: int = _Q_CHUNK):
    """:func:`_sdpa` over query chunks of ``chunk`` rows (positions
    ``q_pos``/``k_pos`` ``(B, S)``): the live logits are (n, B, nkv, g,
    chunk, Sk), and each chunk's result is written into one preallocated
    output.  As in the reference, the last chunk is padded with zero
    queries at position -1, masked off by ``q_pos >= 0``; those rows stay
    finite because ``NEG_INF`` is finite, and are dropped."""
    Sq = q.shape[2]
    chunk = min(chunk, Sq)
    pad = (-Sq) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-1)
    out = q.new_empty(q.shape[:2] + (Sq,) + q.shape[3:5] + v.shape[-1:])
    for s in range(0, Sq, chunk):
        pi = q_pos[:, s:s + chunk]
        mask = attention_mask(pi, k_pos, causal=causal, window=window)
        mask = mask & (pi[..., :, None] >= 0)
        o = _sdpa(q[:, :, s:s + chunk], k, v, mask, scale=scale, cap=cap)
        out[:, :, s:s + chunk] = o[:, :, :min(chunk, Sq - s)]
    return out


def _heads(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A per-node ``(n, heads, hd)`` leaf broadcast over ``(B, S)``."""
    return w.to(dtype)[:, None, None]


def _project_qkv(params, cfg: ModelConfig, x, positions):
    """The bias, then qk-norm, then RoPE, in the reference's order."""
    hd = cfg.resolved_head_dim
    q = torch.einsum("nbsd,ndhk->nbshk", x, params["w_q"].to(x.dtype))
    k = torch.einsum("nbsd,ndhk->nbshk", x, params["w_k"].to(x.dtype))
    v = torch.einsum("nbsd,ndhk->nbshk", x, params["w_v"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + _heads(params["b_q"], x.dtype)
        k = k + _heads(params["b_k"], x.dtype)
        v = v + _heads(params["b_v"], x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    cos, sin = make_rope(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _window(cfg: ModelConfig, layer_kind: str) -> Optional[int]:
    if layer_kind not in LAYER_KINDS:
        raise ValueError(f"unknown attention layer kind {layer_kind!r}; "
                         f"one of {LAYER_KINDS}")
    return cfg.sliding_window if layer_kind == "attn_sw" else None


def _out(params, out, x):
    n, B, S = out.shape[:3]
    out = out.reshape(n, B, S, -1, out.shape[-1])
    return torch.einsum("nbshk,nhkd->nbsd", out, params["w_o"].to(x.dtype))


def attn_forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor, *,
                 layer_kind: str,
                 positions: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (train / prefill).  x (n, B, S, d); returns
    ``(out, {"k", "v"})``, the cache leaves ``(n, B, S, nkv, hd)``."""
    n, B, S, _ = x.shape
    window = _window(cfg, layer_kind)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.mla is not None:
        return _mla_forward(params, cfg, x, positions=positions)
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x, positions)
    qg = q.reshape(n, B, S, nkv, nh // nkv, hd)
    scale = 1.0 / math.sqrt(hd)
    if S >= BLOCKED_THRESHOLD:
        out = _sdpa_blocked(qg, k, v, positions, positions,
                            causal=cfg.causal, window=window, scale=scale,
                            cap=cfg.attn_logit_softcap)
    else:
        mask = attention_mask(positions, positions, causal=cfg.causal,
                              window=window)
        out = _sdpa(qg, k, v, mask, scale=scale, cap=cfg.attn_logit_softcap)
    return _out(params, out, x), {"k": k, "v": v}


def attn_decode(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor, *,
                layer_kind: str
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x (n, B, 1, d); cache k/v (n, B, S_max, nkv, hd);
    pos (B,) the position each row writes.

    The new key and value are written **in place** into ``cache`` (one row
    per sequence), which is returned: the reference returns updated
    copies.  Rows past a sequence's ``pos`` are masked, so a caller that
    decodes again from the same tensors at ``pos`` or earlier gets the
    reference's answer.  The write index is clamped to ``S_max - 1`` as
    XLA's ``dynamic_update_slice`` clamps its start; the unclamped ``pos``
    goes into RoPE and the mask (an idle serving slot runs past
    ``S_max``).  The mask is causal whatever ``cfg.causal`` says."""
    n, B = x.shape[:2]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    window = _window(cfg, layer_kind)
    if cfg.mla is not None:
        return _mla_decode(params, cfg, x, cache, pos)
    q, k_new, v_new = _project_qkv(params, cfg, x, pos[:, None])
    k, v = cache["k"], cache["v"]
    S_max = k.shape[2]
    rows = torch.arange(B, device=x.device)
    at = pos.clamp(0, S_max - 1).long()
    k[:, rows, at] = k_new[:, :, 0]
    v[:, rows, at] = v_new[:, :, 0]
    qg = q.reshape(n, B, 1, nkv, nh // nkv, hd)
    k_pos = torch.arange(S_max, device=x.device)[None].expand(B, S_max)
    mask = attention_mask(pos[:, None], k_pos, causal=True, window=window)
    out = _sdpa(qg, k, v, mask, scale=1.0 / math.sqrt(hd),
                cap=cfg.attn_logit_softcap)
    return _out(params, out, x), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): the cache holds the compressed latent + shared RoPE key
# ---------------------------------------------------------------------------
def _mla_qkv(params, cfg: ModelConfig, x, positions):
    """x (n, B, S, d) → (q_nope (n, B, S, nh, nope), q_rope (…, rope),
    c_kv (n, B, S, r) normed, k_rope (n, B, S, rope) after RoPE)."""
    m = cfg.mla
    q = torch.einsum("nbsd,ndhk->nbshk", x, params["w_q"].to(x.dtype))
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    cos, sin = make_rope(positions, m.rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    c_kv = node_matmul(x, params["w_dkv"].to(x.dtype))
    c_kv = rms_norm(c_kv, params["kv_norm"], cfg.norm_eps)
    k_rope = node_matmul(x, params["w_kr"].to(x.dtype))[..., None, :]
    k_rope = apply_rope(k_rope, cos, sin)[..., 0, :]          # shared head
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand_kv(params, c_kv):
    """Up-project the compressed latent into per-head keys and values."""
    k_nope = torch.einsum("nbsr,nrhk->nbshk", c_kv,
                          params["w_uk"].to(c_kv.dtype))
    v = torch.einsum("nbsr,nrhk->nbshk", c_kv, params["w_uv"].to(c_kv.dtype))
    return k_nope, v


def _mla_scores(params, cfg: ModelConfig, q_nope, q_rope, k_nope, k_rope,
                v, mask):
    """The two logit products summed in the compute dtype, then fp32,
    scaled and masked (mask (B, Sq, Sk)); the output projected."""
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    logits = torch.einsum("nbqhd,nbkhd->nbhqk", q_nope, k_nope)
    logits = logits + torch.einsum("nbqhd,nbkd->nbhqk", q_rope, k_rope)
    logits = logits.to(torch.float32) * scale
    logits = logits.masked_fill(~mask[None, :, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q_nope.dtype)
    out = torch.einsum("nbhqk,nbkhd->nbqhd", probs, v)
    return torch.einsum("nbqhd,nhdo->nbqo", out,
                        params["w_o"].to(q_nope.dtype))


def _mla_attend(params, cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope,
                mask):
    k_nope, v = _mla_expand_kv(params, c_kv)
    return _mla_scores(params, cfg, q_nope, q_rope, k_nope, k_rope, v, mask)


def _mla_attend_blocked(params, cfg: ModelConfig, q_nope, q_rope, c_kv,
                        k_rope, q_pos, k_pos, *, causal: bool,
                        chunk: int = _Q_CHUNK):
    """:func:`_mla_attend` over query chunks of ``chunk`` rows, the latent
    expanded once for all of them; each chunk's output written into one
    preallocated ``(n, B, Sq, d)`` tensor.  The last chunk is padded with
    zero queries at position −1, masked off and dropped, as in
    :func:`_sdpa_blocked`."""
    Sq = q_nope.shape[2]
    chunk = min(chunk, Sq)
    pad = (-Sq) % chunk
    if pad:
        q_nope = F.pad(q_nope, (0, 0, 0, 0, 0, pad))
        q_rope = F.pad(q_rope, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-1)
    k_nope, v = _mla_expand_kv(params, c_kv)   # hoisted: expand once
    out = q_nope.new_empty(q_nope.shape[:2] + (Sq, params["w_o"].shape[-1]))
    for s in range(0, Sq, chunk):
        pi = q_pos[:, s:s + chunk]
        mask = attention_mask(pi, k_pos, causal=causal, window=None)
        mask = mask & (pi[..., :, None] >= 0)
        o = _mla_scores(params, cfg, q_nope[:, :, s:s + chunk],
                        q_rope[:, :, s:s + chunk], k_nope, k_rope, v, mask)
        out[:, :, s:s + chunk] = o[:, :, :min(chunk, Sq - s)]
    return out


def _mla_forward(params, cfg: ModelConfig, x, *, positions):
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, cfg, x, positions)
    if x.shape[2] >= BLOCKED_THRESHOLD:
        out = _mla_attend_blocked(params, cfg, q_nope, q_rope, c_kv, k_rope,
                                  positions, positions, causal=cfg.causal)
    else:
        mask = attention_mask(positions, positions, causal=cfg.causal,
                              window=None)
        out = _mla_attend(params, cfg, q_nope, q_rope, c_kv, k_rope, mask)
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def _mla_decode(params, cfg: ModelConfig, x, cache, pos):
    """One-token MLA decode: the new latent and RoPE key rows written **in
    place** into ``cache`` at the clamped ``pos`` (as :func:`attn_decode`
    writes keys and values), RoPE and the mask at the raw ``pos``."""
    B = x.shape[1]
    q_nope, q_rope, c_new, kr_new = _mla_qkv(params, cfg, x, pos[:, None])
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    S_max = c_kv.shape[2]
    rows = torch.arange(B, device=x.device)
    at = pos.clamp(0, S_max - 1).long()
    c_kv[:, rows, at] = c_new[:, :, 0]
    k_rope[:, rows, at] = kr_new[:, :, 0]
    k_pos = torch.arange(S_max, device=x.device)[None].expand(B, S_max)
    mask = attention_mask(pos[:, None], k_pos, causal=True, window=None)
    out = _mla_attend(params, cfg, q_nope, q_rope, c_kv, k_rope, mask)
    return out, cache


def init_attn_cache(cfg: ModelConfig, batch: int, s_max: int,
                    dtype: torch.dtype, device,
                    layer_kind: str = "attn") -> Dict[str, torch.Tensor]:
    """Empty ``(B, S_max, nkv, hd)`` key and value caches; MLA's latent
    ``c_kv`` ``(B, S_max, kv_lora_rank)`` and shared RoPE key ``k_rope``
    ``(B, S_max, rope_head_dim)``."""
    _window(cfg, layer_kind)
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": torch.zeros((batch, s_max, m.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, s_max, m.rope_head_dim),
                                      dtype=dtype, device=device)}
    shape = (batch, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_cache_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical axes of :func:`init_attn_cache`'s leaves (one replica)."""
    if cfg.mla is not None:
        return {"c_kv": ("batch", "kv_seq", None),
                "k_rope": ("batch", "kv_seq", None)}
    return {"k": ("batch", "kv_seq", "kv_heads", None),
            "v": ("batch", "kv_seq", "kv_heads", None)}
