"""Recurrent mixers of the xLSTM family: mLSTM and sLSTM (counterpart of
the xLSTM part of ``repro/models/ssm.py``).

Activations carry the node axis of the port's layout, ``(n, B, S, d)``,
and weights ``(n, …)``; the chunk scans and the recurrent oracle take the
reference's ``(B, S, nh, d)`` and the model folds ``(n, B)`` into their
batch axis.

* mLSTM — chunkwise-parallel, log-space gate stabilization.  With
  ``cfg.ssm.use_pallas_mlstm`` the prefill goes through
  :func:`repro_torch.kernels.mlstm_cuda.mlstm_chunk` (the hand-written CUDA
  kernel on the card, its plain twin on the CPU), which also returns the
  final ``(C, n, m)``; otherwise through :func:`_mlstm_chunk_scan`, which
  rounds the intra-chunk products to the compute dtype where the
  reference's bf16 einsums do.
* sLSTM — a sequential scalar recurrence, a Python loop over positions.

Decode steps are exact single-token recurrences against the state.  The
caches keep the reference's dtypes: C, n (mLSTM) and c, n, h (sLSTM) in
the compute dtype, m in float32.  Mamba is not ported (ROADMAP A.8).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import mlstm_cuda
from repro_torch.models.layers import ParamBuilder, node_matmul, rms_norm

PyTree = Any
NEG_BIG = -1e9
CONV_WIDTH = 4


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in float32 as an explicit W-tap sum (no cuDNN,
    so no TF32).  x (n, B, S, D); w (n, W, D); b (n, D)."""
    n, B, S, D = x.shape
    W = w.shape[1]
    xp = torch.cat([x.new_zeros((n, B, W - 1, D)), x], dim=2).to(
        torch.float32)
    w32 = w.to(torch.float32)[:, None]                     # (n, 1, W, D)
    out = xp[:, :, 0:S] * w32[:, :, 0, None]
    for j in range(1, W):
        out = out + xp[:, :, j:j + S] * w32[:, :, j, None]
    return (out + b.to(torch.float32)[:, None, None]).to(x.dtype)


def _conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token causal conv against a (n, B, W-1, D) state; x_t
    (n, B, D)."""
    window = torch.cat([conv_state, x_t[:, :, None]], dim=2)  # (n,B,W,D)
    out = torch.einsum("nbwd,nwd->nbd", window.to(torch.float32),
                       w.to(torch.float32)) + b.to(torch.float32)[:, None]
    return out.to(x_t.dtype), window[:, :, 1:]


def _final_conv_state(xc: torch.Tensor, width: int) -> torch.Tensor:
    n, B, _, D = xc.shape
    pad = xc.new_zeros((n, B, width - 1, D))
    return torch.cat([pad, xc], dim=2)[:, :, -(width - 1):]


def _bias(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (n, f) bias broadcast over the middle dims of x (n, …, f)."""
    return b.reshape(b.shape[:1] + (1,) * (x.dim() - 2) + b.shape[1:])


# ===========================================================================
# mLSTM
# ===========================================================================
def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    di = s.mlstm_expand * cfg.d_model
    nh = max(di // (2 * s.mlstm_head_dim), 1)  # qk dim di/(2nh), v dim di/nh
    return di, nh, s.mlstm_head_dim


def init_mlstm(b: ParamBuilder, cfg: ModelConfig) -> None:
    d = cfg.d_model
    di, nh, dk = _mlstm_dims(cfg)
    b.add("up_proj", (d, 2 * di))
    b.add("conv_w", (CONV_WIDTH, di))
    b.add("conv_b", (di,), init="zeros")
    b.add("w_q", (di, nh, dk))
    b.add("w_k", (di, nh, dk))
    b.add("w_v", (di, nh, di // nh))
    b.add("w_i", (di, nh), init="fan_in")
    b.add("b_i", (nh,), init="zeros")
    b.add("w_f", (di, nh), init="fan_in")
    b.add("b_f", (nh,), init="constant", scale=3.0)   # open forget gate
    b.add("gn", (di,), init="ones")                   # group norm
    b.add("down_proj", (di, d))


def _gate(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """float32 pre-activation of gate ``name`` (i or f): the matmul and the
    bias add in x's dtype, as the reference does."""
    w = params[f"w_{name}"].to(x.dtype)
    bias = params[f"b_{name}"].to(x.dtype)
    return (node_matmul(x, w) + _bias(bias, x)).to(torch.float32)


def _mlstm_qkvif(params, cfg: ModelConfig, x_in: torch.Tensor):
    """x_in (n, B, S, di), the up-projected mixer branch →
    q, k (n, B, S, nh, dk), v (n, B, S, nh, dv), log_i, log_f (n, B, S, nh)
    float32."""
    dtype = x_in.dtype
    x_conv = F.silu(_causal_conv(x_in, params["conv_w"], params["conv_b"]))
    q = torch.einsum("nbsd,ndhk->nbshk", x_conv, params["w_q"].to(dtype))
    k = torch.einsum("nbsd,ndhk->nbshk", x_conv, params["w_k"].to(dtype))
    v = torch.einsum("nbsd,ndhk->nbshk", x_in, params["w_v"].to(dtype))
    q = q / math.sqrt(q.shape[-1])
    return (q, k, v, _gate(params, "i", x_in),
            F.logsigmoid(_gate(params, "f", x_in)))


def _mlstm_chunk_scan(q, k, v, log_i, log_f, chunk: int):
    """Chunkwise mLSTM, the reference's scan.  q, k (B, S, nh, dk);
    v (B, S, nh, dv); log_i/log_f (B, S, nh) float32.  Returns h
    (B, S, nh, dv) in q's dtype and the final float32 (C, n, m).  It is the
    kernel twin's routine at the scan's chunk length min(chunk, S), with
    the intra-chunk scores and probabilities rounded to q's dtype where the
    reference's einsums round them (a no-op at float32)."""
    low = None if q.dtype == torch.float32 else q.dtype
    return mlstm_cuda.chunkwise(q, k, v, log_i, log_f,
                                min(chunk, q.shape[1]), low=low)


def mlstm_forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (n, B, S, d) → (out, state)."""
    n_, B, S, _ = x.shape
    di, nh, dk = _mlstm_dims(cfg)
    up = node_matmul(x, params["up_proj"].to(x.dtype))
    x_in, z = up.split(di, dim=-1)
    q, k, v, log_i, log_f = _mlstm_qkvif(params, cfg, x_in)
    flat = [t.reshape((n_ * B,) + t.shape[2:])
            for t in (q, k, v, log_i, log_f)]
    if cfg.ssm.use_pallas_mlstm:
        h, (C, n, m) = mlstm_cuda.mlstm_chunk(*flat,
                                              chunk=cfg.ssm.mlstm_chunk)
    else:
        h, (C, n, m) = _mlstm_chunk_scan(*flat, cfg.ssm.mlstm_chunk)
    h = rms_norm(h.reshape(n_, B, S, di), params["gn"], cfg.norm_eps)
    out = node_matmul(h * F.silu(z), params["down_proj"].to(x.dtype))
    state = {"C": C.reshape((n_, B) + C.shape[1:]).to(x.dtype),
             "n": n.reshape((n_, B) + n.shape[1:]).to(x.dtype),
             "m": m.reshape(n_, B, nh),
             "conv": _final_conv_state(x_in, CONV_WIDTH)}
    return out, state


def mlstm_recurrent_reference(q, k, v, log_i, log_f):
    """Step-by-step stabilized mLSTM recurrence — the oracle.  Shapes as
    :func:`_mlstm_chunk_scan`."""
    B, S, nh, dk = q.shape
    f32 = torch.float32
    C = torch.zeros((B, nh, dk, v.shape[-1]), dtype=f32, device=q.device)
    n = torch.zeros((B, nh, dk), dtype=f32, device=q.device)
    m = torch.full((B, nh), NEG_BIG, dtype=f32, device=q.device)
    hs = []
    for t in range(S):
        qt, kt, vt = q[:, t].to(f32), k[:, t].to(f32), v[:, t].to(f32)
        li, lf = log_i[:, t], log_f[:, t]
        m_new = torch.maximum(lf + m, li)
        fg = torch.exp(lf + m - m_new)
        ig = torch.exp(li - m_new)
        C = C * fg[..., None, None] + ig[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = n * fg[..., None] + ig[..., None] * kt
        num = torch.einsum("bhkv,bhk->bhv", C, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype), (C, n, m)


def mlstm_decode(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                 state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (n, B, 1, d); state {C, n, m, conv}."""
    n_, B = x.shape[:2]
    di, nh, dk = _mlstm_dims(cfg)
    dtype, f32 = x.dtype, torch.float32
    up = node_matmul(x[:, :, 0], params["up_proj"].to(dtype))
    x_in, z = up.split(di, dim=-1)
    x_conv, new_conv = _conv_step(x_in, state["conv"], params["conv_w"],
                                  params["conv_b"])
    x_conv = F.silu(x_conv)
    q = torch.einsum("nbd,ndhk->nbhk", x_conv, params["w_q"].to(dtype))
    k = torch.einsum("nbd,ndhk->nbhk", x_conv, params["w_k"].to(dtype))
    v = torch.einsum("nbd,ndhk->nbhk", x_in, params["w_v"].to(dtype))
    q = q / math.sqrt(dk)
    i_raw = _gate(params, "i", x_in)
    lf = F.logsigmoid(_gate(params, "f", x_in))
    C, n, m = state["C"].to(f32), state["n"].to(f32), state["m"]
    m_new = torch.maximum(lf + m, i_raw)
    fg = torch.exp(lf + m - m_new)
    ig = torch.exp(i_raw - m_new)
    C = C * fg[..., None, None] + ig[..., None, None] * (
        k[..., :, None].to(f32) * v[..., None, :].to(f32))
    n = n * fg[..., None] + ig[..., None] * k.to(f32)
    num = torch.einsum("nbhkv,nbhk->nbhv", C, q.to(f32))
    den = torch.maximum(
        torch.abs(torch.einsum("nbhk,nbhk->nbh", n, q.to(f32))),
        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(n_, B, di).to(dtype)
    h = rms_norm(h, params["gn"], cfg.norm_eps)
    out = node_matmul(h * F.silu(z), params["down_proj"].to(dtype))
    return out[:, :, None], {"C": C.to(dtype), "n": n.to(dtype), "m": m_new,
                             "conv": new_conv}


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> Dict[str, torch.Tensor]:
    di, nh, dk = _mlstm_dims(cfg)
    return {"C": torch.zeros((batch, nh, dk, di // nh), dtype=dtype,
                             device=device),
            "n": torch.zeros((batch, nh, dk), dtype=dtype, device=device),
            "m": torch.full((batch, nh), NEG_BIG, dtype=torch.float32,
                            device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, di), dtype=dtype,
                                device=device)}


# ===========================================================================
# sLSTM
# ===========================================================================
def _slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    nh = cfg.ssm.slstm_heads
    return nh, cfg.d_model // nh


def init_slstm(b: ParamBuilder, cfg: ModelConfig) -> None:
    d = cfg.d_model
    nh, dh = _slstm_dims(cfg)
    b.add("w_x", (d, 4, nh, dh))              # gate inputs i, f, z, o
    b.add("r_h", (4, nh, dh, dh), init="fan_in")  # block-diagonal recurrence
    b.add("bias", (4, nh, dh), init="zeros")
    b.add("gn", (d,), init="ones")
    b.add("out_proj", (d, d))


def _slstm_step(r_h: torch.Tensor, bias: torch.Tensor, carry, x_t):
    """x_t (n, B, 4, nh, dh) pre-projected gate inputs; float32."""
    c, n, h, m = carry
    gates = x_t + torch.einsum("nghij,nbhj->nbghi", r_h, h) + bias[:, None]
    i_raw, f_raw, z_raw, o_raw = gates.unbind(dim=2)
    lf = F.logsigmoid(f_raw)
    m_new = torch.maximum(lf + m, i_raw)
    ig = torch.exp(i_raw - m_new)
    fg = torch.exp(lf + m - m_new)
    c = fg * c + ig * torch.tanh(z_raw)
    n = fg * n + ig
    h_new = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1e-6)
    return (c, n, h_new, m_new), h_new


def _slstm_out(params, cfg: ModelConfig, hs: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    hs = rms_norm(hs.to(dtype), params["gn"], cfg.norm_eps)
    return node_matmul(hs, params["out_proj"].to(dtype))


def _slstm_state(carry, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    c, n, h, m = carry
    return {"c": c.to(dtype), "n": n.to(dtype), "h": h.to(dtype), "m": m}


def slstm_forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (n, B, S, d) → (out, state); the recurrence runs in float32."""
    n_, B, S, d = x.shape
    nh, dh = _slstm_dims(cfg)
    f32 = torch.float32
    xg = torch.einsum("nbsd,ndghj->nbsghj", x.to(f32),
                      params["w_x"].to(f32))        # (n, B, S, 4, nh, dh)
    r_h, bias = params["r_h"].to(f32), params["bias"].to(f32)
    zeros = torch.zeros((n_, B, nh, dh), dtype=f32, device=x.device)
    carry = (zeros, zeros, zeros, torch.full_like(zeros, NEG_BIG))
    hs = []
    for t in range(S):
        carry, h = _slstm_step(r_h, bias, carry, xg[:, :, t])
        hs.append(h)
    hs = torch.stack(hs, dim=2).reshape(n_, B, S, d)
    return _slstm_out(params, cfg, hs, x.dtype), _slstm_state(carry, x.dtype)


def slstm_decode(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                 state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (n, B, 1, d); state {c, n, h, m}."""
    n_, B, _, d = x.shape
    f32 = torch.float32
    xg = torch.einsum("nbd,ndghj->nbghj", x[:, :, 0].to(f32),
                      params["w_x"].to(f32))
    carry = (state["c"].to(f32), state["n"].to(f32), state["h"].to(f32),
             state["m"])
    carry, h = _slstm_step(params["r_h"].to(f32), params["bias"].to(f32),
                           carry, xg)
    out = _slstm_out(params, cfg, h.reshape(n_, B, d), x.dtype)
    return out[:, :, None], _slstm_state(carry, x.dtype)


def init_slstm_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> Dict[str, torch.Tensor]:
    nh, dh = _slstm_dims(cfg)

    def zeros():
        return torch.zeros((batch, nh, dh), dtype=dtype, device=device)

    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full((batch, nh, dh), NEG_BIG, dtype=torch.float32,
                            device=device)}
