"""Recurrent mixers: Mamba (S6), mLSTM and sLSTM (counterpart of
``repro/models/ssm.py``).

Activations carry the node axis of the port's layout, ``(n, B, S, d)``,
and weights ``(n, …)``; the chunk scans and the recurrent oracle take the
reference's ``(B, S, nh, d)`` and the model folds ``(n, B)`` into their
batch axis.

* Mamba — the first-order recurrence ``h_t = a_t·h_{t−1} + bu_t`` over
  ``(n, B, S, d_inner, N)`` by :func:`associative_scan`, which keeps
  ``jax.lax.associative_scan``'s combine order, in ``cfg.ssm.scan_dtype``
  (on the CPU its ``h`` is bitwise the jitted reference's, float32 and
  bfloat16).
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
the compute dtype, m in float32; Mamba's conv and h in the compute dtype
(h rounded there after its float32 update, as the reference stores it).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import mlstm_cuda
from repro_torch.models.layers import (ParamBuilder, built, node_matmul,
                                       rms_norm)

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
# Mamba (S6)
# ===========================================================================
def _slice(t: torch.Tensor, dim: int, start: int, stop=None,
           step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * t.dim()
    idx[dim] = slice(start, stop, step)
    return t[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a0, b0, a1, b1, … along ``dim``; ``a`` as long as ``b`` or one
    longer."""
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(shape)
    _slice(out, dim, 0, None, 2).copy_(a)
    _slice(out, dim, 1, None, 2).copy_(b)
    return out


def associative_scan(combine, elems, dim: int):
    """Inclusive scan of the tuple ``elems`` along ``dim`` by the recursion
    of ``jax.lax.associative_scan``: combine adjacent pairs, scan the half,
    combine the evens with the odd results, interleave.  Every element is
    combined in the reference's order, so a combine that rounds the same
    per operation gives bitwise its results."""
    def scan(elems):
        n = elems[0].shape[dim]
        if n < 2:
            return elems
        odd = scan(combine(tuple(_slice(e, dim, 0, -1, 2) for e in elems),
                           tuple(_slice(e, dim, 1, None, 2) for e in elems)))
        rest = tuple(_slice(e, dim, 2, None, 2) for e in elems)
        head = (tuple(_slice(e, dim, 0, -1) for e in odd) if n % 2 == 0
                else odd)
        even = tuple(torch.cat([_slice(e, dim, 0, 1), r], dim=dim)
                     for e, r in zip(elems, combine(head, rest)))
        return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))

    return scan(tuple(elems))


def _mamba_combine(lhs, rhs):
    """``(a_l·a_r, b_l·a_r + b_r)``.  In float32 the second is one fused
    multiply-add, as XLA contracts the jitted reference's; in bfloat16 each
    product and sum rounds, as the reference's per-operation converts do."""
    al, bl = lhs
    ar, br = rhs
    if br.dtype == torch.float32:
        return al * ar, torch.addcmul(br, bl, ar)
    return al * ar, bl * ar + br


def _mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or max(cfg.d_model // 16, 1)
    return d_inner, s.d_state, dt_rank


def init_mamba(generator: Optional[torch.Generator], cfg: ModelConfig,
               param_dtype: torch.dtype, *, device="cuda"
               ) -> Tuple[PyTree, PyTree]:
    """The Mamba mixer's ``(params, axes)`` (the reference's call shape)."""
    return built(_init_mamba_into, generator, param_dtype, device, cfg)


def _init_mamba_into(b: ParamBuilder, cfg: ModelConfig) -> None:
    d = cfg.d_model
    di, N, R = _mamba_dims(cfg)
    b.add("in_proj", (d, 2 * di), ("embed", "ffn"))
    b.add("conv_w", (cfg.ssm.d_conv, di), (None, "ffn"))
    b.add("conv_b", (di,), ("ffn",), init="zeros")
    b.add("x_proj", (di, R + 2 * N), ("ffn", None))
    b.add("dt_proj", (R, di), (None, "ffn"))
    b.add("dt_bias", (di,), ("ffn",), init="constant",
          scale=math.log(math.expm1(0.01)))      # softplus^-1(0.01)
    # S4D-real: log(1..N) per channel, not drawn (rounded once from
    # float64; XLA's float32 log is an ulp off at log 7)
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float64)).to(
        torch.float32)
    b.attach("A_log", a_log.expand(di, N).to(
        dtype=b.param_dtype, device=b.device), ("ffn", None))
    b.add("D", (di,), ("ffn",), init="ones")
    b.add("out_proj", (di, d), ("ffn", "embed"))


def _mamba_ssm_inputs(params, cfg: ModelConfig, x_conv: torch.Tensor,
                      dt_rank: int, N: int):
    """x_conv (n, …, di) → dt (n, …, di) in its dtype, B and C (n, …, N),
    A (n, di, N) float32."""
    dtype = x_conv.dtype
    dbc = node_matmul(x_conv, params["x_proj"].to(dtype))
    dt, Bc, Cc = dbc.split([dt_rank, N, N], dim=-1)
    dt = F.softplus(node_matmul(dt, params["dt_proj"].to(dtype))
                    + _bias(params["dt_bias"].to(dtype), x_conv))
    A = -torch.exp(params["A_log"].to(torch.float32))
    return dt, Bc, Cc, A


def mamba_forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (n, B, S, d) → (out, state): the parallel scan over the whole
    sequence, its state ``(n, B, S, d_inner, N)`` in ``cfg.ssm.scan_dtype``
    (the gate and decay math in float32)."""
    di, N, R = _mamba_dims(cfg)
    f32 = torch.float32
    sdt = torch.bfloat16 if cfg.ssm.scan_dtype == "bfloat16" else f32
    xc, z = node_matmul(x, params["in_proj"].to(x.dtype)).split(di, dim=-1)
    x_conv = F.silu(_causal_conv(xc, params["conv_w"], params["conv_b"]))
    dt, Bc, Cc, A = _mamba_ssm_inputs(params, cfg, x_conv, R, N)
    dt32 = dt.to(f32)
    a = torch.exp(dt32[..., None] * A[:, None, None]).to(sdt)
    bu = ((dt32 * x_conv.to(f32))[..., None]
          * Bc.to(f32)[..., None, :]).to(sdt)
    del dt32
    _, h = associative_scan(_mamba_combine, (a, bu), dim=2)
    del a, bu
    y = torch.einsum("nbsdk,nbsk->nbsd", h, Cc.to(sdt))
    y = y.to(f32) + _bias(params["D"].to(f32), x_conv) * x_conv.to(f32)
    y = y.to(x.dtype) * F.silu(z)
    out = node_matmul(y, params["out_proj"].to(x.dtype))
    state = {"conv": _final_conv_state(xc, cfg.ssm.d_conv),
             "h": h[:, :, -1].to(x.dtype)}
    return out, state


def mamba_decode(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                 state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (n, B, 1, d); state {conv (n, B, W−1, di), h (n, B, di, N)}: h
    updated in float32 and stored in x's dtype."""
    di, N, R = _mamba_dims(cfg)
    f32 = torch.float32
    xc, z = node_matmul(x[:, :, 0], params["in_proj"].to(x.dtype)).split(
        di, dim=-1)
    x_conv, new_conv = _conv_step(xc, state["conv"], params["conv_w"],
                                  params["conv_b"])
    x_conv = F.silu(x_conv)
    dt, Bc, Cc, A = _mamba_ssm_inputs(params, cfg, x_conv, R, N)
    a = torch.exp(dt.to(f32)[..., None] * A[:, None])
    bu = ((dt.to(f32) * x_conv.to(f32))[..., None]
          * Bc.to(f32)[..., None, :])
    h = a * state["h"].to(f32) + bu
    y = torch.einsum("nbdk,nbk->nbd", h, Cc.to(f32))
    y = y + _bias(params["D"].to(f32), x_conv) * x_conv.to(f32)
    y = y.to(x.dtype) * F.silu(z)
    out = node_matmul(y, params["out_proj"].to(x.dtype))[:, :, None]
    return out, {"conv": new_conv, "h": h.to(x.dtype)}


def init_mamba_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> Dict[str, torch.Tensor]:
    di, N, _ = _mamba_dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, di, N), dtype=dtype, device=device)}


def mamba_state_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    return {"conv": ("batch", None, "ffn"), "h": ("batch", "ffn", None)}


# ===========================================================================
# mLSTM
# ===========================================================================
def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    di = s.mlstm_expand * cfg.d_model
    nh = max(di // (2 * s.mlstm_head_dim), 1)  # qk dim di/(2nh), v dim di/nh
    return di, nh, s.mlstm_head_dim


def init_mlstm(generator: Optional[torch.Generator], cfg: ModelConfig,
               param_dtype: torch.dtype, *, device="cuda"
               ) -> Tuple[PyTree, PyTree]:
    """The mLSTM mixer's ``(params, axes)`` (the reference's call shape)."""
    return built(_init_mlstm_into, generator, param_dtype, device, cfg)


def _init_mlstm_into(b: ParamBuilder, cfg: ModelConfig) -> None:
    d = cfg.d_model
    di, nh, dk = _mlstm_dims(cfg)
    b.add("up_proj", (d, 2 * di), ("embed", "ffn"))
    b.add("conv_w", (CONV_WIDTH, di), (None, "ffn"))
    b.add("conv_b", (di,), ("ffn",), init="zeros")
    b.add("w_q", (di, nh, dk), ("ffn", "heads", None))
    b.add("w_k", (di, nh, dk), ("ffn", "heads", None))
    b.add("w_v", (di, nh, di // nh), ("ffn", "heads", None))
    b.add("w_i", (di, nh), ("ffn", "heads"), init="fan_in")
    b.add("b_i", (nh,), ("heads",), init="zeros")
    b.add("w_f", (di, nh), ("ffn", "heads"), init="fan_in")
    b.add("b_f", (nh,), ("heads",), init="constant",
          scale=3.0)                                   # open forget gate
    b.add("gn", (di,), ("ffn",), init="ones")          # group norm
    b.add("down_proj", (di, d), ("ffn", "embed"))


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


def mlstm_state_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    return {"C": ("batch", "heads", None, None),
            "n": ("batch", "heads", None),
            "m": ("batch", "heads"),
            "conv": ("batch", None, "ffn")}


# ===========================================================================
# sLSTM
# ===========================================================================
def _slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    nh = cfg.ssm.slstm_heads
    return nh, cfg.d_model // nh


def init_slstm(generator: Optional[torch.Generator], cfg: ModelConfig,
               param_dtype: torch.dtype, *, device="cuda"
               ) -> Tuple[PyTree, PyTree]:
    """The sLSTM mixer's ``(params, axes)`` (the reference's call shape)."""
    return built(_init_slstm_into, generator, param_dtype, device, cfg)


def _init_slstm_into(b: ParamBuilder, cfg: ModelConfig) -> None:
    d = cfg.d_model
    nh, dh = _slstm_dims(cfg)
    # gate inputs i, f, z, o; a block-diagonal recurrence
    b.add("w_x", (d, 4, nh, dh), ("embed", None, "heads", None))
    b.add("r_h", (4, nh, dh, dh), (None, "heads", None, None), init="fan_in")
    b.add("bias", (4, nh, dh), (None, "heads", None), init="zeros")
    b.add("gn", (d,), (None,), init="ones")
    b.add("out_proj", (d, d), ("embed", "embed"))


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


def slstm_state_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    return {"c": ("batch", "heads", None), "n": ("batch", "heads", None),
            "h": ("batch", "heads", None), "m": ("batch", "heads", None)}
