"""Mixture-of-Experts FFN (counterpart of ``repro/models/moe.py``).

Dispatch is sort-based with static capacity (Switch/GShard-style
dropping): the token→expert assignments are sorted by expert and packed
into ``(E, C)`` tables of token indices and routing weights, the experts
run batched products over their capacity slots, and the results are
added back in token order.  Every function takes the leading node axis
``n`` of the port's layout: the dispatch runs per node (the reference
``vmap``s one node's call), tables are ``(n, E, C)``, the expert products
one ``bmm`` over ``n·E``, and ``lb_loss``/``drop_frac`` are ``(n,)``.

Three choices keep the port bitwise the reference's tables and on the
card free of host synchronization and of nondeterministic atomics:

* top-k by a **stable descending sort**: ``jax.lax.top_k`` breaks ties
  toward the lower index, ``torch.topk`` does not (a zero router is
  exactly such a tie);
* the tables are **gathered** from the sorted assignments (slot ``c`` of
  expert ``e`` holds sorted assignment ``starts[e] + c`` while ``c <
  counts[e]``), counts by ``scatter_add_`` — no ``bincount``, boolean
  indexing or ``nonzero``, each of which reads back to the host;
* the combine adds each token's kept expert outputs **in ascending
  expert order**, one add per top-k rank, as the reference's scatter-add
  applies them (in sorted, expert-major order), instead of
  ``index_add_``'s atomics.

**A reference fault kept for parity** (ROADMAP C.4): the reference
sends every dropped assignment to index ``(0, 0)`` of the tables, and
XLA applies the writes in sorted order, so whenever anything is dropped,
expert 0's first slot becomes the sentinel (token ``T``, weight 0): the
assignment that held it is lost and ``drop_frac`` does not count it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import (ParamBuilder, apply_mlp, built,
                                       node_matmul)

PyTree = Any

DEFAULT_CAPACITY_FACTOR = 1.25


def init_moe(generator: Optional[torch.Generator], cfg: ModelConfig,
             param_dtype: torch.dtype, *, device="cuda"
             ) -> Tuple[PyTree, PyTree]:
    """The MoE FFN's ``(params, axes)`` (the reference's call shape)."""
    return built(_init_moe_into, generator, param_dtype, device, cfg)


def _init_moe_into(b: ParamBuilder, cfg: ModelConfig) -> None:
    m = cfg.moe
    d = cfg.d_model
    b.add("router", (d, m.n_routed), ("embed", None))
    b.add("w_gate", (m.n_routed, d, m.d_ff_expert), ("expert", "embed", None))
    b.add("w_up", (m.n_routed, d, m.d_ff_expert), ("expert", "embed", None))
    b.add("w_down", (m.n_routed, m.d_ff_expert, d), ("expert", None, "embed"))
    if m.n_shared:
        b.add("sw_gate", (d, m.n_shared * m.d_ff_expert), ("embed", "ffn"))
        b.add("sw_up", (d, m.n_shared * m.d_ff_expert), ("embed", "ffn"))
        b.add("sw_down", (m.n_shared * m.d_ff_expert, d), ("ffn", "embed"))


def route(params: PyTree, m: MoEConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k router in fp32.  x ``(n, …, d)`` → ``(top_w (n, …, k),
    top_idx (n, …, k) int64, lb_loss (n,))``; the Switch balance loss
    ``E · Σ_e (tokens routed to e / (T·k)) · (mean prob of e)`` per node."""
    n = x.shape[0]
    logits = node_matmul(x.to(torch.float32),
                         params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = vals[..., :m.top_k], idx[..., :m.top_k]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    flat = top_idx.reshape(n, -1)
    tokens = flat.shape[1] // m.top_k
    routed = torch.zeros((n, m.n_routed), dtype=torch.float32,
                         device=x.device)
    routed.scatter_add_(1, flat, torch.ones(flat.shape, dtype=torch.float32,
                                            device=x.device))
    # means as XLA takes them: the sum times the reciprocal of the count
    tokens_frac = routed * (1.0 / tokens)
    prob_frac = torch.sum(probs.reshape(n, -1, m.n_routed), dim=1) * (
        1.0 / tokens)
    lb_loss = m.n_routed * torch.sum(tokens_frac / m.top_k * prob_frac,
                                     dim=-1)
    return top_w, top_idx, lb_loss


def expert_capacity(m: MoEConfig, n_tokens: int,
                    capacity_factor: float = DEFAULT_CAPACITY_FACTOR) -> int:
    c = int(math.ceil(n_tokens * m.top_k * capacity_factor / m.n_routed))
    return max(min(c, n_tokens), 8)


def _dispatch(top_idx: torch.Tensor, top_w: torch.Tensor, n_experts: int,
              capacity: int, n_tokens: int):
    """The node-stacked dispatch: top_idx, top_w ``(n, T, k)`` →
    ``(token_table (n, E, C) int64, weight_table (n, E, C), drop_frac
    (n,), slot (n, T, k))``, ``slot`` the flat ``e·C + c`` each
    assignment landed in, or −1 where it was dropped (by capacity, or
    lost to the ``(0, 0)`` overwrite)."""
    n, T, k = top_idx.shape
    E, C, N = n_experts, capacity, T * k
    dev = top_idx.device
    flat_e = top_idx.reshape(n, N).long()
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    counts = torch.zeros((n, E), dtype=torch.long, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    cs = torch.arange(C, device=dev)
    src = (starts[:, :, None] + cs).clamp(max=N - 1).reshape(n, E * C)
    valid = cs < counts[:, :, None]
    token_table = torch.where(
        valid, torch.div(order, k, rounding_mode="floor").gather(
            1, src).reshape(n, E, C), n_tokens)
    weight_table = torch.where(
        valid, top_w.reshape(n, N).gather(1, order).gather(
            1, src).reshape(n, E, C), 0.0)
    dropped = torch.clamp(counts - C, min=0).sum(dim=1)
    # the reference's dropped writes to (0, 0): the last, the sentinel,
    # wins whenever anything drops (ROADMAP C.4)
    first = (torch.arange(E, device=dev)[:, None] == 0) & (cs == 0)
    lost = first & (dropped > 0)[:, None, None]
    token_table = torch.where(lost, n_tokens, token_table)
    weight_table = torch.where(lost, 0.0, weight_table)
    kept = N - dropped
    drop_frac = 1.0 - kept.to(torch.float32) * (1.0 / N)
    # each assignment's slot, back in (t, j) order
    rank = torch.arange(N, device=dev) - starts.gather(1, sorted_e)
    slot = torch.empty_like(rank).scatter_(1, order, rank).reshape(n, T, k)
    e = top_idx.long()
    ok = (slot < C) & ~((e == 0) & (slot == 0)
                        & (dropped > 0)[:, None, None])
    slot = torch.where(ok, e * C + slot, -1)
    return token_table, weight_table, drop_frac, slot


def _build_dispatch(top_idx: torch.Tensor, top_w: torch.Tensor,
                    n_experts: int, capacity: int, n_tokens: int):
    """The reference's call shape: top_idx, top_w ``(T, k)`` (or node-
    stacked ``(n, T, k)``) → ``(token_table (E, C), weight_table (E, C),
    drop_frac)`` (each with the node axis where the inputs have it).
    Overflow slots point at the sentinel row ``n_tokens``."""
    single = top_idx.dim() == 2
    if single:
        top_idx, top_w = top_idx[None], top_w[None]
    tok, w, drop_frac, _ = _dispatch(top_idx, top_w, n_experts, capacity,
                                     n_tokens)
    if single:
        return tok[0], w[0], drop_frac[0]
    return tok, w, drop_frac


def _shared(params: PyTree) -> PyTree:
    return {"w_gate": params["sw_gate"], "w_up": params["sw_up"],
            "w_down": params["sw_down"]}


def apply_moe(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: Optional[float] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x ``(n, B, S, d)`` → ``(out, {"lb_loss" (n,), "drop_frac" (n,)})``.

    The capacity (and so the drop set) depends on each node's token count
    ``T = B·S`` of the call: a full-sequence forward, a prefill and a
    decode step see different T, so capacity-dropped tokens may differ
    across paths.  ``MoEConfig.capacity_factor >= n_routed`` is drop-free
    (path-exact)."""
    m = cfg.moe
    if capacity_factor is None:
        capacity_factor = m.capacity_factor
    n, B, S, d = x.shape
    T, E, k = B * S, m.n_routed, m.top_k
    dt = x.dtype
    top_w, top_idx, lb_loss = route(params, m, x)
    C = expert_capacity(m, T, capacity_factor)
    tok, w, drop_frac, slot = _dispatch(
        top_idx.reshape(n, T, k), top_w.reshape(n, T, k), E, C, T)

    # the padded rows of every node, one gather over the flattened nodes
    x_pad = torch.cat([x.reshape(n, T, d), x.new_zeros((n, 1, d))], dim=1)
    node = torch.arange(n, device=x.device)
    rows = (tok + (node * (T + 1))[:, None, None]).reshape(-1)
    xe = x_pad.reshape(n * (T + 1), d).index_select(0, rows).reshape(
        n * E, C, d)
    h = torch.nn.functional.silu(torch.bmm(
        xe, params["w_gate"].to(dt).reshape(n * E, d, -1)))
    h = h * torch.bmm(xe, params["w_up"].to(dt).reshape(n * E, d, -1))
    ye = torch.bmm(h, params["w_down"].to(dt).reshape(n * E, -1, d))
    ye = ye.reshape(n, E * C, d) * w.reshape(n, E * C, 1).to(dt)

    # combine: each token's kept outputs added in ascending expert order,
    # the order the reference's scatter-add applies them in
    _, by_expert = torch.sort(top_idx.reshape(n, T, k), dim=-1)
    pick = slot.gather(-1, by_expert)
    picked = ye.reshape(n * E * C, d).index_select(
        0, (pick.clamp(min=0) + (node * (E * C))[:, None, None]).reshape(-1)
    ).reshape(n, T, k, d)
    picked = torch.where((pick >= 0)[..., None], picked, 0.0)
    y = x.new_zeros((n, T, d))
    for j in range(k):
        y = y + picked[:, :, j]
    out = y.reshape(n, B, S, d)
    if m.n_shared:
        out = out + apply_mlp(_shared(params), x)
    return out, {"lb_loss": lb_loss, "drop_frac": drop_frac}


def apply_moe_dense_reference(params: PyTree, cfg: ModelConfig,
                              x: torch.Tensor) -> torch.Tensor:
    """Oracle: every expert on every token, combined with the routing
    weights.  O(E) products — tests and the card's check only (equals
    :func:`apply_moe` when nothing drops)."""
    m = cfg.moe
    dt = x.dtype
    top_w, top_idx, _ = route(params, m, x)
    combine = torch.zeros(top_w.shape[:-1] + (m.n_routed,),
                          dtype=top_w.dtype, device=x.device).scatter(
        -1, top_idx, top_w)                                   # (n,B,S,E)
    h_g = torch.einsum("nbsd,nedf->nbesf", x, params["w_gate"].to(dt))
    h_u = torch.einsum("nbsd,nedf->nbesf", x, params["w_up"].to(dt))
    h = torch.nn.functional.silu(h_g) * h_u
    y = torch.einsum("nbesf,nefd->nbesd", h, params["w_down"].to(dt))
    out = torch.einsum("nbesd,nbse->nbsd", y, combine.to(dt))
    if m.n_shared:
        out = out + apply_mlp(_shared(params), x)
    return out
