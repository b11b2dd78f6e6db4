"""Block assembly over layer-stacked parameters (counterpart of
``repro/models/blocks.py``) for every block kind of the reference: the
mixers attention (GQA, global or sliding-window, or MLA; causal or not),
Mamba, mLSTM and sLSTM, and the FFNs gated MLP, MoE or none.

A block is a pre-norm mixer + residual, then, unless its FFN is
``"none"``, a pre-norm gated MLP (SiLU; GELU's tanh form, ``jax.nn.gelu``'s
default, in the encoder) or MoE (``models/moe.py``) + residual; with
``post_block_norm`` each branch's output is normed before its residual add
(Gemma 2).  A model is an unscanned ``prefix_pattern`` (params
``{"prefix_<i>": block}``, no layer axis) followed by the scanned pattern
repeats in the reference's layout ``{"scan": {"entry_<j>": stacked}}``
with the layer axis right after the node axis; :func:`apply_stack` applies
the prefix blocks, then loops over the layer axis where the reference
scans, and returns the caches in the same layout (``(n, B, …)`` prefix
leaves, ``(n, L, B, …)`` scanned ones) and the summed MoE balance loss
``(n,)``.  Decode writes attention KV (or MLA latent) rows in place into
the caches it is given and returns those tensors; recurrent states are
returned as new tensors.  With ``remat="default"`` or ``"dots"`` each
scanned training block runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scan body; the prefix blocks are
not rematerialized, as in the reference), see :func:`make_remat`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (ParamBuilder, apply_mlp, init_mlp,
                                       init_rms_norm, rms_norm)
from repro_torch.tree import tree_flatten, tree_unflatten

PyTree = Any
MODES = ("train", "prefill", "decode")
REMAT_POLICIES = ("none", "default", "dots")
# the recurrent mixers: (init, forward, decode, init_state) each
RECURRENT = {"mamba": (ssm_lib.init_mamba, ssm_lib.mamba_forward,
                       ssm_lib.mamba_decode, ssm_lib.init_mamba_state),
             "mlstm": (ssm_lib.init_mlstm, ssm_lib.mlstm_forward,
                       ssm_lib.mlstm_decode, ssm_lib.init_mlstm_state),
             "slstm": (ssm_lib.init_slstm, ssm_lib.slstm_forward,
                       ssm_lib.slstm_decode, ssm_lib.init_slstm_state)}


def check_supported(cfg: ModelConfig) -> None:
    """Every block kind, family and stub of the reference builds, as it
    does there.  ``q_lora_rank`` raises ``ValueError``: the reference
    defines no params for a compressed query."""
    if cfg.mla is not None and cfg.mla.q_lora_rank is not None:
        raise ValueError(
            f"MLAConfig.q_lora_rank={cfg.mla.q_lora_rank}: the reference "
            f"defines no params for a compressed query (q is projected at "
            f"full rank); use q_lora_rank=None")


def init_block(b: ParamBuilder, cfg: ModelConfig, kind: BlockSpec) -> None:
    """One block's params into builder ``b``."""
    mixer_kind, ffn_kind = kind
    init_rms_norm(b, "ln1", cfg.d_model)
    mixer = ParamBuilder(b.generator, b.param_dtype, b.device)
    if mixer_kind in attn.LAYER_KINDS:
        attn.init_attention(mixer, cfg)
    else:
        RECURRENT[mixer_kind][0](mixer, cfg)
    b.attach("mixer", mixer.params)
    if cfg.post_block_norm:
        init_rms_norm(b, "post_ln1", cfg.d_model)
    if ffn_kind != "none":
        init_rms_norm(b, "ln2", cfg.d_model)
        ffn = ParamBuilder(b.generator, b.param_dtype, b.device)
        if ffn_kind == "moe":
            moe_lib.init_moe(ffn, cfg)
        else:
            init_mlp(ffn, cfg.d_model, cfg.d_ff)
        b.attach("ffn", ffn.params)
        if cfg.post_block_norm:
            init_rms_norm(b, "post_ln2", cfg.d_model)


def apply_block(params: PyTree, cfg: ModelConfig, kind: BlockSpec,
                x: torch.Tensor, *, mode: str,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[PyTree] = None,
                pos: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[PyTree],
                           Optional[torch.Tensor]]:
    """Returns ``(x, new_cache, lb_loss)``, ``lb_loss`` the MoE balance
    loss ``(n,)`` (None without an MoE FFN).  mode: train|prefill|decode;
    decode takes x ``(n, B, 1, d)``, the block's ``cache`` and, for
    attention, ``pos`` ``(B,)``, the position each sequence writes."""
    mixer, ffn = kind
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if mixer in attn.LAYER_KINDS:
        out, new_cache = (
            attn.attn_decode(params["mixer"], cfg, h, cache, pos,
                             layer_kind=mixer)
            if mode == "decode" else
            attn.attn_forward(params["mixer"], cfg, h, layer_kind=mixer,
                              positions=positions))
    else:
        _, forward, decode, _ = RECURRENT[mixer]
        out, new_cache = (decode(params["mixer"], cfg, h, cache)
                          if mode == "decode" else
                          forward(params["mixer"], cfg, h))
    if cfg.post_block_norm:
        out = rms_norm(out, params["post_ln1"], cfg.norm_eps)
    x = x + out
    lb_loss = None
    if ffn != "none":
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        if ffn == "moe":
            out, moe_metrics = moe_lib.apply_moe(params["ffn"], cfg, h)
            lb_loss = moe_metrics["lb_loss"]
        else:
            out = apply_mlp(params["ffn"], h,
                            act=_gelu if cfg.family == "encoder" else F.silu)
        if cfg.post_block_norm:
            out = rms_norm(out, params["post_ln2"], cfg.norm_eps)
        x = x + out
    return x, new_cache, lb_loss


# jax.nn.gelu's default is the tanh form; F.gelu's is erf
_gelu = functools.partial(F.gelu, approximate="tanh")


def make_remat(fn, policy: str):
    """``fn`` under the reference's remat ``policy`` (one of
    :data:`REMAT_POLICIES`, checked by :func:`apply_stack`): ``"none"``
    runs it as it is; ``"default"`` and ``"dots"`` checkpoint it, saving
    only its inputs (``jax.checkpoint``).  ``"dots"`` is the reference's
    ``dots_with_no_batch_dims_saveable``, which saves products without
    batch dimensions; under the reference Trainer's ``jax.vmap`` over the
    nodes every product has one, and
    ``jax.ad_checkpoint.print_saved_residuals`` shows it keeps the same
    residuals as ``"default"``.  Every product of the port's node-stacked
    blocks is batched over the nodes too, so the same plain checkpoint is
    its counterpart (``ROADMAP`` C.3)."""
    if policy == "none":
        return fn

    def remat(*args):
        return checkpoint(fn, *args, use_reentrant=False)

    return remat


def _layer(tree: PyTree, i: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[:, i]


def _add_lb(total, lb):
    """The running balance loss: ``0 + a`` is ``a`` exactly, so starting
    from the first MoE block's is the reference's sum from zero."""
    if lb is None:
        return total
    return lb if total is None else total + lb


def apply_stack(params: PyTree, cfg: ModelConfig, x: torch.Tensor, *,
                mode: str = "train",
                positions: Optional[torch.Tensor] = None,
                caches: Optional[PyTree] = None,
                pos: Optional[torch.Tensor] = None,
                remat: str = "none",
                want_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[PyTree], torch.Tensor]:
    """Apply the prefix blocks, then the scanned pattern repeats; params
    ``{"prefix_<i>": (n, …), "scan": {"entry_<j>": (n, L, …) stacked}}``.
    Returns ``(x, caches, total_lb)``, ``total_lb`` the blocks' MoE balance
    losses summed in the reference's order ``(n,)``, zeros without one.  With ``want_cache``
    or in decode mode, caches ``{"prefix_<i>": (n, B, …), "scan":
    {"entry_<j>": (n, L, B, …) stacked}}``, else None.  Decode reads the
    same layout from ``caches``; an attention entry's leaves are written
    in place and returned as they were given, a recurrent entry's are
    restacked from the new states."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat policy must be one of {REMAT_POLICIES}, "
                         f"got {remat!r}")
    need_cache = want_cache or mode == "decode"
    total_lb = None
    out_caches: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.prefix_pattern):
        name = f"prefix_{i}"
        x, c_out, lb = apply_block(
            params[name], cfg, kind, x, mode=mode, positions=positions,
            cache=caches[name] if mode == "decode" else None, pos=pos)
        total_lb = _add_lb(total_lb, lb)
        if need_cache:
            out_caches[name] = c_out
    scan = params["scan"]
    outs: Dict[int, list] = {j: [] for j in range(len(cfg.pattern))}
    for i in range(cfg.n_scan_blocks):
        for j, kind in enumerate(cfg.pattern):
            block = _layer(scan[f"entry_{j}"], i)
            cache = (_layer(caches["scan"][f"entry_{j}"], i)
                     if mode == "decode" else None)

            def run(h, block=block, kind=kind, cache=cache):
                return apply_block(block, cfg, kind, h, mode=mode,
                                   positions=positions, cache=cache,
                                   pos=pos)

            if remat != "none" and mode == "train" and not need_cache:
                x, lb = make_remat(
                    lambda h, run=run: run(h)[::2], remat)(x)
            else:
                x, c_out, lb = run(x)
                if need_cache:
                    outs[j].append(c_out)
            total_lb = _add_lb(total_lb, lb)
    if total_lb is None:
        total_lb = torch.zeros(x.shape[0], dtype=torch.float32,
                               device=x.device)
    if not need_cache:
        return x, None, total_lb
    out_caches["scan"] = {
        f"entry_{j}": (caches["scan"][f"entry_{j}"]
                       if mode == "decode" and kind[0] in attn.LAYER_KINDS
                       else _stack(outs[j], dim=1))
        for j, kind in enumerate(cfg.pattern)}
    return x, out_caches, total_lb


def init_stack(b: ParamBuilder, cfg: ModelConfig) -> None:
    """``{"prefix_<i>": block, "scan": {"entry_<j>": (L, …)}}`` into
    builder ``b``; blocks are drawn one after another on the host and
    copied to ``b.device``, a scanned layer into its slot of the stacked
    leaves, so the device holds the stack and no per-layer copy
    (gemma2-9b's 37 GB of fp32 params, not 54 at the peak)."""
    for i, kind in enumerate(cfg.prefix_pattern):
        one = ParamBuilder(b.generator, b.param_dtype, "cpu")
        init_block(one, cfg, kind)
        leaves, treedef = tree_flatten(one.params)
        b.attach(f"prefix_{i}", tree_unflatten(
            treedef, [t.to(b.device) for t in leaves]))
    scan = {}
    for j, kind in enumerate(cfg.pattern):
        stacked = None
        for i in range(cfg.n_scan_blocks):
            one = ParamBuilder(b.generator, b.param_dtype, "cpu")
            init_block(one, cfg, kind)
            leaves, treedef = tree_flatten(one.params)
            if stacked is None:
                stacked = [torch.empty((cfg.n_scan_blocks,) + t.shape,
                                       dtype=t.dtype, device=b.device)
                           for t in leaves]
            for dst, src in zip(stacked, leaves):
                dst[i].copy_(src)
        scan[f"entry_{j}"] = tree_unflatten(treedef, stacked)
    b.attach("scan", scan)


def _stack(trees, dim: int = 0):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], dim) for k in trees[0]}
    return torch.stack(trees, dim=dim)


# ---------------------------------------------------------------------------
# Cache allocation
# ---------------------------------------------------------------------------
def init_block_cache(cfg: ModelConfig, kind: BlockSpec, batch: int,
                     s_max: int, dtype: torch.dtype, device) -> PyTree:
    """One block's empty cache, ``(B, …)`` leaves: the KV cache of
    ``s_max`` positions, or the recurrent state."""
    mixer, _ = kind
    if mixer in attn.LAYER_KINDS:
        return attn.init_attn_cache(cfg, batch, s_max, dtype, device, mixer)
    return RECURRENT[mixer][3](cfg, batch, dtype, device)


def init_stack_cache(cfg: ModelConfig, batch: int, s_max: int,
                     dtype: torch.dtype, device) -> PyTree:
    """Every layer's empty cache for one replica, ``{"prefix_<i>": (1, B,
    …), "scan": {"entry_<j>": (1, L, B, …)}}`` — the layout
    :func:`apply_stack` returns and decode reads, with a node axis of
    1."""
    caches: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.prefix_pattern):
        one = init_block_cache(cfg, kind, batch, s_max, dtype, device)
        caches[f"prefix_{i}"] = {k: t[None] for k, t in one.items()}
    lead = (1, cfg.n_scan_blocks)
    scan = {}
    for j, kind in enumerate(cfg.pattern):
        one = init_block_cache(cfg, kind, batch, s_max, dtype, device)
        scan[f"entry_{j}"] = {
            k: t.expand(lead + t.shape).clone() for k, t in one.items()}
    caches["scan"] = scan
    return caches
