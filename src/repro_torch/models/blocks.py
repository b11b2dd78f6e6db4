"""Transformer block assembly over layer-stacked parameters (counterpart
of the dense path of ``repro/models/blocks.py``).

A block is pre-norm attention + residual, then pre-norm gated MLP +
residual.  Parameters keep the reference's scan layout
``{"scan": {"entry_0": stacked}}`` with the layer axis right after the
node axis; :func:`apply_stack` loops over it where the reference scans.
With ``remat="default"`` each block runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig, not_ported
from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamBuilder, apply_mlp, init_mlp,
                                       init_rms_norm, rms_norm)

PyTree = Any


def check_supported(cfg: ModelConfig) -> None:
    """Raise for every model feature outside the ported dense path."""
    if cfg.family != "dense" or any(
            c is not None for c in (cfg.moe, cfg.mla, cfg.ssm, cfg.vision,
                                    cfg.audio)):
        raise not_ported(f"model family {cfg.family!r}", "A.8")
    unported = [name for name, on in (
        ("prefix_pattern", bool(cfg.prefix_pattern)),
        ("qk_norm", cfg.qk_norm), ("qkv_bias", cfg.qkv_bias),
        ("attn_logit_softcap", cfg.attn_logit_softcap is not None),
        ("final_logit_softcap", cfg.final_logit_softcap is not None),
        ("sliding_window", cfg.sliding_window is not None),
        ("post_block_norm", cfg.post_block_norm),
        ("untied embeddings", not cfg.tie_embeddings),
        ("non-causal attention", not cfg.causal)) if on]
    if unported:
        raise not_ported(f"model features {unported}", "A.8")
    if any(kind != ("attn", "dense") for kind in cfg.layers):
        raise not_ported(f"block kinds {sorted(set(cfg.layers))}", "A.8")


def init_block(b: ParamBuilder, cfg: ModelConfig, kind: BlockSpec) -> None:
    """One ("attn", "dense") block's params into builder ``b``."""
    init_rms_norm(b, "ln1", cfg.d_model)
    mixer = ParamBuilder(b.generator, b.param_dtype, b.device)
    attn.init_attention(mixer, cfg)
    b.attach("mixer", mixer.params)
    init_rms_norm(b, "ln2", cfg.d_model)
    ffn = ParamBuilder(b.generator, b.param_dtype, b.device)
    init_mlp(ffn, cfg.d_model, cfg.d_ff)
    b.attach("ffn", ffn.params)


def apply_block(params: PyTree, cfg: ModelConfig, kind: BlockSpec,
                x: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    out, _ = attn.attn_forward(params["mixer"], cfg, h, layer_kind=kind[0],
                               positions=positions)
    x = x + out
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    return x + apply_mlp(params["ffn"], h)


def _layer(tree: PyTree, i: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[:, i]


def apply_stack(params: PyTree, cfg: ModelConfig, x: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                remat: str = "none") -> torch.Tensor:
    """Apply the scanned pattern repeats; params
    ``{"scan": {"entry_<j>": (n, L, …) stacked}}``."""
    if remat not in ("none", "default"):
        raise not_ported(f"remat policy {remat!r}", "A.8")
    scan = params["scan"]
    for i in range(cfg.n_scan_blocks):
        for j, kind in enumerate(cfg.pattern):
            block = _layer(scan[f"entry_{j}"], i)

            def run(h, block=block, kind=kind):
                return apply_block(block, cfg, kind, h, positions=positions)

            if remat == "none":
                x = run(x)
            else:
                x = checkpoint(run, x, use_reentrant=False)
    return x


def init_stack(b: ParamBuilder, cfg: ModelConfig) -> None:
    """``{"scan": {"entry_<j>": (L, …)}}`` into builder ``b``; layers are
    drawn one after another and stacked on a leading layer axis."""
    scan = {}
    for j, kind in enumerate(cfg.pattern):
        layers = []
        for _ in range(cfg.n_scan_blocks):
            one = ParamBuilder(b.generator, b.param_dtype, b.device)
            init_block(one, cfg, kind)
            layers.append(one.params)
        scan[f"entry_{j}"] = _stack(layers)
    b.attach("scan", scan)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees, dim=0)
