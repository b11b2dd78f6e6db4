"""Top-level Model: init / forward / loss for the dense decoder LM
(counterpart of ``repro/models/model.py``).

Params keep the reference's layout — the same nested keys and, once
stacked for the nodes, the same ``(n, L, …)`` shapes — so a tree carries
across with ``repro_torch.interop``.  :meth:`Model.node_losses` runs all n
node replicas at once (the reference ``vmap``s :meth:`Model.loss`); batch
``{"inputs", "targets"}`` is ``(n, B, S)`` int.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.layers import (ParamBuilder, embed_tokens,
                                       init_embedding, init_rms_norm,
                                       rms_norm, unembed)
from repro_torch.tree import tree_map

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator, device="cuda") -> PyTree:
        """One replica's params, drawn from ``generator`` (a CPU
        ``torch.Generator``) and placed on ``device``."""
        cfg = self.cfg
        b = ParamBuilder(generator, _DTYPES[cfg.param_dtype], device)
        emb = ParamBuilder(generator, b.param_dtype, b.device)
        init_embedding(emb, cfg.vocab_size, cfg.d_model)
        b.attach("embed", emb.params)
        stack = ParamBuilder(generator, b.param_dtype, b.device)
        blocks.init_stack(stack, cfg)
        b.attach("stack", stack.params)
        init_rms_norm(b, "final_norm", cfg.d_model)
        return b.params

    def forward(self, params: PyTree, batch: Dict[str, torch.Tensor], *,
                remat: str = "none") -> torch.Tensor:
        """Node-stacked params and batch → fp32 logits (n, B, S, V)."""
        cfg = self.cfg
        dtype = _DTYPES[cfg.dtype]
        h = embed_tokens(params["embed"], batch["inputs"], dtype)
        _, B, S = batch["inputs"].shape
        positions = torch.arange(S, device=h.device)[None].expand(B, S)
        h = blocks.apply_stack(params["stack"], cfg, h, positions=positions,
                               remat=remat)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return unembed(params["embed"], h)

    def node_losses(self, params: PyTree, batch: Dict[str, torch.Tensor], *,
                    remat: str = "none", z_loss: float = 0.0
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Per-node mean next-token cross entropy (+ z-loss): ``(losses
        (n,), metrics of (n,))``."""
        logits = self.forward(params, batch, remat=remat)
        targets = batch["targets"].long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        n = nll.shape[0]
        denom = max(float(nll[0].numel()), 1.0)
        ce = nll.reshape(n, -1).sum(dim=1) / denom
        total = ce
        metrics = {"ce": ce, "lb_loss": torch.zeros_like(ce)}
        if z_loss:
            lse = torch.logsumexp(logits, dim=-1)
            zl = torch.square(lse).reshape(n, -1).sum(dim=1) / denom
            total = total + z_loss * zl
            metrics["z_loss"] = zl
        metrics["loss"] = total
        return total, metrics

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor], *,
             remat: str = "none", z_loss: float = 0.0
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One replica's loss on a ``(B, S)`` batch (the reference's
        ``Model.loss`` call shape)."""
        def one(t):
            return t[None]

        losses, metrics = self.node_losses(
            tree_map(one, params), tree_map(one, batch), remat=remat,
            z_loss=z_loss)
        return losses[0], {k: v[0] for k, v in metrics.items()}


def make_model(cfg: ModelConfig) -> Model:
    cfg = cfg.validate()
    blocks.check_supported(cfg)
    return Model(cfg)
