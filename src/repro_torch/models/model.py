"""Top-level Model: init / forward / decode / loss for every family of the
reference: the dense decoder LMs (pga-lm-100m, gemma2-9b, the qwen
configs), the MoE decoders (deepseek-v2-lite-16b, qwen3-moe-30b-a3b), the
encoders (bert-large, hubert-xlarge), the xLSTM family, the hybrid
(jamba-1.5-large: Mamba, attention, MoE) and the VLM stub
(llava-next-mistral-7b) (counterpart of ``repro/models/model.py``).

Params keep the reference's layout — the same nested keys and, once
stacked for the nodes, the same ``(n, L, …)`` shapes — so a tree carries
across with ``repro_torch.interop``.  Every method takes node-stacked
params and inputs: :meth:`Model.node_losses` runs all n node replicas at
once (the reference ``vmap``s :meth:`Model.loss`), batch ``{"inputs",
"targets"}`` is ``(n, B, S)`` int (a VLM's may add float ``patches``
``(n, B, n_img, d)``, which take the place of the first ``n_img`` token
embeddings and weigh 0 in the loss); the serving methods (:meth:`forward`
with ``want_cache``, :meth:`decode_step`, :meth:`init_cache`) keep the
node axis on the caches too, ``(n, L, B, …)`` leaves.  :meth:`loss` and
``repro_torch.serve`` take one replica's tree and add a node axis of 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

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
        init_embedding(emb, cfg.vocab_size, cfg.d_model,
                       cfg.tie_embeddings)
        b.attach("embed", emb.params)
        if cfg.family == "encoder":
            b.add("mask_emb", (cfg.d_model,), init="normal")
        stack = ParamBuilder(generator, b.param_dtype, b.device)
        blocks.init_stack(stack, cfg)
        b.attach("stack", stack.params)
        init_rms_norm(b, "final_norm", cfg.d_model)
        return b.params

    def forward(self, params: PyTree, batch: Dict[str, torch.Tensor], *,
                mode: str = "train", remat: str = "none",
                want_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[PyTree], torch.Tensor]:
        """Node-stacked params and batch → ``(fp32 logits (n, B, S, V),
        caches or None, lb_loss (n,))``; mode train|prefill.  lb_loss is
        the MoE balance loss summed over the MoE blocks (zeros without
        one)."""
        if mode not in ("train", "prefill"):
            raise ValueError(f"forward: mode must be 'train' or 'prefill', "
                             f"got {mode!r} (decode: decode_step)")
        cfg = self.cfg
        h = self._embed_batch(params, batch, _DTYPES[cfg.dtype])
        _, B, S = h.shape[:3]
        positions = torch.arange(S, device=h.device)[None].expand(B, S)
        h, caches, lb_loss = blocks.apply_stack(
            params["stack"], cfg, h, mode=mode, positions=positions,
            remat=remat, want_cache=want_cache)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return self._unembed(params, h), caches, lb_loss

    def decode_step(self, params: PyTree, caches: PyTree,
                    tokens: torch.Tensor, pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, PyTree]:
        """One token per sequence: tokens ``(n, B, 1)`` int, pos ``(B,)``
        the position being written → ``(fp32 logits (n, B, 1, V),
        caches)``.  Attention caches are updated in place and returned
        (the reference returns new arrays); recurrent states are new
        tensors."""
        cfg = self.cfg
        h = self._embed(params, tokens, _DTYPES[cfg.dtype])
        h, caches, _ = blocks.apply_stack(params["stack"], cfg, h,
                                          mode="decode", caches=caches,
                                          pos=pos)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return self._unembed(params, h), caches

    # the reference ties the Gemma embedding scale to the final softcap
    def _embed(self, params: PyTree, tokens: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
        return embed_tokens(
            params["embed"], tokens, dtype,
            scale_by_dim=self.cfg.final_logit_softcap is not None)

    def _embed_batch(self, params: PyTree, batch: Dict[str, torch.Tensor],
                     dtype: torch.dtype) -> torch.Tensor:
        """The full-sequence input: token embeddings, or an audio
        encoder's frames; an encoder's masked positions take
        ``mask_emb``; a VLM's ``patches`` (cast to ``dtype``) take the
        first ``n_img`` positions.  A VLM batch shorter than its patches
        raises ``ValueError`` (the reference builds a sequence longer
        than its targets there and fails later)."""
        cfg = self.cfg
        if cfg.family == "encoder" and cfg.audio is not None:
            h = batch["frames"].to(dtype)
        else:
            h = self._embed(params, batch["inputs"], dtype)
        if cfg.family == "encoder":
            me = params["mask_emb"].to(dtype)[:, None, None, :]
            h = torch.where(batch["mask"][..., None], me, h)
        if cfg.family == "vlm" and "patches" in batch:
            n_img = self._n_img(batch)
            if h.shape[2] < n_img:
                raise ValueError(f"a VLM batch of {h.shape[2]} positions is "
                                 f"shorter than its {n_img} patches")
            h = torch.cat([batch["patches"].to(dtype), h[:, :, n_img:]],
                          dim=2)
        return h

    def _n_img(self, batch: Dict[str, torch.Tensor]) -> Optional[int]:
        """The image positions of a VLM batch with patches, else None."""
        if self.cfg.family == "vlm" and "patches" in batch:
            return batch["patches"].shape[2]
        return None

    def _unembed(self, params: PyTree, h: torch.Tensor) -> torch.Tensor:
        return unembed(params["embed"], h, self.cfg.tie_embeddings,
                       self.cfg.final_logit_softcap)

    def init_cache(self, batch: int, s_max: int,
                   dtype_name: Optional[str] = None, *,
                   device="cuda") -> PyTree:
        """One replica's empty caches for ``batch`` sequences of up to
        ``s_max`` positions, ``(1, L, batch, …)`` leaves."""
        return blocks.init_stack_cache(
            self.cfg, batch, s_max, _DTYPES[dtype_name or self.cfg.dtype],
            device)

    def node_losses(self, params: PyTree, batch: Dict[str, torch.Tensor], *,
                    remat: str = "none", z_loss: float = 0.0
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Per-node mean cross entropy (+ the MoE balance loss ×
        ``aux_coef``, + z-loss): ``(losses (n,), metrics of (n,))``.  A
        decoder averages over every position; an encoder over its masked
        positions only, a VLM with patches over its text positions only,
        each node by its own count ``max(Σ weights, 1)``, as the
        reference's per-node loss does."""
        logits, _, lb_loss = self.forward(params, batch, remat=remat)
        targets = batch["targets"].long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        n = nll.shape[0]
        weights = None
        n_img = self._n_img(batch)
        if self.cfg.family == "encoder":
            weights = batch["mask"].to(torch.float32).reshape(n, -1)
        elif n_img is not None:
            text = torch.arange(targets.shape[-1],
                                device=targets.device) >= n_img
            weights = text.to(torch.float32).expand(
                targets.shape).reshape(n, -1)
        if weights is not None:
            denom = torch.clamp(weights.sum(dim=1), min=1.0)
            ce = (nll.reshape(n, -1) * weights).sum(dim=1) / denom
        else:
            denom = max(float(nll[0].numel()), 1.0)
            ce = nll.reshape(n, -1).sum(dim=1) / denom
        total = ce
        metrics = {"ce": ce, "lb_loss": lb_loss}
        if self.cfg.moe is not None:
            total = total + self.cfg.moe.aux_coef * lb_loss
        if z_loss:
            lse2 = torch.square(torch.logsumexp(logits, dim=-1)).reshape(
                n, -1)
            if weights is not None:
                lse2 = lse2 * weights
            zl = lse2.sum(dim=1) / denom
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
