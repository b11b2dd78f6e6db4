"""Synthetic data stream (numpy copy of the decoder-LM, encoder and VLM paths
of ``repro/data/synthetic.py``): same seeds, same draws in the same
order, so batches are bit-identical to the reference's.

Deterministic, seeded batches with learnable structure (an affine
next-token map corrupted by noise); per-node vocabulary bias implements
the paper's non-iid regime.  A text encoder's batch adds the masked
positions (15%); an audio encoder's carries frame embeddings that encode
the unit to predict, and masks ``mask_prob · mask_span / 2`` of them.  A VLM
batch adds float32 ``patches`` ``(n, B, n_img, d_model)`` × 0.02, drawn
right after the targets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import DataConfig, ModelConfig


@dataclasses.dataclass
class SyntheticStream:
    """get_batch(step) -> {"inputs", "targets"}, int32 (n, B, S); an
    encoder adds the boolean ``mask``; an audio encoder has float32
    ``frames`` (n, B, S, d_model) in place of ``inputs``; a VLM adds
    float32 ``patches`` (n, B, n_img, d_model)."""
    model_cfg: ModelConfig
    data_cfg: DataConfig
    n_nodes: int
    per_node_batch: int
    seq_len: int
    noise: float = 0.15          # fraction of corrupted next-token targets

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.data_cfg.seed, step]))

    def _node_logits(self, vocab: int) -> np.ndarray:
        """Per-node unigram biases (non-iid): node i prefers a vocab band."""
        if not self.data_cfg.non_iid or self.n_nodes == 1:
            return np.zeros((self.n_nodes, vocab))
        rng = np.random.default_rng(self.data_cfg.seed)
        centers = rng.uniform(0, vocab, size=self.n_nodes)
        pos = np.arange(vocab)[None, :]
        width = vocab / 4.0
        dist = np.minimum(np.abs(pos - centers[:, None]),
                          vocab - np.abs(pos - centers[:, None]))
        return -self.data_cfg.non_iid_alpha * (dist / width) ** 2

    def _sample_tokens(self, rng, vocab: int) -> np.ndarray:
        n, b, s = self.n_nodes, self.per_node_batch, self.seq_len
        logits = self._node_logits(vocab)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        toks = np.stack([
            rng.choice(vocab, size=(b, s), p=p[i]) for i in range(n)])
        return toks.astype(np.int32)

    def _next_token_map(self, tokens: np.ndarray, vocab: int,
                        rng) -> np.ndarray:
        """targets[t] = (a*inputs[t] + c) mod V, with noise."""
        a, c = 31, 17
        tgt = (a * tokens + c) % vocab
        corrupt = rng.random(tgt.shape) < self.noise
        tgt = np.where(corrupt, rng.integers(0, vocab, tgt.shape), tgt)
        return tgt.astype(np.int32)

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.model_cfg
        rng = self._rng(step)
        V = cfg.vocab_size
        if cfg.family == "encoder" and cfg.audio is not None:
            n, b, s = self.n_nodes, self.per_node_batch, self.seq_len
            d = cfg.d_model
            targets = self._sample_tokens(rng, V)
            # frame embeddings carry the unit identity (learnable)
            basis = np.random.default_rng(self.data_cfg.seed).standard_normal(
                (V, d)).astype(np.float32) / np.sqrt(d)
            frames = basis[targets] + 0.1 * rng.standard_normal(
                (n, b, s, d)).astype(np.float32)
            mask = (rng.random((n, b, s))
                    < cfg.audio.mask_prob * cfg.audio.mask_span / 2)
            return {"frames": frames.astype(np.float32), "mask": mask,
                    "targets": targets}
        tokens = self._sample_tokens(rng, V)
        batch = {"inputs": tokens,
                 "targets": self._next_token_map(tokens, V, rng)}
        if cfg.family == "encoder":
            batch["mask"] = rng.random(tokens.shape) < 0.15
        if cfg.family == "vlm" and cfg.vision is not None:
            n_img = cfg.vision.n_tiles * cfg.vision.patches_per_tile
            n, b = self.n_nodes, self.per_node_batch
            batch["patches"] = rng.standard_normal(
                (n, b, n_img, cfg.d_model)).astype(np.float32) * 0.02
        return batch


def make_stream(model_cfg: ModelConfig, data_cfg: DataConfig, *,
                n_nodes: int, global_batch: int, seq_len: int
                ) -> SyntheticStream:
    if global_batch % n_nodes:
        raise ValueError(f"global_batch={global_batch} is not a multiple "
                         f"of n_nodes={n_nodes}")
    return SyntheticStream(model_cfg, data_cfg, n_nodes,
                           global_batch // n_nodes, seq_len)
