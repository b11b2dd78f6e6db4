"""Synthetic LM data stream (numpy copy of the decoder-LM path of
``repro/data/synthetic.py``): same seeds, same draws, so batches are
bit-identical to the reference's.

Deterministic, seeded batches with learnable structure (an affine
next-token map corrupted by noise); per-node vocabulary bias implements
the paper's non-iid regime.  Encoder and VLM batches come with those
model families (ROADMAP A.8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import DataConfig, ModelConfig, not_ported


@dataclasses.dataclass
class SyntheticStream:
    """get_batch(step) -> {"inputs", "targets"}, int32 (n, B, S)."""
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
        if cfg.family in ("encoder", "vlm"):
            raise not_ported(f"{cfg.family} batches", "A.8")
        rng = self._rng(step)
        tokens = self._sample_tokens(rng, cfg.vocab_size)
        return {"inputs": tokens,
                "targets": self._next_token_map(tokens, cfg.vocab_size,
                                                rng)}


def make_stream(model_cfg: ModelConfig, data_cfg: DataConfig, *,
                n_nodes: int, global_batch: int, seq_len: int
                ) -> SyntheticStream:
    if global_batch % n_nodes:
        raise ValueError(f"global_batch={global_batch} is not a multiple "
                         f"of n_nodes={n_nodes}")
    return SyntheticStream(model_cfg, data_cfg, n_nodes,
                           global_batch // n_nodes, seq_len)
