"""gemma2-9b [dense] — local+global alternating attention, logit softcaps
(counterpart of ``repro/configs/gemma2_9b.py``, same numbers).

Source: Gemma 2 technical report [arXiv:2408.00118].
42L d_model=3584 16H (GQA kv=8, head_dim=256) d_ff=14336 vocab=256000,
sliding window 4096 on every other layer, attn softcap 50, final softcap 30.

The port's model runs it: the sliding window on the ``attn_sw`` layers,
both softcaps, the post-block norms and the embedding scale.  Its widths
also give the substrate kernels' full-width shapes (``kernels.ops``,
``chip_smoke.py``).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CITATION = "arXiv:2408.00118 (Gemma 2)"


def full_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        citation=CITATION,
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256_000,
        pattern=(("attn_sw", "dense"), ("attn", "dense")),
        sliding_window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        post_block_norm=True,
        tie_embeddings=True,
        rope_theta=10_000.0,
    ).validate()


def long_context_config() -> ModelConfig:
    """Long-context variant: the global-attention layers switched to the
    sliding window, so the KV working set is bounded (the reference's
    documented deviation)."""
    return dataclasses.replace(
        full_config(), name="gemma2-9b-sw",
        pattern=(("attn_sw", "dense"),)).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-reduced",
        family="dense",
        citation=CITATION,
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        pattern=(("attn_sw", "dense"), ("attn", "dense")),
        sliding_window=64,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        post_block_norm=True,
        tie_embeddings=True,
    ).validate()
