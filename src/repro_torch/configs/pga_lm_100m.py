"""pga-lm-100m — the end-to-end training-driver model (counterpart of
``repro/configs/pga_lm_100m.py``, same numbers).

A GPT-style dense decoder: 12L d_model=768 12H d_ff=3072 (gated MLP)
vocab=32768, tied embeddings.  By its init shapes that is 138.4M
parameters (the reference docstring's "~110M" undercounts the three
3072-wide MLP matrices per layer).
"""
from repro_torch.configs.base import ModelConfig

CITATION = "framework driver config (GPT-2-small-like dims)"


def full_config() -> ModelConfig:
    return ModelConfig(
        name="pga-lm-100m",
        family="dense",
        citation=CITATION,
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=32_768,
        pattern=(("attn", "dense"),),
        tie_embeddings=True,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="pga-lm-reduced",
        family="dense",
        citation=CITATION,
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        pattern=(("attn", "dense"),),
        tie_embeddings=True,
    ).validate()
