"""qwen3-0.6b [dense] — qk-norm GQA (counterpart of
``repro/configs/qwen3_0_6b.py``, same numbers).

Source: Qwen3 model family [hf:Qwen/Qwen3-8B family card; 0.6B variant].
28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, head_dim=128, qk_norm.
"""
from repro_torch.configs.base import ModelConfig

CITATION = "hf:Qwen/Qwen3-8B (Qwen3 family card; 0.6B variant)"


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        citation=CITATION,
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151_936,
        pattern=(("attn", "dense"),),
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-reduced",
        family="dense",
        citation=CITATION,
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        pattern=(("attn", "dense"),),
        qk_norm=True,
        tie_embeddings=True,
    ).validate()
