"""qwen2-0.5b [dense] — GQA (kv=2), QKV bias (counterpart of
``repro/configs/qwen2_0_5b.py``, same numbers).

Source: Qwen2 technical report [arXiv:2407.10671].
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, head_dim=64, qkv bias.
"""
from repro_torch.configs.base import ModelConfig

CITATION = "arXiv:2407.10671 (Qwen2)"


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        citation=CITATION,
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151_936,
        pattern=(("attn", "dense"),),
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-reduced",
        family="dense",
        citation=CITATION,
        n_layers=2,
        d_model=224,
        n_heads=7,
        n_kv_heads=1,
        head_dim=32,
        d_ff=448,
        vocab_size=512,
        pattern=(("attn", "dense"),),
        qkv_bias=True,
        tie_embeddings=True,
    ).validate()
