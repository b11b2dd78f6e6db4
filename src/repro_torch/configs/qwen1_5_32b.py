"""qwen1.5-32b [dense] — MHA (kv=40), QKV bias (counterpart of
``repro/configs/qwen1_5_32b.py``, same numbers).

Source: Qwen1.5 family [hf:Qwen/Qwen1.5-0.5B card for the family recipe;
32B variant dims].  64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064,
head_dim=128, qkv bias.
"""
from repro_torch.configs.base import ModelConfig

CITATION = "hf:Qwen/Qwen1.5-0.5B (Qwen1.5 family; 32B dims)"


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        citation=CITATION,
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        head_dim=128,
        d_ff=27392,
        vocab_size=152_064,
        pattern=(("attn", "dense"),),
        qkv_bias=True,
        rope_theta=1_000_000.0,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b-reduced",
        family="dense",
        citation=CITATION,
        n_layers=2,
        d_model=320,
        n_heads=5,
        n_kv_heads=5,
        head_dim=64,
        d_ff=640,
        vocab_size=512,
        pattern=(("attn", "dense"),),
        qkv_bias=True,
    ).validate()
