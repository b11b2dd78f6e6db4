"""qwen3-moe-30b-a3b [moe] — 128 routed experts, top-8, GQA kv=4
(counterpart of ``repro/configs/qwen3_moe_30b_a3b.py``, same numbers).

Source: [hf:Qwen/Qwen3-30B-A3B].
48L d_model=2048 32H (GQA kv=4) expert d_ff=768 vocab=151936, head_dim=128,
qk_norm (Qwen3 family), every layer MoE, no shared experts.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CITATION = "hf:Qwen/Qwen3-30B-A3B"


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        citation=CITATION,
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,             # unused by moe blocks; kept = expert width
        vocab_size=151_936,
        pattern=(("attn", "moe"),),
        qk_norm=True,
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_routed=128, top_k=8, d_ff_expert=768, n_shared=0),
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-reduced",
        family="moe",
        citation=CITATION,
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=128,
        vocab_size=512,
        pattern=(("attn", "moe"),),
        qk_norm=True,
        moe=MoEConfig(n_routed=4, top_k=2, d_ff_expert=128, n_shared=0),
    ).validate()
