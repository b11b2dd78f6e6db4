"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512), 2 shared + 64 routed
top-6 (counterpart of ``repro/configs/deepseek_v2_lite.py``, same
numbers).

Source: DeepSeek-V2 [arXiv:2405.04434], DeepSeek-V2-Lite variant.
27L d_model=2048 16H d_ff=1408(expert) vocab=102400; first layer dense MLP
(d_ff=10944), remaining 26 layers MoE.  MLA: kv_lora_rank=512, per-head
nope_dim=128 + rope_dim=64, v_dim=128, no q compression in -Lite.
64 routed + 2 shared experts, as the -Lite card specifies (160 routed is
the 236B DeepSeek-V2).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CITATION = "arXiv:2405.04434 (DeepSeek-V2 / -Lite)"

DENSE_D_FF = 10944  # first-layer dense MLP width (model card)


def full_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        citation=CITATION,
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,        # MLA: all heads share the compressed latent
        head_dim=128,         # nope head dim (MLA config carries the split)
        d_ff=DENSE_D_FF,      # dense (first-layer) MLP width
        vocab_size=102_400,
        prefix_pattern=(("attn", "dense"),),
        pattern=(("attn", "moe"),),
        moe=MoEConfig(n_routed=64, top_k=6, d_ff_expert=1408, n_shared=2),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                      rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-reduced",
        family="moe",
        citation=CITATION,
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        prefix_pattern=(("attn", "dense"),),
        pattern=(("attn", "moe"),),
        moe=MoEConfig(n_routed=4, top_k=2, d_ff_expert=128, n_shared=1),
        mla=MLAConfig(kv_lora_rank=64, q_lora_rank=None,
                      rope_head_dim=16, nope_head_dim=32, v_head_dim=32),
    ).validate()
