"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7, MoE 16e top-2
(counterpart of ``repro/configs/jamba_1_5_large.py``, same numbers).

Source: Jamba [arXiv:2403.19887] / Jamba-1.5 [arXiv:2408.12570].
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, head_dim=128.
Jamba block = 8 layers: attention at index 4, Mamba elsewhere; MoE replaces
the MLP on every other layer (odd indices), 16 experts top-2.  Params are
bfloat16 (the only such config).  At 398.6e9 params the full config fits
no card; the port serves it at full width with a shorter pattern
(``chip_smoke.py`` ``[jserve]``).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CITATION = "arXiv:2403.19887 (Jamba), arXiv:2408.12570 (Jamba-1.5)"

_JAMBA_BLOCK = (
    ("mamba", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("mamba", "moe"),
    ("attn",  "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("mamba", "moe"),
)


def full_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        citation=CITATION,
        n_layers=72,                       # 9 Jamba blocks of 8
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65_536,
        pattern=_JAMBA_BLOCK,
        moe=MoEConfig(n_routed=16, top_k=2, d_ff_expert=24576, n_shared=0),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        param_dtype="bfloat16",
    ).validate()


def long_context_config() -> ModelConfig:
    """The attention layers are 1/8 of the stack; for long-context decode
    the attention KV is the only S-proportional state, so the config runs
    as it is."""
    return full_config()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-reduced",
        family="hybrid",
        citation=CITATION,
        n_layers=8,                        # one Jamba block, reduced widths
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        pattern=_JAMBA_BLOCK,
        moe=MoEConfig(n_routed=4, top_k=2, d_ff_expert=512, n_shared=0),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    ).validate()
