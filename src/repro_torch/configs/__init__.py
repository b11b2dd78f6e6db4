"""Config registry of the port: ``--arch <id>`` resolution.

The reference's twelve archs under its ids: the dense decoders
(pga-lm-100m, gemma2-9b, qwen3-0.6b, qwen2-0.5b, qwen1.5-32b), the
encoders (bert-large, hubert-xlarge), the MoE decoders
(deepseek-v2-lite-16b with MLA and a dense prefix layer,
qwen3-moe-30b-a3b), xlstm-125m, the hybrid jamba-1.5-large-398b (Mamba,
attention and MoE) and the VLM llava-next-mistral-7b.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401 (public re-exports)
    AudioStubConfig,
    DataConfig,
    DistConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    SSMConfig,
    TrainConfig,
    VisionStubConfig,
)

_ARCH_MODULES = {
    "bert-large": "bert_large",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "gemma2-9b": "gemma2_9b",
    "hubert-xlarge": "hubert_xlarge",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "pga-lm-100m": "pga_lm_100m",
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "xlstm-125m": "xlstm_125m",
}


def get_model_config(arch: str, *, reduced: bool = False,
                     long_context: bool = False) -> ModelConfig:
    """``long_context`` takes the module's ``long_context_config`` where it
    has one (gemma2-9b, jamba) and is ignored elsewhere, as in the
    reference."""
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; the port knows {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    if long_context and hasattr(mod, "long_context_config"):
        return mod.long_context_config()
    return mod.reduced_config() if reduced else mod.full_config()


def list_archs() -> tuple:
    return tuple(_ARCH_MODULES)
