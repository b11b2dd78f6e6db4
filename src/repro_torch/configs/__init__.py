"""Config registry of the port: ``--arch <id>`` resolution.

Only the architectures the port can run are listed, and gemma2-9b, whose
widths give the substrate kernels' full-width shapes (its model is
refused until ROADMAP A.8); the reference's other archs arrive with their
model families (A.8).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401 (public re-exports)
    DataConfig,
    DistConfig,
    ModelConfig,
    OptimizerConfig,
    SSMConfig,
    TrainConfig,
)

_ARCH_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "pga-lm-100m": "pga_lm_100m",
    "xlstm-125m": "xlstm_125m",
}


def get_model_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; the port knows {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.reduced_config() if reduced else mod.full_config()


def list_archs() -> tuple:
    return tuple(_ARCH_MODULES)
