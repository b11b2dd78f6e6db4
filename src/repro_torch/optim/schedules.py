"""Learning-rate schedules (copy of ``repro/optim/schedules.py``): warmup
+ step decay, warmup + poly decay, warmup + cosine, constant."""
from __future__ import annotations

import math
from typing import Callable

from repro_torch.configs.base import OptimizerConfig


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    base = cfg.lr
    warm = max(cfg.warmup_steps, 0)
    total = max(cfg.total_steps, warm + 1)

    def warmup(step: int) -> float:
        if warm and step < warm:
            return base * (step + 1) / warm
        return base

    if cfg.schedule == "constant":
        return warmup

    if cfg.schedule == "warmup_cosine":
        def fn(step: int) -> float:
            if warm and step < warm:
                return warmup(step)
            t = (step - warm) / max(total - warm, 1)
            t = min(max(t, 0.0), 1.0)
            floor = cfg.min_lr_ratio * base
            return floor + (base - floor) * 0.5 * (1 + math.cos(math.pi * t))
        return fn

    if cfg.schedule == "warmup_poly":
        def fn(step: int) -> float:
            if warm and step < warm:
                return warmup(step)
            t = (step - warm) / max(total - warm, 1)
            t = min(max(t, 0.0), 1.0)
            return base * (1 - t)
        return fn

    if cfg.schedule == "step":
        def fn(step: int) -> float:
            lr = warmup(step)
            for boundary in cfg.decay_steps:
                if step >= boundary:
                    lr *= cfg.decay_factor
            return lr
        return fn

    raise ValueError(f"unknown schedule {cfg.schedule!r}")
