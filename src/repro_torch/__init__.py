"""PyTorch/CUDA port of the Gossip-PGA system (``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
layout module for module and imports nothing of it.  Its entry points run
on CUDA unless the caller passes ``device="cpu"`` — there is no silent
fallback to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``"cuda"`` (the default everywhere in the port) raises when this
    process sees no CUDA device; only an explicit ``"cpu"`` runs on the
    CPU, where the kernel wrappers take their plain PyTorch versions.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch sees no CUDA "
            "device; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch: unsupported device {device!r}")
    return dev
