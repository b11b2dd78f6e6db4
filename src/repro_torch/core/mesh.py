"""Device meshes of the port (counterpart of ``jax.make_mesh`` /
``jax.sharding.Mesh`` as the reference uses them).

A :class:`Mesh` names its axes and their sizes, and gives every shard a
device.  This slice runs a mesh of k node shards on **one** device, in one
process, as the reference's suites run theirs on one physical CPU split
into forced host devices: the sharded rounds of ``core/mixing.py`` run the
shard body once per shard in a fixed order, a ``ppermute`` is a row-block
gather and a ``psum`` a fixed-order sum.  No interconnect is involved.

Not ported yet (both raise ``NotImplementedError``, ROADMAP A.10): shards
on more than one physical device (the ``torch.distributed``/NCCL
exchange), and a model axis of more than one shard (2-D ``(node, model)``
meshes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import not_ported


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes over shards that all sit on ``device``."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes, dtype=np.int64))

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """One device per shard, row-major over the axes."""
        return (self.device,) * self.size


def _physical(device) -> Tuple[str, int]:
    """``(type, index)`` of a device, an unindexed card read as card 0."""
    dev = torch.device(device)
    return dev.type, 0 if dev.index is None else dev.index


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device="cuda",
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``prod(axis_shapes)`` shards on one device.

    ``device`` is resolved as every entry point of the port resolves it
    (the card unless ``"cpu"`` is passed).  ``devices`` optionally names a
    device per shard; they must all be the same device.
    """
    shapes = tuple(int(s) for s in axis_shapes)
    names = tuple(axis_names)
    if len(shapes) != len(names):
        raise ValueError(f"make_mesh: {len(shapes)} axis sizes for "
                         f"{len(names)} axis names")
    if len(set(names)) != len(names):
        raise ValueError(f"make_mesh: repeated axis name in {names}")
    if any(s < 1 for s in shapes):
        raise ValueError(f"make_mesh: axis sizes must be >= 1, got {shapes}")
    if devices is not None:
        if len(devices) != int(np.prod(shapes, dtype=np.int64)):
            raise ValueError(f"make_mesh: {len(devices)} devices for a mesh "
                             f"of {shapes}")
        if len({_physical(d) for d in devices}) > 1:
            raise not_ported("meshes over several cards "
                             "(torch.distributed/NCCL)", "A.10")
        device = devices[0]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dict(zip(names, shapes)).get("model", 1) > 1:
        # the reference's tensor-parallel axis (DistConfig.model_axis)
        raise not_ported("2-D (node, model) meshes", "A.10")
    return Mesh(axis_names=names, axis_sizes=shapes, device=dev)
