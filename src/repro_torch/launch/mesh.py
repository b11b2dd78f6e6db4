"""Production mesh descriptions (counterpart of ``repro/launch/mesh.py``).

A function, not a module-level constant: importing this module touches no
device.  The node-axis and model-axis semantics (which mesh axes a gossip
node spans under ``DistConfig.node_axis``, which one the 2-D rounds slice
columns over) live in ``repro_torch.core.mixing``, re-exported here for
launchers, so the rounds and the launch helpers cannot disagree.
"""
from __future__ import annotations

from repro_torch.core.mesh import Mesh, make_mesh
from repro_torch.core.mixing import (model_axis_names,  # noqa: F401
                                     model_shard_count, node_axis_names,
                                     node_shard_count)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's production mesh, ``(data=16, model=16)`` or
    ``(pod=2, data=16, model=16)``, as a local mesh description on
    ``device`` (every block in this process; ``"meta"`` for the
    dry-run's description)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def n_gossip_nodes(mesh: Mesh, node_axis: str) -> int:
    """Gossip node count of a mesh under ``DistConfig.node_axis`` ("data"
    flattens (pod, data); "pod" is hierarchical)."""
    return node_shard_count(mesh, node_axis)
