"""TrainState and node-stacking helpers (counterpart of
``repro/train/state.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass
class TrainState:
    params: PyTree               # stacked: leading node axis
    opt_state: PyTree
    step: int                    # host counter of executed steps
    extras: Dict[str, PyTree] = dataclasses.field(default_factory=dict)

    @property
    def ef_state(self) -> Optional[PyTree]:
        """Per-node error-feedback memory (None without error feedback)."""
        return self.extras.get("ef_state")


def stack_for_nodes(tree: PyTree, n_nodes: int) -> PyTree:
    """x_i^(0) identical across nodes (paper Alg. 1 requirement); each node
    gets its own copy."""
    return tree_map(
        lambda p: p[None].expand((n_nodes,) + tuple(p.shape)).contiguous(),
        tree)


def consensus_distance(params_stacked: PyTree) -> torch.Tensor:
    """(1/n) Σ_i ‖x_i − x̄‖² summed over all parameters — the paper's
    consensus quantity (§4 Intuition)."""
    def one(p):
        p32 = p.to(torch.float32)
        xbar = torch.mean(p32, dim=0, keepdim=True)
        return torch.sum(torch.square(p32 - xbar)) / p.shape[0]
    return sum(one(p) for p in tree_leaves(params_stacked))
