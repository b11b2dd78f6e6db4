"""TrainState, node-stacking and push-sum helpers (counterpart of
``repro/train/state.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.tree import pairwise_mean, tree_leaves, tree_map

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

    @property
    def push_weight(self) -> Optional[torch.Tensor]:
        """The ``(n, 1)`` float32 push-sum weight (None without push-sum);
        readers de-bias with :func:`debias`, and ``Σw = n`` holds."""
        return self.extras.get("push_weight")


def init_push_weight(n_nodes: int, device="cpu") -> torch.Tensor:
    """Push-sum weights start at 1 on every node (Σw = n)."""
    return torch.ones((n_nodes, 1), dtype=torch.float32, device=device)


def debias(params_stacked: PyTree, push_weight: Optional[torch.Tensor]
           ) -> PyTree:
    """The de-biased read ``x/w``, the push-sum estimate of the average;
    the identity when ``push_weight`` is None.  Divides in fp32 and casts
    back per leaf; w broadcasts over each leaf's trailing dims."""
    if push_weight is None:
        return params_stacked
    w = push_weight.reshape(-1).to(torch.float32)

    def one(p):
        wb = w.reshape((p.shape[0],) + (1,) * (p.dim() - 1))
        return (p.to(torch.float32) / wb).to(p.dtype)

    return tree_map(one, params_stacked)


def stack_for_nodes(tree: PyTree, n_nodes: int) -> PyTree:
    """x_i^(0) identical across nodes (paper Alg. 1 requirement); each node
    gets its own copy."""
    return tree_map(
        lambda p: p[None].expand((n_nodes,) + tuple(p.shape)).contiguous(),
        tree)


def consensus_distance(params_stacked: PyTree) -> torch.Tensor:
    """(1/n) Σ_i ‖x_i − x̄‖² summed over all parameters — the paper's
    consensus quantity (§4 Intuition).  x̄ is the node mean taken by
    pairwise halving, as the fused round's residual takes it: for n a
    power of two it is exact on equal rows, so the consensus after an
    exact average is exactly 0.0 (a running sum over the rows is not
    exact: 3·x rounds)."""
    def one(p):
        p32 = p.to(torch.float32)
        xbar = pairwise_mean(p32)
        return torch.sum(torch.square(p32 - xbar)) / p.shape[0]
    return sum(one(p) for p in tree_leaves(params_stacked))
