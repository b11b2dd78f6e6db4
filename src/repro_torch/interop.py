"""Weights carried across packages: a params tree given as numpy arrays
(the JAX package's ``jax.device_get(params)``) to the port's tree of
tensors on a device, and back.

Dicts are rebuilt with keys in sorted order — the order ``jax.tree``
flattens them in — so packing offsets in ``flatten_nodes`` agree between
the packages.  Only numpy crosses the boundary: this module imports
nothing of JAX.  bfloat16 leaves (a bf16 cache tree, numpy dtype
``bfloat16`` from ``ml_dtypes``) cross exactly through float32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten

PyTree = Any


def from_numpy(tree: PyTree, device="cuda") -> PyTree:
    """numpy (or array-like) leaves → tensors on ``device``, dtype kept."""
    def tensor(lf):
        arr = np.array(lf, copy=True)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(arr).to(device)

    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [tensor(lf) for lf in leaves])


def to_numpy(tree: PyTree) -> PyTree:
    """Tensor leaves → numpy arrays on the host (bf16 leaves as fp32)."""
    leaves, treedef = tree_flatten(tree)

    def host(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    return tree_unflatten(treedef, [host(t) for t in leaves])
