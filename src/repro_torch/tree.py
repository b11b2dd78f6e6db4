"""Pytree helpers over nested dicts/lists/tuples of tensors.

Dict keys are visited in **sorted** order, as ``jax.tree.flatten`` visits
them: that order fixes each leaf's packing offset in
``kernels.mixing_cuda.flatten_nodes`` and the summation order of the
consensus residual, so the port must not follow insertion order (which
``torch.utils._pytree`` does).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any


def _walk(t, leaves: List[Any]):
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", keys, [_walk(t[k], leaves) for k in keys])
    if isinstance(t, (list, tuple)):
        return (type(t).__name__, len(t), [_walk(c, leaves) for c in t])
    if t is None:
        return ("none",)
    leaves.append(t)
    return ("leaf",)


def _build(d, it):
    kind = d[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    children = [_build(c, it) for c in d[2]]
    return tuple(children) if kind == "tuple" else children


# The walkers are module-level functions on purpose: a recursive closure
# references itself through its cell, and that cycle would keep every
# leaf it saw (gigabytes of parameters) alive until the cyclic collector
# runs.
def tree_flatten(tree: PyTree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``None`` is an empty subtree, as in JAX."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def tree_unflatten(treedef: Any, leaves: List[Any]) -> PyTree:
    return _build(treedef, iter(leaves))


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree) -> PyTree:
    """``fn`` over every leaf, keeping the structure."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(leaf) for leaf in leaves])
