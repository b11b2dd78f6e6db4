"""Pytree helpers over nested dicts/lists/tuples of tensors.

Dict keys are visited in **sorted** order, as ``jax.tree.flatten`` visits
them: that order fixes each leaf's packing offset in
``kernels.mixing_cuda.flatten_nodes`` and the summation order of the
consensus residual, so the port must not follow insertion order (which
``torch.utils._pytree`` does).  A dataclass registered with
:func:`register_node` (``TrainState``) is a node of its fields, in
declaration order; any other object is a leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

PyTree = Any

_NODES: set = set()


def register_node(cls):
    """Make the dataclass ``cls`` a node of its fields (a class
    decorator)."""
    _NODES.add(cls)
    return cls


def _walk(t, leaves: List[Any]):
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", keys, [_walk(t[k], leaves) for k in keys])
    if isinstance(t, (list, tuple)):
        return (type(t).__name__, len(t), [_walk(c, leaves) for c in t])
    if t is None:
        return ("none",)
    if type(t) in _NODES:
        names = [f.name for f in dataclasses.fields(t)]
        return ("node", type(t), names,
                [_walk(getattr(t, n), leaves) for n in names])
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
    if kind == "node":
        return d[1](**{n: _build(c, it) for n, c in zip(d[2], d[3])})
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


def pairwise_mean(x):
    """Mean over the leading (node) axis of a tensor, keeping it as one
    row: halving pairwise, ``s[i] += s[m − h + i]`` for ``i < h = m // 2``
    while ``m > 1`` rows are left, then ``/ n``.  This is the order in
    which the fused round's kernel takes x̄ (``csrc/mix.cu``), its plain
    twin and ``consensus_distance`` too; it is exact on equal rows when n
    is a power of two (a running sum is not: 3·x rounds).  One working
    buffer of about half of ``x``, summed in place."""
    n = m = x.shape[0]
    if n == 1:
        return x[:1] / n
    h = m // 2
    s = x[:m - h].clone()
    s[:h] += x[m - h:m]
    m -= h
    while m > 1:
        h = m // 2
        s[:h] += s[m - h:m]
        m -= h
    return s[:1] / n
