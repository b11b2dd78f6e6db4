"""Optimizers: SGD (+Nesterov momentum), AdamW and LAMB as functional
``(init, update)`` pairs over node-stacked dict trees (counterpart of
``repro/optim/optimizers.py``).

Elementwise updates vectorise over the leading node axis unchanged.
LAMB's layerwise trust ratio must be *per node*: ``per_node=True`` takes
each tensor norm over every axis but the first, so a leaf stacked over
layers ``(n, L, …)`` gets one ratio per node across all its layers (paper
§5.3/App. F trains BERT with LAMB).  Like the reference, ``update``
returns new tensors and leaves its inputs as they were.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, Any], Tuple[PyTree, PyTree]]
    # update(grads, opt_state, params, lr) -> (new_params, new_opt_state)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _tensor_norm(x: torch.Tensor, per_node: bool) -> torch.Tensor:
    """The fp32 L2 norm of ``x``; with ``per_node`` (and ``x`` at least
    2-D) one norm per node over all the other axes, shaped to broadcast
    against ``x``."""
    sq = torch.square(x.to(torch.float32))
    if per_node and x.dim() > 1:
        nrm = torch.sqrt(torch.sum(sq, dim=tuple(range(1, x.dim()))))
        return nrm.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return torch.sqrt(torch.sum(sq))


def joint_sq_norm(tree: PyTree, mesh=None, node_axis: str = "data"
                  ) -> torch.Tensor:
    """``Σ_leaves Σ g²`` in fp32 over all nodes' rows jointly.  With a
    ``mesh`` whose node axis (``node_axis``) has k > 1 shards each leaf's
    sum is taken per node shard and the k partial sums are folded in
    shard order: on a rank mesh (``mesh.distributed``) each rank sums its
    rows and ``mesh.exchange.fold`` folds over the node-axis ranks (on a
    2-D mesh the model ranks of one node shard hold the same grads and
    are not counted again); on a one-process mesh each shard's m = n/k
    rows are summed here and folded the same way, so both meshes give
    the same bits."""
    leaves = tree_leaves(tree)
    if mesh is not None and mesh.distributed:
        sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves]
        return sum(mesh.exchange.fold(torch.stack(sq)).unbind(0))
    from repro_torch.core.mixing import node_shard_count
    k = node_shard_count(mesh, node_axis) if mesh is not None else 1
    sq = []
    for g in leaves:
        acc = None
        for block in (g.chunk(k) if k > 1 else (g,)):
            p = torch.sum(torch.square(block.to(torch.float32)))
            acc = p if acc is None else acc + p
        sq.append(acc)
    return sum(sq)


def clip_by_global_norm(grads: PyTree, max_norm: float, mesh=None,
                        node_axis: str = "data") -> PyTree:
    """Scale every leaf by ``min(1, max_norm/‖g‖)`` where ``‖g‖`` is the
    norm over **all nodes' grads jointly**, as the reference clips (over
    a sharded ``mesh``'s node shards as :func:`joint_sq_norm` folds it)."""
    gn = torch.sqrt(joint_sq_norm(grads, mesh, node_axis))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def sgd(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {"momentum": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, lr):
        gl, treedef = tree_flatten(grads)
        new_p, new_m = [], []
        for g, m, p in zip(gl, tree_leaves(state["momentum"]),
                           tree_leaves(params)):
            g32 = g.to(torch.float32)
            if cfg.weight_decay:
                g32 = g32 + cfg.weight_decay * p.to(torch.float32)
            m_new = cfg.momentum * m.to(torch.float32) + g32
            step = (g32 + cfg.momentum * m_new) if cfg.nesterov else m_new
            new_p.append((p.to(torch.float32) - lr * step).to(p.dtype))
            new_m.append(m_new.to(m.dtype))
        return (tree_unflatten(treedef, new_p),
                {"momentum": tree_unflatten(treedef, new_m)})

    return Optimizer(init, update)


def _adam_init(params):
    return {"m": tree_map(_zeros_f32, params),
            "v": tree_map(_zeros_f32, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}


def _adam(cfg: OptimizerConfig, step) -> Optimizer:
    """AdamW's moments and bias corrections around ``step(p, u, lr)``, the
    new parameter from the decayed Adam direction ``u`` (fp32)."""
    def update(grads, state, params, lr):
        # int32 step count; the bias corrections are fp32 powers of it
        count = state["count"] + 1
        c32 = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), c32)
        bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), c32)

        gl, treedef = tree_flatten(grads)
        ms, vs, ps = [], [], []
        for g, m, v, p in zip(gl, tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            g32 = g.to(torch.float32)
            m = cfg.b1 * m + (1 - cfg.b1) * g32
            v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p.to(torch.float32)
            ps.append(step(p, u, lr).to(p.dtype))
            ms.append(m)
            vs.append(v)
        return tree_unflatten(treedef, ps), {
            "m": tree_unflatten(treedef, ms),
            "v": tree_unflatten(treedef, vs), "count": count}

    return Optimizer(_adam_init, update)


def adamw(cfg: OptimizerConfig) -> Optimizer:
    return _adam(cfg, lambda p, u, lr: p.to(torch.float32) - lr * u)


def lamb(cfg: OptimizerConfig, per_node: bool = False) -> Optimizer:
    """AdamW's direction scaled by the trust ratio ‖p‖ / ‖u‖ (1 where
    either norm is 0), per node with ``per_node``."""
    def step(p, u, lr):
        wn = _tensor_norm(p, per_node)
        un = _tensor_norm(u, per_node)
        trust = torch.where((wn > 0) & (un > 0),
                            wn / torch.clamp(un, min=1e-12),
                            torch.ones_like(wn))
        return p.to(torch.float32) - lr * trust * u

    return _adam(cfg, step)


def make_optimizer(cfg: OptimizerConfig, per_node: bool = False
                   ) -> Optimizer:
    if cfg.name == "sgd":
        return sgd(cfg)
    if cfg.name == "adamw":
        return adamw(cfg)
    if cfg.name == "lamb":
        return lamb(cfg, per_node=per_node)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
