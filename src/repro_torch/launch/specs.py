"""Input specs: shape stand-ins and shardings for every (architecture ×
input shape × mesh) combination of the dry-run (counterpart of
``repro/launch/specs.py``).

The stand-ins are ``meta`` tensors of the real shapes and dtypes, built by
the port's own code (``Model.abstract_init``, ``stack_for_nodes``, the
optimizer's and the algorithm's inits, ``Model.init_cache``): they
allocate nothing, and the dry-run runs the step on them.  Shardings are
``repro_torch.models.sharding.NamedSharding`` records of the mesh and the
spec that ``logical_to_spec(..., shape=)`` resolves from each leaf's
logical axes, skipping a mesh axis that does not divide the dim, as the
reference's ``_shardings`` does.

Three step kinds:
  train   — ``step(state, batch, lr)`` (``train.step.build_train_step``);
            ``lr`` is a host float in the port, so ``lr_sds`` is a record
            the step does not take as a tensor
  prefill — ``Model.forward(params, batch, mode="prefill")`` with caches
  decode  — ``Model.decode_step(params, caches, tokens, pos)``: one new
            token against a full ``seq_len`` cache

Serving specs are one replica's, in the reference's layout (no node
axis); the dry-run adds the node axis of 1 that the port's ``Model``
takes, as ``repro_torch.serve`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (DistConfig, InputShape, ModelConfig,
                                      OptimizerConfig)
from repro_torch.launch.mesh import n_gossip_nodes
from repro_torch.models import sharding as shd
from repro_torch.models.model import make_model
from repro_torch.optim import make_optimizer
from repro_torch.train.state import (TrainState, stack_for_nodes,
                                     stacked_axes, state_axes)

PyTree = Any


def _sds(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def _map2(fn, axes: PyTree, sds: PyTree) -> PyTree:
    """``fn(axes, leaf)`` over an axes tree (tuples at the leaves) and the
    matching tree of stand-ins (dicts, ``TrainState``)."""
    if isinstance(axes, tuple):
        return fn(axes, sds)
    if isinstance(axes, TrainState):
        return TrainState(**{f.name: _map2(fn, getattr(axes, f.name),
                                           getattr(sds, f.name))
                             for f in dataclasses.fields(TrainState)})
    return {k: _map2(fn, axes[k], sds[k]) for k in axes}


def _shardings(axes_tree: PyTree, mode: str, mesh,
               sds_tree: PyTree) -> PyTree:
    """Shape-aware sharding resolution (skips non-divisible dims)."""
    return _map2(
        lambda a, s: shd.NamedSharding(mesh, shd.logical_to_spec(
            a, mode, mesh, shape=tuple(getattr(s, "shape", ())))),
        axes_tree, sds_tree)


# ---------------------------------------------------------------------------
# Batch specs (train / prefill)
# ---------------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, n_nodes: Optional[int], batch: int,
                seq_len: int) -> Tuple[Dict[str, torch.Tensor],
                                       Dict[str, tuple]]:
    """n_nodes None => serving layout (B, S); else (n, B/n, S)."""
    if n_nodes is None:
        lead, lead_axes = (batch,), ("batch",)
    else:
        assert batch % n_nodes == 0, (batch, n_nodes)
        lead, lead_axes = (n_nodes, batch // n_nodes), ("node",
                                                        "per_node_batch")
    shapes: Dict[str, Any] = {}
    axes: Dict[str, Any] = {}
    if cfg.family == "encoder" and cfg.audio is not None:
        shapes["frames"] = _sds(lead + (seq_len, cfg.d_model),
                                torch.bfloat16)
        axes["frames"] = lead_axes + (None, None)
        shapes["mask"] = _sds(lead + (seq_len,), torch.bool)
        axes["mask"] = lead_axes + (None,)
        shapes["targets"] = _sds(lead + (seq_len,), torch.int32)
        axes["targets"] = lead_axes + (None,)
        return shapes, axes
    shapes["inputs"] = _sds(lead + (seq_len,), torch.int32)
    axes["inputs"] = lead_axes + (None,)
    shapes["targets"] = _sds(lead + (seq_len,), torch.int32)
    axes["targets"] = lead_axes + (None,)
    if cfg.family == "encoder":
        shapes["mask"] = _sds(lead + (seq_len,), torch.bool)
        axes["mask"] = lead_axes + (None,)
    if cfg.family == "vlm" and cfg.vision is not None:
        n_img = cfg.vision.n_tiles * cfg.vision.patches_per_tile
        shapes["patches"] = _sds(lead + (n_img, cfg.d_model), torch.bfloat16)
        axes["patches"] = lead_axes + (None, None)
    return shapes, axes


# ---------------------------------------------------------------------------
# Train specs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TrainSpecs:
    state_sds: TrainState
    state_shardings: TrainState
    batch_sds: Dict[str, torch.Tensor]
    batch_shardings: Dict[str, shd.NamedSharding]
    lr_sds: torch.Tensor
    lr_sharding: shd.NamedSharding
    n_nodes: int
    mode: str


def train_specs(cfg: ModelConfig, mesh, shape: InputShape, *,
                dist: DistConfig = DistConfig(),
                optimizer: OptimizerConfig = OptimizerConfig()) -> TrainSpecs:
    """The node-stacked train state on ``meta`` (its ``step`` the port's
    host int 0) and its shardings under ``train_data`` (``node_axis`` =
    "data") or ``train_pod``."""
    from repro_torch.core import algo as algo_lib
    model = make_model(cfg)
    n_nodes = n_gossip_nodes(mesh, dist.node_axis)
    mode = "train_data" if dist.node_axis == "data" else "train_pod"
    opt = make_optimizer(optimizer, per_node=True)
    params, axes = model.abstract_init()
    stacked = stack_for_nodes(params, n_nodes)
    state_sds = TrainState(params=stacked, opt_state=opt.init(stacked),
                           step=0, extras=algo_lib.init_extras(
                               dist, stacked, n_nodes))
    st_axes = stacked_axes(axes)
    state_axes_tree = state_axes(
        st_axes, optimizer.name,
        extras=algo_lib.extras_axes(dist, st_axes, axes))
    state_sh = _shardings(state_axes_tree, mode, mesh, state_sds)

    b_sds, b_axes = batch_specs(cfg, n_nodes, shape.global_batch,
                                shape.seq_len)
    b_sh = _shardings(b_axes, mode, mesh, b_sds)
    repl = shd.NamedSharding(mesh, shd.P())
    return TrainSpecs(state_sds=state_sds, state_shardings=state_sh,
                      batch_sds=b_sds, batch_shardings=b_sh,
                      lr_sds=_sds((), torch.float32), lr_sharding=repl,
                      n_nodes=n_nodes, mode=mode)


# ---------------------------------------------------------------------------
# Serve specs (prefill / decode)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServeSpecs:
    params_sds: PyTree
    params_shardings: PyTree
    batch_sds: Optional[Dict[str, torch.Tensor]]             # prefill
    batch_shardings: Optional[Dict[str, shd.NamedSharding]]
    cache_sds: Optional[PyTree]                              # decode
    cache_shardings: Optional[PyTree]
    tokens_sds: Optional[torch.Tensor]
    tokens_sharding: Optional[shd.NamedSharding]
    pos_sds: Optional[torch.Tensor]
    pos_sharding: Optional[shd.NamedSharding]
    mode: str


def serve_specs(cfg: ModelConfig, mesh, shape: InputShape, *,
                param_sharding: str = "tp",
                context_parallel: Optional[bool] = None) -> ServeSpecs:
    model = make_model(cfg)
    params_sds, axes = model.abstract_init()
    data_size = dict(mesh.shape).get("data", 1)
    if context_parallel is None:
        context_parallel = (shape.kind == "decode"
                            and shape.global_batch < data_size)
    mode = ("serve_cp" if context_parallel
            else {"tp": "serve_tp", "2d": "serve_2d",
                  "tp_seq": "serve_tp_seq"}[param_sharding])
    params_sh = _shardings(axes, mode, mesh, params_sds)

    if shape.kind == "prefill":
        b_sds, b_axes = batch_specs(cfg, None, shape.global_batch,
                                    shape.seq_len)
        b_sds.pop("targets", None)
        b_axes.pop("targets", None)
        b_sh = _shardings(b_axes, mode, mesh, b_sds)
        return ServeSpecs(params_sds, params_sh, b_sds, b_sh,
                          None, None, None, None, None, None, mode)

    # decode: full-length cache, one new token
    B = shape.global_batch
    cache_sds = _drop_node_axis(model.init_cache(B, shape.seq_len,
                                                 device="meta"))
    cache_sh = _shardings(model.cache_axes(), mode, mesh, cache_sds)
    tok_axes = ("batch", None)
    pos_axes = ("batch",)
    return ServeSpecs(
        params_sds, params_sh, None, None, cache_sds, cache_sh,
        _sds((B, 1), torch.int32),
        shd.NamedSharding(mesh, shd.logical_to_spec(tok_axes, mode, mesh,
                                                    shape=(B, 1))),
        _sds((B,), torch.int32),
        shd.NamedSharding(mesh, shd.logical_to_spec(pos_axes, mode, mesh,
                                                    shape=(B,))),
        mode)


def _drop_node_axis(tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _drop_node_axis(v) for k, v in tree.items()}
    return tree[0]
