"""Logical-axis → mesh-axis resolution (counterpart of
``repro/models/sharding.py``).

Modes:
  train_data   — decentralized training: per-node parameter replicas
                 stacked on a leading "node" axis sharded over the mesh's
                 data axis (``(pod, data)`` on a multi-pod mesh),
                 tensor-parallel within a node over the model axis;
  train_pod    — hierarchical: gossip nodes are pods, parameters sharded
                 over data × model inside each pod node;
  serve_tp     — inference, weights over the model axis only;
  serve_2d     — inference, weights over (data, model);
  serve_tp_seq — the KV cache's sequence over the model axis;
  serve_cp     — context-parallel decode, the KV sequence over data.

The port's meshes (:class:`repro_torch.core.mesh.Mesh`) place no tensor by
a spec: the rules are data, read by the 2-D sharded rounds
(:func:`wire_column_spec` decides which wire arrays slice over the model
axis) and by what resolves logical axes.  :class:`PartitionSpec` is a
tuple normalized as ``jax.sharding.PartitionSpec`` iterates (a one-name
tuple is the name, an empty one None), :class:`NamedSharding` a record
of a mesh and a spec, and :func:`constrain` returns its input, as the
reference's does outside jit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

PyTree = Any


class PartitionSpec(tuple):
    """Per tensor dimension: a mesh axis name, a tuple of them, or None
    (replicated)."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                if len(p) == 1:
                    return p[0]
                return p if p else None
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a :class:`PartitionSpec` over its axes."""
    mesh: Any
    spec: PartitionSpec


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def _rules(mode: str, mesh) -> dict:
    multi_pod = "pod" in mesh.axis_names
    node_phys: Any = ("pod", "data") if multi_pod else "data"
    if mode == "train_data":
        return {"node": node_phys, "batch": "data", "per_node_batch": None,
                "vocab": "model", "embed": None,
                "heads": "model", "kv_heads": "model", "ffn": "model",
                "expert": "model", "layers": None, "kv_seq": None}
    if mode == "train_pod":
        # the node axis is "pod" (absent on a single-pod mesh: replicated);
        # the embed dim shards over "data"
        return {"node": "pod" if multi_pod else None, "batch": "data",
                "per_node_batch": "data", "vocab": "model",
                "embed": "data", "heads": "model", "kv_heads": "model",
                "ffn": "model", "expert": "model", "layers": None,
                "kv_seq": None}
    serve_batch: Any = ("pod", "data") if multi_pod else "data"
    if mode == "serve_tp":
        return {"node": None, "batch": serve_batch, "vocab": "model",
                "embed": None, "heads": "model", "kv_heads": "model",
                "ffn": "model", "expert": "model", "layers": None,
                "kv_seq": None}
    if mode == "serve_2d":
        return {"node": None, "batch": serve_batch, "vocab": "model",
                "embed": "data", "heads": "model", "kv_heads": "model",
                "ffn": "model", "expert": "model", "layers": None,
                "kv_seq": None}
    if mode == "serve_tp_seq":
        # the KV cache's sequence dim over the model axis, for GQA archs
        # whose kv_heads do not divide it
        return {"node": None, "batch": serve_batch, "vocab": "model",
                "embed": None, "heads": "model", "kv_heads": None,
                "ffn": "model", "expert": "model", "layers": None,
                "kv_seq": "model"}
    if mode == "serve_cp":
        # context-parallel decode: tiny batch, KV sequence over data
        return {"node": None, "batch": "pod" if multi_pod else None,
                "vocab": "model", "embed": None, "heads": "model",
                "kv_heads": "model", "ffn": "model", "expert": "model",
                "layers": None, "kv_seq": "data"}
    raise ValueError(f"unknown sharding mode {mode!r}")


def logical_to_spec(axes: Tuple[Optional[str], ...], mode: str, mesh,
                    shape: Optional[Tuple[int, ...]] = None
                    ) -> PartitionSpec:
    """Resolve logical axes to a spec.  With ``shape`` a mesh axis applies
    only when the dim divides by it; no two dims map to one mesh axis."""
    rules = _rules(mode, mesh)
    mesh_sizes = dict(mesh.shape)
    phys, used = [], set()
    for i, a in enumerate(axes):
        if a is None:
            phys.append(None)
            continue
        p = rules.get(a, None)
        flat = tuple(p) if isinstance(p, tuple) else (p,)
        if p is None or any(f in used for f in flat if f is not None):
            phys.append(None)
            continue
        if shape is not None:
            size = 1
            for f in flat:
                size *= mesh_sizes.get(f, 1)
            if size == 0 or shape[i] % size != 0:
                phys.append(None)
                continue
        phys.append(p)
        used.update(f for f in flat if f is not None)
    return PartitionSpec(*phys)


def _map_axes(fn, tree):
    """``fn`` over the logical-axes tuples of a nested dict/list tree."""
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_axes(fn, v) for v in tree]
    return tree


def specs_for(axes_tree: PyTree, mode: str, mesh) -> PyTree:
    return _map_axes(lambda a: logical_to_spec(a, mode, mesh), axes_tree)


def shardings_for(axes_tree: PyTree, mode: str, mesh) -> PyTree:
    return _map_axes(
        lambda a: NamedSharding(mesh, logical_to_spec(a, mode, mesh)),
        axes_tree)


def constrain(x, spec: PartitionSpec):
    """The reference's ``with_sharding_constraint``, a no-op outside jit:
    the port's eager tensors carry no sharding, so ``x`` itself."""
    return x


def wire_column_spec(shape: Tuple[int, ...], n_rows: int,
                     node_names: Tuple[str, ...],
                     model_names: Tuple[str, ...], k_model: int
                     ) -> PartitionSpec:
    """Which way a packed or wire array of a sharded round splits:

    * an array with the node axis (leading dim ``n_rows``) shards it over
      ``node_names``;
    * such an array whose last axis divides by ``k_model`` (and has at
      least ``k_model`` columns) also slices its columns over
      ``model_names`` — the caller guarantees its columns follow the
      packed matrix's chunk layout, and passes ``model_names=()`` for
      payloads that cannot slice (sparsifiers);
    * everything else (node-independent arrays, scalars) rides whole."""
    row = tuple(node_names) if shape and shape[0] == n_rows else None
    if (row is not None and model_names and k_model > 1 and len(shape) >= 2
            and shape[-1] >= k_model and shape[-1] % k_model == 0):
        mid = (None,) * (len(shape) - 2)
        return PartitionSpec(row, *mid, tuple(model_names))
    return PartitionSpec(row) if row is not None else PartitionSpec()
