"""Comm-round meters: byte accounting and pipeline occupancy
(counterpart of ``repro/obs/meters.py``).

Every ``comm_round`` record carries two independent byte figures:

* ``analytic_bytes`` — ``compress.round_wire_bytes``, the config-level
  cost model;
* ``measured_bytes`` — recomputed here from the live round: the leaf
  shapes and dtypes of the tree entering it, the compressor objects, and
  (on the sharded lossy path) the wire arrays themselves.

Their agreeing is the cross-check.  Both are host arithmetic on shapes
and dtypes: no tensor value is read.  Byte figures are **per node per
round**, as ``round_wire_bytes`` counts them; on a 2-D ``(node, model)``
mesh ``model_shards`` is its k_model and the figures are per device (the
columns and the quantizers' codes sliced, scales and sparsifier payloads
whole).

Occupancy of an overlapped pipeline, the share of the synchronous
round's cost hidden under compute::

    occupancy = clip(1 - max(0, t_step_overlap - t_compute) / t_comm_sync,
                     0, 1)
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.tree import tree_leaves

PyTree = Any


def _itemsize(dtype) -> int:
    return int(torch.empty((), dtype=dtype).element_size())


def _arr_nbytes(a: torch.Tensor) -> int:
    return int(a.numel()) * _itemsize(a.dtype)


def per_node_leaf_sizes(params: PyTree, n_nodes: int) -> List[int]:
    """Per-node flattened element count of each leaf, from live shapes
    (a leading axis of size ``n_nodes`` is the stacked node axis)."""
    sizes = []
    for leaf in tree_leaves(params):
        shape = tuple(leaf.shape)
        dims = shape[1:] if (shape and shape[0] == n_nodes) else shape
        per = 1
        for s in dims:
            per *= int(s)
        sizes.append(per)
    return sizes


def round_sends(phase: str, topology: str, n_nodes: int,
                step: int = 0) -> int:
    """Payload transmissions in one round: nonzero off-diagonal shifts for
    gossip, 1 for the averaging collectives, 0 when no bytes move."""
    if n_nodes <= 1 or phase == "none":
        return 0
    if phase in ("global", "pod_avg"):
        return 1
    if phase != "gossip" or topology == "disconnected":
        return 0
    from repro_torch.core import topology as topo
    if topology == "grid":
        return sum(1 for s in topo.grid_shift_weights(n_nodes)
                   if s != (0, 0))
    return sum(1 for s in topo.shift_weights(topology, n_nodes, step)
               if s != 0)


def measured_round_bytes(params: PyTree, *, phase: str, topology: str,
                         n_nodes: int, step: int = 0, n_pods: int = 1,
                         comm_dtype=None, compressor=None,
                         global_compressor=None, model_shards: int = 1,
                         wires=None) -> int:
    """Per-node (per-device when ``model_shards > 1``) wire bytes of one
    round, from the live tree (or wire arrays)."""
    leaves = tree_leaves(params)
    n, ms = n_nodes, max(int(model_shards), 1)
    if not leaves or n <= 1 or phase == "none":
        return 0
    sizes = per_node_leaf_sizes(params, n)
    elems = [(_itemsize(comm_dtype) if comm_dtype is not None
              else _itemsize(leaf.dtype)) for leaf in leaves]
    if phase == "gossip" and topology == "grid":
        elems = [4] * len(elems)   # grid gossip ignores comm_dtype
    lossy = compressor is not None and compressor.lossy
    quant = lossy and compressor.name in ("int8", "fp8")
    glossy = global_compressor is not None and global_compressor.lossy
    sends = round_sends(phase, topology, n, step)

    if phase in ("global", "pod_avg") and glossy:
        # compressed collective: whole QBLOCK blocks of codes + one
        # exponent byte each, model-sliced on block boundaries
        from repro_torch.compress import QBLOCK
        nb = -(-sum(sizes) // QBLOCK)
        return -(-nb // ms) * (QBLOCK + 1)

    if wires is not None:
        # sharded lossy path: the wire arrays ARE the payload (a leading
        # node axis -> per node)
        per_send = 0
        for w in wires:
            payload = w["payload"] if isinstance(w, dict) else w.payload
            aux = w["aux"] if isinstance(w, dict) else w.aux
            for a in tuple(payload) + tuple(aux):
                per_send += _arr_nbytes(a) // (n if a.dim() and a.shape[0]
                                               == n else 1)
        if phase == "pod_avg":
            return (max(n // max(n_pods, 1), 1) - 1) * per_send
        return sends * per_send

    if lossy and phase in ("gossip", "pod_avg"):
        if quant and ms > 1:
            # code bytes slice over the model axis; the per-row scale
            # word stays whole
            per_send = sum(-(-d // ms)
                           + int(compressor.wire_bytes_per_send(1, d)) - d
                           for d in sizes)
        else:
            per_send = sum(int(compressor.wire_bytes_per_send(1, d))
                           for d in sizes)
        if phase == "pod_avg":
            return (max(n // max(n_pods, 1), 1) - 1) * per_send
        return sends * per_send

    if phase == "global" and lossy and not quant:
        # a sparsifier's round runs model-replicated: its global operand
        # stays full width per device
        return sum(s * e for s, e in zip(sizes, elems))
    # the dense operand, column-sliced over the model axis per leaf
    return sends * sum((-(-s // ms)) * e for s, e in zip(sizes, elems))


def _dtype_name(comm_dtype) -> str:
    return ("float32" if comm_dtype is None
            else str(comm_dtype).replace("torch.", ""))


def comm_round_fields(params: PyTree, *, phase: str, topology: str,
                      n_nodes: int, step: int = 0, n_pods: int = 1,
                      backend: str = "reference", sharded: bool = False,
                      comm_dtype=None, compressor=None,
                      global_compressor=None, model_shards: int = 1,
                      wires=None, role: str = "round") -> Dict[str, Any]:
    """One ``comm_round`` record's fields: tags, analytic bytes
    (``round_wire_bytes``) and measured bytes (live tree or wires).
    ``traced`` is False: the port runs every round eagerly."""
    from repro_torch.compress import round_wire_bytes
    sizes = per_node_leaf_sizes(params, n_nodes)
    comp_name = compressor.name if compressor is not None else "none"
    gcomp_name = (global_compressor.name
                  if global_compressor is not None else "none")
    dtype_name = _dtype_name(comm_dtype)
    analytic = round_wire_bytes(
        phase, topology, n_nodes, sum(sizes), comm_dtype=dtype_name,
        compression=comp_name, k=getattr(compressor, "k", 32), step=step,
        n_pods=n_pods, leaf_sizes=sizes, global_compression=gcomp_name,
        model_shards=model_shards)
    measured = measured_round_bytes(
        params, phase=phase, topology=topology, n_nodes=n_nodes,
        step=step, n_pods=n_pods, comm_dtype=comm_dtype,
        compressor=compressor, global_compressor=global_compressor,
        model_shards=model_shards, wires=wires)
    return {
        "phase": phase, "role": role, "shift": int(step),
        "topology": topology, "backend": backend, "sharded": bool(sharded),
        "n_nodes": int(n_nodes), "n_pods": int(n_pods),
        "model_shards": int(model_shards),
        "comm_dtype": dtype_name, "compression": comp_name,
        "global_compression": gcomp_name,
        "sends": round_sends(phase, topology, n_nodes, step),
        "analytic_bytes": int(analytic), "measured_bytes": int(measured),
        "traced": False,
    }


def occupancy(t_compute_s: float, t_comm_sync_s: float,
              t_step_overlap_s: float) -> float:
    """Share of the synchronous comm cost hidden under compute by the
    overlapped pipeline (see the module docstring)."""
    if t_comm_sync_s <= 0.0:
        return 1.0
    visible = max(0.0, t_step_overlap_s - t_compute_s)
    return max(0.0, min(1.0, 1.0 - visible / t_comm_sync_s))
