"""Mixing primitives: gossip rounds and global averaging on the stacked
node axis (the stacked subset of ``repro/core/mixing.py``).

Two interchangeable backends, selected by ``CommSpec.backend``:

* ``"reference"`` — ``W·x = Σ_s w_s · roll(x, s)`` and ``mean`` over the
  node axis, leaf by leaf: the oracle the fused path is tested against;
* ``"pallas"`` (name kept from the reference config) — the fused
  hand-written CUDA kernel (:mod:`repro_torch.kernels.mixing_cuda`): one
  pass over the packed parameters per round.

Wire dtype: for gossip rounds the self term stays in the storage dtype and
only neighbour terms are cast to ``comm_dtype``; averaging rounds cast the
whole operand; the grid topology ignores ``comm_dtype``.  Compression,
push-sum, overlap and sharded rounds are not ported yet (ROADMAP A.3-A.5,
A.10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core import topology as topo
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

BACKENDS = ("reference", "pallas")
PHASES = ("none", "gossip", "global", "pod_avg")


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Round-invariant communication configuration (no mesh fields: one
    device holds every node).  Build it with ``DistConfig.comm_spec``."""
    topology: str
    n_nodes: int
    n_pods: int = 1
    backend: str = "reference"
    leaf_threshold: Optional[int] = None
    comm_dtype: Any = None           # None or torch.bfloat16

    def replace(self, **kw) -> "CommSpec":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "CommSpec":
        if self.backend not in BACKENDS:
            raise ValueError(f"CommSpec: unknown backend {self.backend!r} "
                             f"(expected one of {BACKENDS})")
        if self.n_nodes < 1:
            raise ValueError("CommSpec: n_nodes must be >= 1")
        if self.n_pods < 1:
            raise ValueError("CommSpec: n_pods must be >= 1")
        if self.comm_dtype not in (None, torch.bfloat16):
            raise ValueError(f"CommSpec: comm_dtype must be None or "
                             f"torch.bfloat16, got {self.comm_dtype}")
        return self


def _check_backend(backend: str, axis: int, caller: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"{caller}: unknown mixing backend {backend!r} "
                         f"(expected one of {BACKENDS})")
    if backend == "pallas" and axis != 0:
        raise ValueError(
            f"{caller}: the fused mixing backend requires the node axis at "
            f"position 0 (got axis={axis})")
    return backend == "pallas"


def _check_pods(n_nodes: int, n_pods: int, caller: str) -> None:
    if n_pods < 1 or n_nodes % n_pods:
        raise ValueError(
            f"{caller}: n_pods={n_pods} does not divide n_nodes={n_nodes} "
            f"— the pod_avg round needs equal pod blocks")


# ---------------------------------------------------------------------------
# Roll-based mixing (reference backend)
# ---------------------------------------------------------------------------
def mix_array(x: torch.Tensor, weights: Dict[int, float], axis: int = 0,
              comm_dtype=None) -> torch.Tensor:
    """(W·x) along ``axis`` for circulant W given its shift decomposition.

    ``roll(x, -s)`` moves node (i+s)'s row into slot i (``W[i, i+s] =
    w_s``).  Neighbour terms are cast to ``comm_dtype`` before the roll;
    the self term and the weighted sum stay in the storage dtype.  Terms
    are added in the decomposition's order, as the reference adds them.
    The weight is a 0-d CPU tensor in the storage dtype, which a CUDA
    operand takes as a kernel argument (no host-to-device copy).
    """
    acc = None
    for s, w in weights.items():
        if s == 0:
            term = x
        else:
            src = x.to(comm_dtype) if comm_dtype is not None else x
            term = torch.roll(src, -s, dims=axis).to(x.dtype)
        term = term * torch.tensor(w, dtype=x.dtype)
        acc = term if acc is None else acc + term
    return acc


def mix_array_grid(x: torch.Tensor, n: int, axis: int = 0) -> torch.Tensor:
    """Torus-grid mixing: factor the node axis into (r, c), roll each."""
    r, c = topo.grid_shape(n)
    shape = tuple(x.shape)
    xg = x.reshape(shape[:axis] + (r, c) + shape[axis + 1:])
    acc = None
    for (dr, dc), w in topo.grid_shift_weights(n).items():
        term = xg
        if dr:
            term = torch.roll(term, -dr, dims=axis)
        if dc:
            term = torch.roll(term, -dc, dims=axis + 1)
        term = term * torch.tensor(w, dtype=x.dtype)
        acc = term if acc is None else acc + term
    return acc.reshape(shape)


def mix_pytree(params: PyTree, topology: str, n: int, step: int = 0,
               axis: int = 0, comm_dtype=None, backend: str = "reference",
               leaf_threshold: Optional[int] = None) -> PyTree:
    """Gossip step ``x ← W x`` over a pytree with the node axis at
    ``axis``."""
    use_fused = _check_backend(backend, axis, "mixing.mix_pytree")
    if n == 1 or topology == "disconnected":
        return params
    if use_fused:
        from repro_torch.kernels import mixing_cuda
        return mixing_cuda.fused_step_mix(
            params, phase="gossip", topology=topology, n_nodes=n, step=step,
            comm_dtype=comm_dtype, leaf_threshold=leaf_threshold)
    if topology == "grid":
        return tree_map(lambda p: mix_array_grid(p, n, axis), params)
    weights = topo.shift_weights(topology, n, step)
    return tree_map(lambda p: mix_array(p, weights, axis, comm_dtype),
                    params)


def _wire_mean(p: torch.Tensor, dim: int, comm_dtype) -> torch.Tensor:
    """``mean`` as the reference takes it: on the wire-cast operand,
    accumulated in fp32, rounded back to the wire dtype."""
    src = p.to(comm_dtype) if comm_dtype is not None else p
    m = torch.mean(src.to(torch.float32), dim=dim, keepdim=True)
    return m.to(src.dtype)


def global_average_pytree(params: PyTree, axis: int = 0, comm_dtype=None,
                          backend: str = "reference",
                          leaf_threshold: Optional[int] = None) -> PyTree:
    """Periodic global averaging ``x ← (1/n)𝟙𝟙ᵀ x`` (All-Reduce step)."""
    use_fused = _check_backend(backend, axis,
                               "mixing.global_average_pytree")
    if use_fused:
        from repro_torch.kernels import mixing_cuda
        n = tree_leaves(params)[0].shape[0]
        return mixing_cuda.global_average(params, n, comm_dtype=comm_dtype,
                                          leaf_threshold=leaf_threshold)

    def avg(p):
        m = _wire_mean(p, axis, comm_dtype)
        return m.expand(p.shape).to(p.dtype).contiguous()

    return tree_map(avg, params)


def pod_average_pytree(params: PyTree, n_pods: int, axis: int = 0,
                       comm_dtype=None, backend: str = "reference",
                       leaf_threshold: Optional[int] = None) -> PyTree:
    """Exact average within each pod's block of nodes (Hier-PGA round)."""
    use_fused = _check_backend(backend, axis, "mixing.pod_average_pytree")
    n = tree_leaves(params)[0].shape[axis]
    _check_pods(n, n_pods, "mixing.pod_average_pytree")
    if use_fused:
        from repro_torch.kernels import mixing_cuda
        return mixing_cuda.pod_average(params, n, n_pods,
                                       comm_dtype=comm_dtype,
                                       leaf_threshold=leaf_threshold)

    def avg(p):
        per = p.shape[axis] // n_pods
        shp = tuple(p.shape[:axis]) + (n_pods, per) + tuple(
            p.shape[axis + 1:])
        m = _wire_mean(p.reshape(shp), axis + 1, comm_dtype)
        return m.expand(shp).reshape(p.shape).to(p.dtype)

    return tree_map(avg, params)


# ---------------------------------------------------------------------------
# Communication-op selector used by the training step
# ---------------------------------------------------------------------------
def communicate(params: PyTree, spec: CommSpec, *, phase: str,
                step: int = 0, axis: int = 0) -> PyTree:
    """Apply one communication round to node-stacked parameters.

    phase: ``"none"`` (no communication), ``"gossip"`` (``x ← W x``),
    ``"global"`` (``x ← x̄``), ``"pod_avg"`` (exact average per pod).
    """
    _check_backend(spec.backend, axis, "mixing.communicate")
    if phase not in PHASES:
        raise ValueError(f"unknown communication phase {phase!r}")
    if phase == "pod_avg":
        _check_pods(spec.n_nodes, spec.n_pods, "mixing.communicate")
    if phase == "none" or spec.n_nodes == 1:
        return params
    if phase == "gossip":
        return mix_pytree(params, spec.topology, spec.n_nodes, step=step,
                          axis=axis, comm_dtype=spec.comm_dtype,
                          backend=spec.backend,
                          leaf_threshold=spec.leaf_threshold)
    if phase == "global":
        return global_average_pytree(params, axis=axis,
                                     comm_dtype=spec.comm_dtype,
                                     backend=spec.backend,
                                     leaf_threshold=spec.leaf_threshold)
    return pod_average_pytree(params, spec.n_pods, axis=axis,
                              comm_dtype=spec.comm_dtype,
                              backend=spec.backend,
                              leaf_threshold=spec.leaf_threshold)
