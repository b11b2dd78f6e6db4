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
whole operand; the grid topology ignores ``comm_dtype``.

Wire compression (``CommSpec.compressor`` / ``global_compressor``, from
``repro_torch.compress``): a lossy compressor replaces the neighbour
payload by its compressed estimate ``q`` and the round runs in the
self-compensated form ``x + (M·q − (1−d)⊙q)``; a lossy global compressor
runs the compressed two-stage collective on the averaging phases.  With
either set, :func:`communicate` returns ``(mixed, new_ef_state)``.
Push-sum, overlap and sharded rounds are not ported yet (ROADMAP A.4,
A.5, A.10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)

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
    compressor: Any = None           # gossip wire codec (repro_torch.compress)
    global_compressor: Any = None    # codec of the global/pod_avg collective

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
        gc = self.global_compressor
        if gc is not None and gc.lossy and gc.name not in ("int8", "fp8"):
            raise ValueError(f"CommSpec: the compressed collective takes "
                             f"int8 or fp8, not {gc.name!r}")
        return self

    @property
    def lossy(self) -> bool:
        """True when the gossip wire payload is lossy-compressed."""
        return self.compressor is not None and self.compressor.lossy


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


def _collective_round_reference(params: PyTree, compressor, ef_state,
                                seed, n_pods: int = 1):
    """Reference compressed-collective round on the packed ``(n, D)``
    state: ``(mixed, new_ef_state)``."""
    from repro_torch.compress import collective as ccol
    from repro_torch.kernels.mixing_cuda import flatten_nodes

    xf, unflatten = flatten_nodes(params)
    ef2 = ef_unflatten = None
    if ef_state is not None:
        ef2, ef_unflatten = flatten_nodes(ef_state)
    mixed, new_e = ccol.collective_round(xf, ef2, compressor.name, seed,
                                         n_pods=n_pods)
    return unflatten(mixed), (ef_unflatten(new_e) if ef2 is not None
                              else None)


def _compressed_collective(params, compressor, ef_state, seed, *, phase,
                           n_pods, use_fused, axis, caller):
    if axis != 0:
        raise ValueError(f"{caller}: the compressed collective requires the "
                         f"node axis at position 0 (got axis={axis})")
    if use_fused:
        from repro_torch.kernels import mixing_cuda
        n = tree_leaves(params)[0].shape[0]
        return mixing_cuda.collective_step_mix(
            params, compressor=compressor, ef_state=ef_state, seed=seed,
            phase=phase, n_nodes=n, n_pods=n_pods)
    return _collective_round_reference(params, compressor, ef_state, seed,
                                       n_pods=n_pods)


def global_average_pytree(params: PyTree, axis: int = 0, comm_dtype=None,
                          backend: str = "reference",
                          leaf_threshold: Optional[int] = None,
                          compressor=None, ef_state: Optional[PyTree] = None,
                          seed: int = 0):
    """Periodic global averaging ``x ← (1/n)𝟙𝟙ᵀ x`` (All-Reduce step).

    With a lossy ``compressor`` the round runs the compressed collective
    (superseding ``comm_dtype``).  With any ``compressor`` the return value
    is ``(mixed, new_ef_state)``."""
    use_fused = _check_backend(backend, axis,
                               "mixing.global_average_pytree")
    if compressor is not None and compressor.lossy:
        return _compressed_collective(
            params, compressor, ef_state, seed, phase="global", n_pods=1,
            use_fused=use_fused, axis=axis,
            caller="mixing.global_average_pytree")
    if use_fused:
        from repro_torch.kernels import mixing_cuda
        n = tree_leaves(params)[0].shape[0]
        out = mixing_cuda.global_average(params, n, comm_dtype=comm_dtype,
                                         leaf_threshold=leaf_threshold)
    else:
        def avg(p):
            m = _wire_mean(p, axis, comm_dtype)
            return m.expand(p.shape).to(p.dtype).contiguous()

        out = tree_map(avg, params)
    return (out, ef_state) if compressor is not None else out


def pod_average_pytree(params: PyTree, n_pods: int, axis: int = 0,
                       comm_dtype=None, backend: str = "reference",
                       leaf_threshold: Optional[int] = None,
                       compressor=None, ef_state: Optional[PyTree] = None,
                       seed: int = 0):
    """Exact average within each pod's block of nodes (Hier-PGA round);
    a lossy ``compressor`` runs the intra-pod collective compressed, with
    the contract of :func:`global_average_pytree`."""
    use_fused = _check_backend(backend, axis, "mixing.pod_average_pytree")
    n = tree_leaves(params)[0].shape[axis]
    _check_pods(n, n_pods, "mixing.pod_average_pytree")
    if compressor is not None and compressor.lossy:
        return _compressed_collective(
            params, compressor, ef_state, seed, phase="pod_avg",
            n_pods=n_pods, use_fused=use_fused, axis=axis,
            caller="mixing.pod_average_pytree")
    if use_fused:
        from repro_torch.kernels import mixing_cuda
        out = mixing_cuda.pod_average(params, n, n_pods,
                                      comm_dtype=comm_dtype,
                                      leaf_threshold=leaf_threshold)
    else:
        def avg(p):
            per = p.shape[axis] // n_pods
            shp = tuple(p.shape[:axis]) + (n_pods, per) + tuple(
                p.shape[axis + 1:])
            m = _wire_mean(p.reshape(shp), axis + 1, comm_dtype)
            return m.expand(shp).reshape(p.shape).to(p.dtype)

        out = tree_map(avg, params)
    return (out, ef_state) if compressor is not None else out


# ---------------------------------------------------------------------------
# Compressed rounds (reference math)
# ---------------------------------------------------------------------------
def compensated_round_factors(phase: str, topology: str, n: int,
                              step: int = 0, n_pods: int = 1):
    """``(w, M)`` of the self-compensated round ``x + (M·q − w ⊙ q)``,
    ``w = 1 − diag(W)``, as float32 numpy arrays."""
    from repro_torch.kernels.mixing_cuda import phase_matrices
    d, M = phase_matrices(phase, topology, n, step=step, n_pods=n_pods)
    return (1.0 - d).astype(np.float32), M


def _compressed_round_reference(params: PyTree, q: PyTree, phase: str,
                                topology: str, n: int, step: int,
                                n_pods: int, comm_dtype=None) -> PyTree:
    """``x + (M·q − w ⊙ q)`` leaf by leaf with a dense M (the oracle of the
    fused path).  The global phase wire-casts both occurrences of q to
    ``comm_dtype``."""
    w, M = compensated_round_factors(phase, topology, n, step, n_pods)
    leaves, treedef = tree_flatten(params)
    dev = leaves[0].device
    wt, Mt = torch.from_numpy(w).to(dev), torch.from_numpy(M).to(dev)
    cast = comm_dtype if phase == "global" else None
    out = []
    for x, qq in zip(leaves, tree_flatten(q)[0]):
        x2 = x.reshape(n, -1).to(torch.float32)
        q2 = qq.reshape(n, -1).to(torch.float32)
        if cast is not None:
            q2 = q2.to(cast).to(torch.float32)
        corr = torch.matmul(Mt, q2) - wt * q2
        out.append((x2 + corr).reshape(x.shape).to(x.dtype))
    return tree_unflatten(treedef, out)


def _communicate_compressed(params: PyTree, *, spec: CommSpec, ef_state,
                            seed: int, phase: str, step: int, axis: int):
    """Compressor-aware dispatch behind :func:`communicate`: always
    ``(mixed, new_ef_state)``.  ``spec.global_compressor`` supersedes the
    averaging phases (lossy: the compressed collective; identity: the exact
    average); ``spec.compressor`` handles gossip rounds."""
    compressor, global_compressor = spec.compressor, spec.global_compressor
    n_nodes, n_pods = spec.n_nodes, spec.n_pods
    if phase not in PHASES:
        raise ValueError(f"unknown communication phase {phase!r}")
    if phase == "pod_avg":
        _check_pods(n_nodes, n_pods, "mixing.communicate")
    if phase == "none" or n_nodes == 1:
        return params, ef_state
    exact = spec.replace(compressor=None, global_compressor=None)
    if global_compressor is not None and phase in ("global", "pod_avg"):
        if global_compressor.lossy:
            kw = dict(axis=axis, backend=spec.backend,
                      compressor=global_compressor, ef_state=ef_state,
                      seed=seed)
            if phase == "global":
                return global_average_pytree(params, **kw)
            return pod_average_pytree(params, n_pods, **kw)
        # identity global codec: the exact average, whatever the gossip
        # compressor is
        return communicate(params, exact, phase=phase, step=step,
                           axis=axis), ef_state
    if compressor is None or not compressor.lossy:
        return communicate(params, exact, phase=phase, step=step,
                           axis=axis), ef_state
    # gossip/pod_avg: the lossy payload is the wire and supersedes
    # comm_dtype; global: the averaging operand is uncompressed fp32 sums,
    # so comm_dtype still wire-casts it
    if spec.backend == "pallas":
        from repro_torch.kernels import mixing_cuda
        return mixing_cuda.compressed_step_mix(
            params, compressor=compressor, ef_state=ef_state, seed=seed,
            phase=phase, topology=spec.topology, n_nodes=n_nodes, step=step,
            n_pods=n_pods, comm_dtype=spec.comm_dtype)
    from repro_torch import compress as compress_mod
    q, new_ef = compress_mod.apply_tree(compressor, params, ef_state, seed)
    mixed = _compressed_round_reference(params, q, phase, spec.topology,
                                        n_nodes, step, n_pods,
                                        comm_dtype=spec.comm_dtype)
    return mixed, new_ef


# ---------------------------------------------------------------------------
# Communication-op selector used by the training step
# ---------------------------------------------------------------------------
def communicate(params: PyTree, spec: CommSpec, *, phase: str,
                step: int = 0, axis: int = 0,
                ef_state: Optional[PyTree] = None, seed: int = 0):
    """Apply one communication round to node-stacked parameters.

    phase: ``"none"`` (no communication), ``"gossip"`` (``x ← W x``),
    ``"global"`` (``x ← x̄``), ``"pod_avg"`` (exact average per pod).

    With ``spec.compressor`` or ``spec.global_compressor`` set the return
    value is ``(mixed, new_ef_state)``: ``ef_state`` is the per-node
    error-feedback memory (None: no error feedback), ``seed`` the round's
    randomness key (the training step, for unbiased rounding across
    steps).  The identity codec routes to the exact uncompressed path.
    """
    _check_backend(spec.backend, axis, "mixing.communicate")
    if spec.compressor is not None or spec.global_compressor is not None:
        if axis != 0:
            raise ValueError("mixing.communicate: compression requires the "
                             f"node axis at position 0 (got axis={axis})")
        return _communicate_compressed(params, spec=spec, ef_state=ef_state,
                                       seed=seed, phase=phase, step=step,
                                       axis=axis)
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
