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

Sharded rounds (:func:`communicate_sharded`): with a ``CommSpec.mesh``
whose node axis has more than one shard, the fused backend runs the round
shard by shard, each shard's ``(m, D)`` row-block through the per-shard
kernels (``shard_mix.cu``, ``shard_cmix.cu``).  Every shard of a
:class:`repro_torch.core.mesh.Mesh` sits on one device in this process:
the shard body runs once per shard in a fixed order, the reference's
``ppermute`` halo exchange is a gather of the neighbours' row-blocks, and
its ``psum`` a fixed-order sum over the shards (no interconnect).
Push-sum and overlap rounds, 2-D ``(node, model)`` meshes and shards on
several cards are not ported yet (ROADMAP A.4, A.5, A.10).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)

PyTree = Any

BACKENDS = ("reference", "pallas")
PHASES = ("none", "gossip", "global", "pod_avg")
SHARD_MODES = ("auto", "stacked", "sharded")


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Round-invariant communication configuration.  ``mesh`` (a
    :class:`repro_torch.core.mesh.Mesh`, or None), ``node_axis`` and
    ``shard_mode`` route the fused backend through the sharded rounds.
    Build it with ``DistConfig.comm_spec``."""
    topology: str
    n_nodes: int
    n_pods: int = 1
    backend: str = "reference"
    mesh: Any = None
    node_axis: str = "data"
    shard_mode: str = "auto"
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
        if self.shard_mode not in SHARD_MODES:
            raise ValueError(f"CommSpec: unknown shard_mode "
                             f"{self.shard_mode!r} "
                             f"(expected one of {SHARD_MODES})")
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

    def uses_sharded(self) -> bool:
        """True when rounds route through the sharded per-shard path."""
        return use_sharded_backend(self.backend, self.mesh, self.node_axis,
                                   self.shard_mode)


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
# Mesh axes (the reference's DistConfig.node_axis semantics)
# ---------------------------------------------------------------------------
def node_axis_names(mesh, node_axis: str = "data") -> Tuple[str, ...]:
    """Mesh axis names forming the gossip node axis: ``"data"`` flattens
    ``(pod, data)`` when a pod axis exists (row-major shard order);
    ``"pod"`` gossips across pods only."""
    axes = dict(mesh.shape)
    if node_axis == "data":
        return tuple(a for a in ("pod", "data") if a in axes)
    if node_axis == "pod":
        # single-pod meshes have no 'pod' axis: one gossip node, no shards
        return ("pod",) if "pod" in axes else ()
    if node_axis in axes:  # explicit mesh axis (tests / custom meshes)
        return (node_axis,)
    raise ValueError(f"node_axis must be 'data', 'pod', or a mesh axis "
                     f"name, got {node_axis!r}")


def node_shard_count(mesh, node_axis: str = "data") -> int:
    """How many shards the node axis is split over on ``mesh`` (1 = local)."""
    if mesh is None:
        return 1
    names = node_axis_names(mesh, node_axis)
    return int(np.prod([mesh.shape[a] for a in names], dtype=np.int64)) \
        if names else 1


def use_sharded_backend(backend: str, mesh, node_axis: str = "data",
                        shard_mode: str = "auto") -> bool:
    """True when ``communicate`` should route the fused backend through
    the sharded rounds: the node axis has several shards and the mode
    allows it."""
    if shard_mode not in SHARD_MODES:
        raise ValueError(f"unknown comm_shard_mode {shard_mode!r} "
                         f"(expected one of {SHARD_MODES})")
    if backend != "pallas" or shard_mode == "stacked":
        return False
    sharded = node_shard_count(mesh, node_axis) > 1
    if shard_mode == "sharded" and not sharded:
        raise ValueError("comm_shard_mode='sharded' requires a mesh whose "
                         "node axis spans more than one shard (got "
                         "mesh="
                         f"{'None' if mesh is None else dict(mesh.shape)})")
    return sharded


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
            if spec.uses_sharded():
                return _communicate_sharded_collective(
                    params, compressor=global_compressor, ef_state=ef_state,
                    seed=seed, phase=phase, n_nodes=n_nodes, n_pods=n_pods,
                    mesh=spec.mesh, node_axis=spec.node_axis,
                    caller="mixing.communicate")
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
    if spec.uses_sharded():
        return communicate_sharded(
            params, spec.replace(global_compressor=None), phase=phase,
            step=step, ef_state=ef_state, seed=seed)
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

    With a ``spec.mesh`` whose node axis has more than one shard, the
    fused backend routes through :func:`communicate_sharded` unless
    ``spec.shard_mode == "stacked"`` forces the stacked path;
    ``"sharded"`` without such a mesh raises ``ValueError``.
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
    if spec.uses_sharded():
        return communicate_sharded(params, spec, phase=phase, step=step)
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


# ---------------------------------------------------------------------------
# Sharded rounds: one (m, D) row-block per node shard, per-shard kernels
# ---------------------------------------------------------------------------
def _shard_blocks(M: np.ndarray, d: np.ndarray, n: int, k: int):
    """Block decomposition of one round for k node-axis shards of m = n/k
    rows each.

    Returns ``(offsets, Mstack, dstack)``: ``offsets`` the sorted shard
    offsets q such that *some* shard r has a nonzero block ``M[r, (r+q)
    mod k]`` (only those blocks are gathered); ``Mstack[r]`` shard r's
    ``(m, |offsets|·m)`` factor over the gathered blocks (pod_avg is
    block-diagonal, hence per-shard rows); ``dstack[r]`` its rows of the
    self-weight diagonal."""
    m = n // k
    offsets = [q for q in range(k)
               if any(np.any(M[r * m:(r + 1) * m,
                              ((r + q) % k) * m:(((r + q) % k) + 1) * m])
                      for r in range(k))]
    if not offsets:  # e.g. disconnected gossip: M = 0, the round is d ⊙ x
        offsets = [0]
    Mstack = np.zeros((k, m, len(offsets) * m), np.float32)
    for r in range(k):
        for j, q in enumerate(offsets):
            c = (r + q) % k
            Mstack[r, :, j * m:(j + 1) * m] = \
                M[r * m:(r + 1) * m, c * m:(c + 1) * m]
    return offsets, Mstack, d.reshape(k, m, 1).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_shard_blocks(phase: str, topology: str, n: int, step: int,
                         n_pods: int, k: int, device: torch.device):
    """``(offsets, Mstack, dstack, wstack)`` of one round kind on
    ``device``, made once (a fresh host-to-device copy every round would
    wait for the stream); ``wstack = 1 − dstack``."""
    from repro_torch.kernels.mixing_cuda import phase_matrices
    d, M = phase_matrices(phase, topology, n, step=step, n_pods=n_pods)
    offsets, Mstack, dstack = _shard_blocks(M, d, n, k)
    wstack = (1.0 - dstack).astype(np.float32)
    return (tuple(offsets),) + tuple(torch.from_numpy(a).to(device)
                                     for a in (Mstack, dstack, wstack))


def _divide(acc: torch.Tensor, count: int) -> torch.Tensor:
    """``acc / count`` by a tensor divisor: CUDA division by a Python
    scalar multiplies by its reciprocal, one bit off the IEEE quotient."""
    return acc / torch.full_like(acc[..., :1], float(count))


def _shard_count(mesh, node_axis: str, n_nodes: int, who: str) -> int:
    """The node shard count k of a sharded round; raises on what the round
    cannot run (``make_mesh`` refuses the 2-D meshes)."""
    if mesh is None:
        raise ValueError(f"{who}: a mesh is required (pass a CommSpec built "
                         f"with mesh=..., or mesh= directly)")
    names = node_axis_names(mesh, node_axis)
    if not names:
        raise ValueError(f"{who}: mesh {dict(mesh.shape)} has no axis for "
                         f"node_axis={node_axis!r} — use the stacked path "
                         f"(communicate) instead")
    k = node_shard_count(mesh, node_axis)
    if n_nodes % k:
        raise ValueError(f"{who}: n_nodes={n_nodes} not divisible by the "
                         f"{k} node-axis shards of mesh axes {names}")
    return k


def communicate_sharded(params: PyTree, spec: CommSpec, *, phase: str,
                        step: int = 0, grads: Optional[PyTree] = None,
                        gamma=None, with_residual: bool = False,
                        ef_state: Optional[PyTree] = None, seed: int = 0):
    """One communication round with the node axis sharded over
    ``spec.mesh``.

    ``spec``'s ``backend``/``shard_mode``/``leaf_threshold`` are ignored:
    calling this function *is* the sharded routing decision.

    Each of the k shards owns the ``m = n/k`` rows of its nodes in the
    packed ``(n, D)`` fp32 matrix.  Shard by shard, in order r = 0 … k−1:
    the neighbour row-blocks named by the round's block decomposition
    (:func:`_shard_blocks`) are gathered, wire-cast when ``comm_dtype`` is
    set (the self block too; the self term ``d ⊙ x`` uses the uncast
    rows; consecutive fp32 row-blocks are gathered as a view of the
    input, the others copied per shard and freed), and ``shard_mix.cu``
    writes ``d ⊙ x + M_r · xs`` into the
    shard's rows of one fresh ``(n, D)`` output, so no shard reads another
    shard's mixed rows.  The ``"global"`` phase is the fixed-order sum of
    the shards' wire-cast column sums, divided by n and broadcast to every
    row.

    With ``grads``/``gamma`` the SGD half-step is applied before the
    exchange.  With ``with_residual`` returns ``(mixed, x̄, Σ_i‖x_i −
    x̄‖²)``: x̄ from the fixed-order sum of the kernel's per-shard column
    sums, the residual from a second pass per shard (the cancellation-free
    form); a global round's residual is exactly 0.

    A lossy ``spec.compressor`` compresses each shard's rows, rebuilds
    the gathered neighbours' estimates from their wire arrays and runs
    ``shard_cmix.cu``; a lossy ``spec.global_compressor`` runs the
    averaging phases through :func:`_communicate_sharded_collective`.
    Either returns ``(mixed, new_ef_state)``; an identity codec routes to
    the exact path.
    """
    from repro_torch.kernels import mixing_cuda

    topology, n_nodes = spec.topology, spec.n_nodes
    comm_dtype, n_pods = spec.comm_dtype, spec.n_pods
    compressor, global_compressor = spec.compressor, spec.global_compressor
    who = "communicate_sharded"
    k = _shard_count(spec.mesh, spec.node_axis, n_nodes, who)
    if phase not in ("gossip", "global", "pod_avg"):
        raise ValueError(f"{who}: no sharded kernel for phase {phase!r}")
    if phase == "pod_avg":
        _check_pods(n_nodes, n_pods, "mixing.communicate_sharded")
    exact = spec.replace(compressor=None, global_compressor=None)
    fused = grads is not None or with_residual
    if global_compressor is not None and phase in ("global", "pod_avg"):
        if fused:
            raise ValueError(f"{who}: the compressed collective composes "
                             f"with neither the fused half-step nor the "
                             f"fused residual")
        if global_compressor.lossy:
            return _communicate_sharded_collective(
                params, compressor=global_compressor, ef_state=ef_state,
                seed=seed, phase=phase, n_nodes=n_nodes, n_pods=n_pods,
                mesh=spec.mesh, node_axis=spec.node_axis,
                caller="mixing.communicate_sharded")
        # identity collective: the exact path; the global codec supersedes
        # the gossip compressor for the averaging phases
        return communicate_sharded(params, exact, phase=phase,
                                   step=step), ef_state
    if compressor is not None:
        if not compressor.lossy:   # identity: exact uncompressed path
            return communicate_sharded(params, exact, phase=phase,
                                       step=step), ef_state
        if fused:
            raise ValueError(f"{who}: compression composes with neither the "
                             f"fused half-step nor the fused residual")
        return _communicate_sharded_compressed(
            params, compressor=compressor, ef_state=ef_state, seed=seed,
            phase=phase, topology=topology, n_nodes=n_nodes, step=step,
            n_pods=n_pods, k=k, comm_dtype=comm_dtype)
    if grads is not None and gamma is None:
        raise ValueError("grads given without gamma")
    # grid gossip ignores comm_dtype in the reference path — mirror that
    wire_dtype = None if (phase == "gossip" and topology == "grid") \
        else comm_dtype
    n, m = n_nodes, n_nodes // k
    x, unflatten = mixing_cuda.flatten_nodes(params)
    x = x.contiguous()
    if grads is not None:
        gam = gamma if torch.is_tensor(gamma) else torch.tensor(
            gamma, dtype=torch.float32)
        x = x - gam.to(torch.float32) * mixing_cuda.flatten_nodes(grads)[0]

    if phase == "global":
        acc = None
        for r in range(k):
            xr = x[r * m:(r + 1) * m]
            if wire_dtype is not None:
                xr = xr.to(wire_dtype).to(torch.float32)
            cs = torch.sum(xr, dim=0, keepdim=True)
            acc = cs if acc is None else acc + cs
        xbar = _divide(acc, n)
        mixed = unflatten(xbar.expand(x.shape).contiguous())
        if with_residual:
            return (mixed, unflatten(xbar, drop_node=True),
                    torch.zeros((), dtype=torch.float32, device=x.device))
        return mixed

    offsets, Mstack, dstack, _ = _device_shard_blocks(
        phase, topology, n, step, n_pods, k, x.device)
    send = x.to(wire_dtype) if wire_dtype is not None else x
    out = torch.empty_like(x)
    acc = None
    for r in range(k):
        src = [(r + q) % k for q in offsets]
        if wire_dtype is None and src == list(range(src[0],
                                                    src[0] + len(src))):
            # consecutive row-blocks of the fp32 input: a view, no copy
            xs = x[src[0] * m:(src[-1] + 1) * m]
        else:
            xs = torch.cat([send[c * m:(c + 1) * m] for c in src]).to(
                torch.float32)
        res = mixing_cuda.shard_mix_block(
            x[r * m:(r + 1) * m], xs, dstack[r], Mstack[r],
            with_residual=with_residual, out=out[r * m:(r + 1) * m])
        del xs
        if with_residual:
            acc = res[1] if acc is None else acc + res[1]
    del send
    if not with_residual:
        return unflatten(out)
    xbar = _divide(acc, n)
    resid = None
    for r in range(k):
        part = torch.sum((out[r * m:(r + 1) * m] - xbar).square_())
        resid = part if resid is None else resid + part
    return unflatten(out), unflatten(xbar, drop_node=True), resid


def _shard_rows(arrs, n: int, r: int, m: int):
    """Shard r's slice of the wire arrays: rows ``r·m … r·m + m − 1`` of the
    node-stacked ones; node-independent arrays (leading axis 1, e.g.
    randk's shared column indices) ride whole."""
    return [a[r * m:(r + 1) * m] if a.shape[0] == n else a for a in arrs]


def _sharded_wire_build(params: PyTree, *, compressor, ef_state, seed,
                        n: int):
    """Row-local compression of the stacked state into per-leaf wire
    arrays (+ the EF update), as every shard would compress its own rows.
    Returns ``(wires, new_ef_state, sizes)`` with ``sizes`` the per-leaf
    column widths the decode side needs."""
    from repro_torch import compress as compress_mod

    leaves = tree_leaves(params)
    sizes = [int(np.prod(lf.shape[1:], dtype=np.int64)) for lf in leaves]
    x2 = [lf.reshape(n, -1).to(torch.float32) for lf in leaves]
    e2 = None
    if ef_state is not None:
        ef_leaves, ef_def = tree_flatten(ef_state)
        e2 = [e.reshape(n, -1).to(torch.float32) for e in ef_leaves]
    wires, new_e2 = compress_mod.compress_tree(compressor, x2, e2, seed)
    new_ef = None
    if ef_state is not None:
        new_ef = tree_unflatten(ef_def, [
            e.reshape(lf.shape).to(lf.dtype)
            for e, lf in zip(new_e2, ef_leaves)])
    return wires, new_ef, sizes


def _wire_arrays(wires):
    """The wire arrays of every leaf, flat: payload then aux, leaf by leaf."""
    return [a for w in wires for a in (*w.payload, *w.aux)]


def _wire_build_q(compressor, wires, sizes):
    """Factory of the row-block estimate rebuild: ``build_q(arrs, out)``
    decodes a flat list of wire arrays into the dense ``(rows, D)``
    estimate, leaf by leaf into ``out``'s column ranges."""
    from repro_torch.compress import LeafWire

    counts = [len(w.payload) + len(w.aux) for w in wires]

    def build_q(arrs, out: torch.Tensor) -> torch.Tensor:
        pos, col = 0, 0
        for w0, c, d_leaf in zip(wires, counts, sizes):
            grp = arrs[pos:pos + c]
            wire = LeafWire(payload=tuple(grp[:len(w0.payload)]),
                            aux=tuple(grp[len(w0.payload):]))
            out[:, col:col + d_leaf] = compressor.decompress_leaf(wire,
                                                                  d_leaf)
            pos += c
            col += d_leaf
        return out

    return build_q


def _communicate_sharded_compressed(params: PyTree, *, compressor, ef_state,
                                    seed, phase: str, topology: str,
                                    n_nodes: int, step: int, n_pods: int,
                                    k: int, comm_dtype=None):
    """Compressed sharded round: each shard's rows are compressed
    (row-local), the wire arrays of the neighbour blocks named by the
    round's block decomposition are gathered and decoded into their
    estimates ``q``, and ``shard_cmix.cu`` applies ``x + (M_r · qs −
    (1 − d_r) ⊙ q_self)``.  The ``"global"`` phase applies ``x + (q̄ − q)``
    around the fixed-order sum of the shards' column sums of ``q``,
    wire-cast per ``comm_dtype`` (both occurrences).  Returns ``(mixed,
    new_ef_state)``."""
    from repro_torch.kernels import mixing_cuda

    n, m = n_nodes, n_nodes // k
    wires, new_ef, sizes = _sharded_wire_build(
        params, compressor=compressor, ef_state=ef_state, seed=seed, n=n)
    arrs = _wire_arrays(wires)
    build_q = _wire_build_q(compressor, wires, sizes)
    x, unflatten = mixing_cuda.flatten_nodes(params)
    x = x.contiguous()
    D = x.shape[1]

    if phase == "global":
        q = torch.empty_like(x)
        acc = None
        for r in range(k):
            qr = build_q(_shard_rows(arrs, n, r, m), q[r * m:(r + 1) * m])
            if comm_dtype is not None:
                qr.copy_(qr.to(comm_dtype))
            cs = torch.sum(qr, dim=0, keepdim=True)
            acc = cs if acc is None else acc + cs
        return unflatten(x + (_divide(acc, n) - q)), new_ef

    offsets, Mstack, _, wstack = _device_shard_blocks(
        phase, topology, n, step, n_pods, k, x.device)
    out = torch.empty_like(x)
    for r in range(k):
        qs = torch.empty((len(offsets) * m, D), dtype=torch.float32,
                         device=x.device)
        for j, q in enumerate(offsets):
            build_q(_shard_rows(arrs, n, (r + q) % k, m),
                    qs[j * m:(j + 1) * m])
        if 0 in offsets:
            j0 = offsets.index(0)
            q_self = qs[j0 * m:(j0 + 1) * m]
        else:
            q_self = build_q(_shard_rows(arrs, n, r, m),
                             torch.empty((m, D), dtype=torch.float32,
                                         device=x.device))
        mixing_cuda.shard_comp_mix_block(
            x[r * m:(r + 1) * m], q_self, qs, wstack[r], Mstack[r],
            out=out[r * m:(r + 1) * m])
        del qs, q_self
    return unflatten(out), new_ef


def _communicate_sharded_collective(params: PyTree, *, compressor, ef_state,
                                    seed, phase: str, n_nodes: int,
                                    n_pods: int, mesh,
                                    node_axis: str = "data",
                                    qblock: Optional[int] = None,
                                    caller: Optional[str] = None):
    """Compressed global/pod-averaging collective with the node axis
    sharded over ``mesh`` (plain PyTorch: the reference runs it without a
    kernel too).

    Stage-1 quantization, the EF residual ``e' = y − q₁`` and the local
    emulation ``ρ = Q₂(q₁)`` are row-local.  The reference's
    ``all_to_all`` of the stage-1 codes and exponent bytes hands shard s
    the column segment ``s·seg … (s+1)·seg − 1`` of every row: the owner
    dequantizes it, takes the anchored (per-pod) mean and re-quantizes it
    at its absolute columns (``col0 = s·seg``); the ``all_gather`` of the
    owners' stage-2 codes is their concatenation.  The packed columns are
    padded to ``k · qblock`` so every segment starts on a scale block.
    Returns ``(x + (r − ρ), e')``."""
    from repro_torch.compress import collective as ccol
    from repro_torch.kernels import mixing_cuda

    who = caller or "mixing._communicate_sharded_collective"
    k = _shard_count(mesh, node_axis, n_nodes, who)
    n = n_nodes
    pods = n_pods if phase == "pod_avg" else 1
    _check_pods(n, pods, who)
    kind = compressor.name
    qb = ccol.QBLOCK if qblock is None else qblock

    xf, unflatten = mixing_cuda.flatten_nodes(params)
    D = xf.shape[1]
    xp = ccol.pad_cols(xf, k * qb)
    del xf
    y = xp
    ef_unflatten = None
    if ef_state is not None:
        ef2, ef_unflatten = mixing_cuda.flatten_nodes(ef_state)
        y = xp + ccol.pad_cols(ef2, k * qb)
        del ef2
    Dp = xp.shape[1]
    s1, s2 = ccol.stage_seeds(seed)
    codes1, scales1, q1 = ccol.quantize_blocks(y, kind, s1, qb)
    new_ef = None if ef_unflatten is None else (y - q1)[:, :D]
    del y
    rho = ccol.quantize_blocks(q1, kind, s2, qb)[2]
    del q1
    exps1 = ccol.scale_exponents(scales1)
    seg = Dp // k
    nbs = seg // qb
    r_all = torch.empty((pods, Dp), dtype=torch.float32, device=xp.device)
    for s in range(k):
        q_seg = ccol.dequant_blocks(
            codes1[:, s * seg:(s + 1) * seg],
            ccol.exponent_scales(exps1[:, s * nbs:(s + 1) * nbs]), qb)
        mbar = ccol.anchored_mean(q_seg, pods)
        c2, sc2, _ = ccol.quantize_blocks(mbar, kind, s2, qb, col0=s * seg)
        r_all[:, s * seg:(s + 1) * seg] = ccol.dequant_blocks(
            c2, ccol.exponent_scales(ccol.scale_exponents(sc2)), qb)
        del q_seg, mbar, c2
    del codes1
    per = n // pods
    mixed = (xp.reshape(pods, per, Dp)
             + (r_all[:, None] - rho.reshape(pods, per, Dp))).reshape(
                 n, Dp)[:, :D]
    return unflatten(mixed), (None if ef_unflatten is None
                              else ef_unflatten(new_ef))
