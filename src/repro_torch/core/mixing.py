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
kernels (``shard_mix.cu``, ``shard_cmix.cu``).  The shard body runs once
per shard this process owns (``Mesh.owned_shards``), in shard order.  On
a local :class:`repro_torch.core.mesh.Mesh` (every shard in this process)
the reference's ``ppermute`` halo exchange is a slice of the neighbours'
row-blocks and its ``psum`` a left fold over the shards; on a rank mesh
(one ``torch.distributed`` rank per shard, holding only its m rows) the
row-blocks and wire arrays cross the mesh's ``Exchange.halo`` and every
sum over shards is ``Exchange.fold``, the same left fold on the gathered
partials.  Both kinds run the same round code, so a rank's rows are the
one-process round's bits.  :func:`gossip_ppermute`,
:func:`global_average_ppermute` and :func:`make_shard_map_mixer` are the
reference's explicit runtime on either kind.

Push-sum rounds (:func:`communicate_push_sum`): ``(x, w) ← (W·x, W·w)``
for a runtime column-stochastic W (new data every step under faults),
stacked through the dense-W entry points of the fused kernels, or sharded
through ``shard_mix.cu`` with halo offsets from a static superset.

Overlapped rounds (:func:`start_round`, :func:`finish_round`,
:func:`overlap_flush`): step t captures its wire payload ``b`` (the
double buffer, which owns its storage) and step t+1 applies it to its own
half-step iterate as ``x + (M·b − (1 − d)⊙b)``, with the factors of the
issuing step's shift.  The stacked fused apply runs ``shard_cmix.cu`` once
per dispatch group of the parameters (``q_self = qs = b``), not once on
the whole packed tree as the reference does: the round is column-local,
so every column's result is the same bits either way, and the per-group
apply stages at most one group's operands where packing the full tree
would copy x, b and the output whole.  The sharded apply gathers the
buffered row-blocks (dense) or wire arrays (lossy) over the round's halo
offsets and runs ``shard_cmix.cu`` per shard.  Global and pod rounds
flush synchronously and re-prime the buffer.  :func:`issue_round` starts
that gather before the step that applies it runs its forward and
backward (the reference's ``ppermute`` inside the next step's graph): on
a rank mesh an exchange in flight on its own process group
(``Exchange.halo_start``), on a one-process mesh on the card a side
stream, on CPU tensors at once; :func:`finish_round` then waits for it,
and the apply's operands are the serial gather's bytes.

Telemetry: with an ambient :class:`repro_torch.obs.Telemetry` hub
installed, every public round entry point (:func:`communicate`,
:func:`start_round`, :func:`finish_round`, :func:`overlap_flush`,
:func:`communicate_push_sum`) emits one ``comm_round`` record (analytic
against measured wire bytes, from shapes only) and runs in a ``comm/*``
span; with none installed the hooks are a None check.  The step's fused
route, which bypasses :func:`communicate`, meters through
:func:`meter_round`.  The Trainer and ``simulate`` install the hub for a
step variant's first call only, so a run emits one record per round of
each variant, as the reference's traced meters do.

2-D rounds (ROADMAP A.10.2): on a mesh that also has a model axis
(``CommSpec.model_axis``) every sharded round slices the packed columns
into k_model chunks (the reference's ``flatten_nodes_sharded`` layout),
each packed into its own contiguous tensor, and runs the shard bodies
chunk by chunk on ``(m, D/k_model)`` blocks (see
:func:`communicate_sharded`); the compressed collective slices the plain
packed columns, as the reference does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings
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
    ``shard_mode`` route the fused backend through the sharded rounds;
    ``model_axis`` names the mesh axis they slice the packed columns over
    (2-D rounds).  Build it with ``DistConfig.comm_spec``."""
    topology: str
    n_nodes: int
    n_pods: int = 1
    backend: str = "reference"
    mesh: Any = None
    node_axis: str = "data"
    model_axis: str = "model"
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
                                   self.shard_mode, self.model_axis)


# ---------------------------------------------------------------------------
# Telemetry hooks: one comm_round record and one comm/* span per public
# round while an ambient hub is installed; a None check otherwise
# ---------------------------------------------------------------------------
def _hub():
    from repro_torch import obs
    return obs.get_telemetry()


def _meter(tel, params: PyTree, spec: "CommSpec", *, phase: str, step: int,
           role: str, wires=None) -> None:
    """Emit one ``comm_round`` record; metering never breaks a round, so
    an accounting error degrades to a warning."""
    try:
        from repro_torch.obs import meters as obs_meters
        if spec.mesh is not None and spec.mesh.distributed:
            params, wires = _global_shapes(params, wires, spec.n_nodes)
        sharded = spec.uses_sharded()
        km = (model_shard_count(spec.mesh, spec.model_axis, spec.node_axis)
              if sharded else 1)
        fields = obs_meters.comm_round_fields(
            params, phase=phase, topology=spec.topology,
            n_nodes=spec.n_nodes, step=int(step), n_pods=spec.n_pods,
            backend=spec.backend, sharded=sharded,
            comm_dtype=spec.comm_dtype, compressor=spec.compressor,
            global_compressor=spec.global_compressor, model_shards=km,
            wires=wires, role=role)
        tel.emit("comm_round", **fields)
    except Exception as e:                           # pragma: no cover
        warnings.warn(f"mixing: comm_round meter failed ({e}); "
                      f"round unaffected")


def _global_shapes(params: PyTree, wires, n: int):
    """Shape-only (meta) stand-ins for a rank's rows with the node axis
    at its full n, so a rank meters the whole round as one process
    would."""
    rows = tree_leaves(params)[0].shape[0]

    def full(a):
        lead = (n,) if a.dim() and a.shape[0] == rows else tuple(a.shape[:1])
        return torch.empty(lead + tuple(a.shape[1:]), dtype=a.dtype,
                           device="meta")

    if wires is not None:
        wires = [{"payload": tuple(full(a) for a in (
                      w["payload"] if isinstance(w, dict) else w.payload)),
                  "aux": tuple(full(a) for a in (
                      w["aux"] if isinstance(w, dict) else w.aux))}
                 for w in wires]
    return tree_map(full, params), wires


def meter_round(params: PyTree, spec: "CommSpec", *, phase: str,
                step: int = 0, role: str = "round", wires=None) -> None:
    """Metering hook for step functions whose fused kernels bypass
    :func:`communicate`: emit the record the metered entry points would.
    No-op without an ambient hub."""
    tel = _hub()
    if tel is not None:
        _meter(tel, params, spec, phase=phase, step=step, role=role,
               wires=wires)


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


def model_axis_names(mesh, model_axis: str = "model",
                     node_names: Tuple[str, ...] = ()) -> Tuple[str, ...]:
    """Mesh axis names forming the tensor-parallel model axis of the 2-D
    ``(node, model)`` sharded rounds (``DistConfig.model_axis``): the
    named axis when ``mesh`` has it and it is not part of the node axis,
    else ``()`` (columns replicated: the 1-D rounds)."""
    if not model_axis:
        return ()
    axes = dict(mesh.shape)
    if model_axis in axes and model_axis not in node_names:
        return (model_axis,)
    return ()


def _model_names_count(mesh, model_axis: str, node_names: Tuple[str, ...]):
    """``(mnames, k_model)`` of one sharded round: the one resolution of
    the model axis every sharded entry point shares."""
    mnames = model_axis_names(mesh, model_axis, node_names=node_names)
    km = int(np.prod([mesh.shape[a] for a in mnames], dtype=np.int64)) \
        if mnames else 1
    return mnames, km


def model_shard_count(mesh, model_axis: str = "model",
                      node_axis: str = "data") -> int:
    """How many column slices the model axis splits the packed state into
    on ``mesh`` (1 = replicated columns, the 1-D rounds)."""
    if mesh is None:
        return 1
    names = node_axis_names(mesh, node_axis)
    return _model_names_count(mesh, model_axis, names)[1]


def use_sharded_backend(backend: str, mesh, node_axis: str = "data",
                        shard_mode: str = "auto",
                        model_axis: str = "model") -> bool:
    """True when ``communicate`` should route the fused backend through
    the sharded rounds: the node axis has several shards and the mode
    allows it."""
    if shard_mode not in SHARD_MODES:
        raise ValueError(f"unknown comm_shard_mode {shard_mode!r} "
                         f"(expected one of {SHARD_MODES})")
    if mesh is not None and mesh.distributed:
        # a rank holds only its own rows: there is no stacked round, and
        # every mesh axis is a node axis or the model axis
        km = model_shard_count(mesh, model_axis, node_axis)
        if backend != "pallas" or shard_mode == "stacked" \
                or node_shard_count(mesh, node_axis) * km != mesh.size \
                or km != mesh.k_model:
            raise ValueError(
                "a rank mesh runs only the sharded rounds over all its "
                "shards (comm_backend='pallas', comm_shard_mode 'auto' or "
                f"'sharded'; got backend={backend!r}, shard_mode="
                f"{shard_mode!r}, node_axis={node_axis!r}, model_axis="
                f"{model_axis!r} on a mesh {dict(mesh.shape)} split over "
                f"{mesh.model_axis!r})")
        return True
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
# Explicit decentralized runtime: the reference's shard_map + ppermute
# ---------------------------------------------------------------------------
def _perm_for_shift(n: int, s: int) -> Tuple[Tuple[int, int], ...]:
    """The ``(src, dst)`` pairs of a ppermute by shift ``s``: node i
    receives from node ``(i + s) mod n``."""
    return tuple(((i + s) % n, i) for i in range(n))


def _ppermute(x: torch.Tensor, mesh, axis_name: str, s: int) -> torch.Tensor:
    """``jax.lax.ppermute(x, axis_name, _perm_for_shift(k, s))`` over the
    k shards of ``axis_name``: on a rank mesh ``x`` is this shard's block,
    sent to shard ``(r − s) mod k`` while shard ``(r + s) mod k``'s block
    arrives (``Exchange.halo``); on a local mesh ``x`` stacks every
    shard's block and the permutation is a roll by ``s`` blocks."""
    k = mesh.shape[axis_name]
    if mesh.distributed:
        return mesh.exchange.halo(x, (s % k,))
    return torch.roll(x, -(s % k) * (x.shape[0] // k), dims=0)


def gossip_ppermute(x: torch.Tensor, axis_name: str, n: int,
                    weights: Dict[int, float], *, mesh) -> torch.Tensor:
    """W·x where each shard along ``axis_name`` of ``mesh`` holds one
    node's block: ``Σ_s w_s · ppermute(x, s)`` in the decomposition's
    order, as the reference sums it.  The reference runs it inside
    ``shard_map`` and reads the mesh from that context; here the mesh is
    passed (on a rank mesh ``x`` is this rank's block, on a local mesh the
    stacked blocks of all n shards)."""
    if mesh.shape[axis_name] != n:
        raise ValueError(f"gossip_ppermute: {n} nodes on a mesh axis "
                         f"{axis_name!r} of {mesh.shape[axis_name]} shards")
    acc = None
    for s, w in weights.items():
        term = x if s == 0 else _ppermute(x, mesh, axis_name, s)
        term = term * torch.tensor(w, dtype=x.dtype)
        acc = term if acc is None else acc + term
    return acc


def global_average_ppermute(x: torch.Tensor, axis_name: str, *,
                            mesh) -> torch.Tensor:
    """All-reduce mean over the shards of ``axis_name`` (the reference's
    ``pmean``): the fixed-order sum over the shards, divided by their
    count; on a local mesh ``x`` stacks every shard's block and each gets
    the mean."""
    k = mesh.shape[axis_name]
    if mesh.distributed:
        return _divide(mesh.exchange.fold(x), k)
    blocks = x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))
    acc = None
    for b in blocks.unbind(0):
        acc = b if acc is None else acc + b
    mean = _divide(acc, k)
    return mean.unsqueeze(0).expand(blocks.shape).reshape(x.shape)


def make_shard_map_mixer(mesh, axis_name: str, topology: str,
                         step: int = 0):
    """``f(x) -> W·x`` over the shards of ``axis_name``, one node each:
    the explicit runtime counterpart of :func:`mix_pytree` (the
    reference's ``shard_map`` of :func:`gossip_ppermute`).  On a rank mesh
    ``f`` takes and returns this rank's node block."""
    n = mesh.shape[axis_name]
    weights = topo.shift_weights(topology, n, step)

    def node_fn(x: torch.Tensor) -> torch.Tensor:
        return gossip_ppermute(x, axis_name, n, weights, mesh=mesh)

    return node_fn


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
        return _communicate_impl(params, exact, phase=phase, step=step,
                                 axis=axis), ef_state
    if compressor is None or not compressor.lossy:
        return _communicate_impl(params, exact, phase=phase, step=step,
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
    tel = _hub()
    if tel is None:
        return _communicate_impl(params, spec, phase=phase, step=step,
                                 axis=axis, ef_state=ef_state, seed=seed)
    _meter(tel, params, spec, phase=phase, step=step, role="round")
    with tel.span("comm/round", phase=phase, shift=int(step)) as sp:
        return sp.fence(_communicate_impl(
            params, spec, phase=phase, step=step, axis=axis,
            ef_state=ef_state, seed=seed))


def _communicate_impl(params: PyTree, spec: CommSpec, *, phase: str,
                      step: int = 0, axis: int = 0,
                      ef_state: Optional[PyTree] = None, seed: int = 0):
    """The body of :func:`communicate`; internal re-dispatches call it
    directly, so a round is metered once."""
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
    wait for the stream) and copied by :func:`upload`; ``wstack = 1 −
    dstack``."""
    from repro_torch.kernels.mixing_cuda import phase_matrices
    d, M = phase_matrices(phase, topology, n, step=step, n_pods=n_pods)
    offsets, Mstack, dstack = _shard_blocks(M, d, n, k)
    wstack = (1.0 - dstack).astype(np.float32)
    return (tuple(offsets),) + tuple(upload(a, device)
                                     for a in (Mstack, dstack, wstack))


def _divide(acc: torch.Tensor, count: int) -> torch.Tensor:
    """``acc / count`` by a tensor divisor: CUDA division by a Python
    scalar multiplies by its reciprocal, one bit off the IEEE quotient."""
    return acc / torch.full_like(acc[..., :1], count)


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


def _owned_rows(x: torch.Tensor, mesh, k: int, n: int, who: str):
    """``(owned shards, m)`` of a sharded round whose packed operand ``x``
    holds this process's rows: all n on a local mesh, the m = n/k of its
    shard on a rank mesh."""
    owned = mesh.owned_shards(k)
    m = n // k
    if x.shape[0] != len(owned) * m:
        raise ValueError(f"{who}: {x.shape[0]} node rows here, expected "
                         f"{len(owned) * m} ({len(owned)} of {k} shards of "
                         f"{m} nodes)")
    return owned, m


def _shard_sum(mesh, parts):
    """The fixed-order sum over all k shards of the partials of the shards
    this process owns (in shard order): the left fold r = 0 … k − 1, here
    or on the rank mesh's gathered partials (``Exchange.fold``)."""
    if mesh.distributed:
        (part,) = parts
        return mesh.exchange.fold(part)
    acc = None
    for p in parts:
        acc = p if acc is None else acc + p
    return acc


def _halo_rows(x: torch.Tensor, send: torch.Tensor, r: int, offsets,
               m: int, k: int) -> torch.Tensor:
    """Shard r's gathered halo on a local mesh: the fp32 ``(|offsets|·m,
    D)`` stack of the row-blocks ``(r + q) mod k`` of ``send`` (``x``
    wire-cast, or ``x`` itself), in offset order.  Consecutive row-blocks
    of an uncast ``x`` are a view of it; anything else is a copy the
    caller frees after the shard's launch."""
    src = [(r + q) % k for q in offsets]
    if send is x and src == list(range(src[0], src[0] + len(src))):
        return x[src[0] * m:(src[-1] + 1) * m]
    return torch.cat([send[c * m:(c + 1) * m] for c in src]).to(
        torch.float32)


def _halo(mesh, x: torch.Tensor, send: torch.Tensor, r: int, j: int,
          offsets, m: int, k: int) -> torch.Tensor:
    """Shard r's fp32 halo stack (owned as this process's j-th shard): a
    slice of the local rows (:func:`_halo_rows`), or on a rank mesh the
    row-blocks of ``send`` received through ``Exchange.halo`` (only the
    own block, as a view of ``x``, when the round gathers nothing
    else)."""
    if not mesh.distributed:
        return _halo_rows(x, send, r, offsets, m, k)
    if send is x and tuple(offsets) == (0,):
        return x[j * m:(j + 1) * m]
    return mesh.exchange.halo(send[j * m:(j + 1) * m], offsets).to(
        torch.float32)


def _shard_mix_rounds(x: torch.Tensor, offsets, Mstack, dstack, k: int,
                      wire_dtype, with_residual: bool = False, *, mesh,
                      n: int):
    """The per-shard body of an uncompressed sharded round on the packed
    fp32 rows ``x`` of the shards this process owns: shard by shard, the
    row-blocks at ``offsets`` are gathered (wire-cast when ``wire_dtype``
    is set, the self block too; :func:`_halo`) and ``shard_mix.cu``
    writes ``d_r ⊙ x_r + M_r · xs`` into the shard's rows of one fresh
    output.  Returns ``(out, Σ of all k shards' column sums or None)``."""
    from repro_torch.kernels import mixing_cuda

    owned, m = _owned_rows(x, mesh, k, n, "communicate_sharded")
    send = x.to(wire_dtype) if wire_dtype is not None else x
    out = torch.empty_like(x)
    parts = []
    for j, r in enumerate(owned):
        xs = _halo(mesh, x, send, r, j, offsets, m, k)
        res = mixing_cuda.shard_mix_block(
            x[j * m:(j + 1) * m], xs, dstack[r], Mstack[r],
            with_residual=with_residual, out=out[j * m:(j + 1) * m])
        del xs
        if with_residual:
            parts.append(res[1])
    del send
    return out, (_shard_sum(mesh, parts) if with_residual else None)


# ---------------------------------------------------------------------------
# 2-D rounds: the packed columns in model chunks
# ---------------------------------------------------------------------------
def _owned_chunks(mesh, kc: int) -> Tuple[int, ...]:
    """Of a round's ``kc`` column chunks, the ones this process computes:
    all of them on a local mesh, this rank's on a 2-D rank mesh (a round
    of one chunk on a 2-D rank mesh, a sparsifier's, runs whole on every
    model rank)."""
    if mesh.distributed and kc > 1:
        return (mesh.model_rank,)
    return tuple(range(kc))


def _gather_chunks(mesh, kc: int, outs: Dict[int, list]) -> list:
    """Per output, its ``kc`` column chunks in chunk order: ``outs[c]``
    holds the outputs (tensors of the same rows) of each chunk c this
    process computed; on a 2-D rank mesh every model rank's chunk is
    gathered across the model axis (``model_exchange.all_gather`` of one
    packed message; exact: the chunks' columns are disjoint)."""
    if not (mesh.distributed and kc > 1):
        return [[outs[c][i] for c in range(kc)] for i in range(len(outs[0]))]
    from repro_torch.core.mesh import pack_arrays, unpack_arrays
    (mine,) = outs.values()
    got = [unpack_arrays(g, mine)
           for g in mesh.model_exchange.all_gather(pack_arrays(mine))]
    return [[g[i] for g in got] for i in range(len(mine))]


def _chunk_sum(mesh, kc: int, vals: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The left fold over the ``kc`` column chunks, in chunk order, of
    one scalar per chunk (gathered across the model axis on a 2-D rank
    mesh): one chunk's scalar as it is."""
    if mesh.distributed and kc > 1:
        (v,) = vals.values()
        seq = [g[0] for g in mesh.model_exchange.all_gather(v.reshape(1))]
    else:
        seq = [vals[c] for c in range(kc)]
    acc = None
    for v in seq:
        acc = v if acc is None else acc + v
    return acc


def _quant_chunks(compressor, km: int) -> int:
    """The column chunks of a compressed gossip round on a mesh of ``km``
    model shards: the quantizers' code arrays share the leaves' column
    layout and slice; the sparsifiers' payloads (values and leaf-global
    index sets) cannot, and ride whole (one chunk, the 1-D round)."""
    return km if compressor.name in ("int8", "fp8") else 1


def communicate_sharded(params: PyTree, spec: CommSpec, *, phase: str,
                        step: int = 0, grads: Optional[PyTree] = None,
                        gamma=None, with_residual: bool = False,
                        ef_state: Optional[PyTree] = None, seed: int = 0):
    """One communication round with the node axis sharded over
    ``spec.mesh``.

    ``spec``'s ``backend``/``shard_mode``/``leaf_threshold`` are ignored:
    calling this function *is* the sharded routing decision.

    Each of the k shards owns the ``m = n/k`` rows of its nodes in the
    packed ``(n, D)`` fp32 matrix; ``params`` holds the rows of the shards
    this process owns (all n on a local mesh, m on a rank mesh).  Shard by
    shard, in order: the neighbour row-blocks named by the round's block
    decomposition (:func:`_shard_blocks`) are gathered, wire-cast when
    ``comm_dtype`` is set (the self block too; the self term ``d ⊙ x``
    uses the uncast rows; consecutive fp32 row-blocks of a local mesh are
    gathered as a view of the input, the others copied per shard and
    freed), and ``shard_mix.cu`` writes ``d ⊙ x + M_r · xs`` into the
    shard's rows of one fresh output, so no shard reads another shard's
    mixed rows.  The ``"global"`` phase is the fixed-order sum of the
    shards' wire-cast column sums, divided by n and broadcast to every
    row.

    On a mesh with a model axis (``spec.model_axis``, k_model > 1) the
    round runs **2-D**: the packed columns are sliced into k_model chunks
    in the reference's ``flatten_nodes_sharded`` layout
    (:class:`repro_torch.kernels.mixing_cuda.ModelChunks`), each chunk
    packed into its own contiguous ``(rows, W)`` tensor, and the round
    above runs chunk by chunk on ``(m, W)`` blocks: halos move only the
    chunk's columns, sums run over the node shards only.  Every column's
    result is the 1-D round's bits; only the consensus residual, a sum
    over blocks, folds in another order (over the shards per chunk, then
    over the chunks).  On a 2-D rank mesh a rank computes its own chunk,
    then the chunks are gathered across the model axis into whole rows.

    With ``grads``/``gamma`` the SGD half-step is applied before the
    exchange.  With ``with_residual`` returns ``(mixed, x̄, Σ_i‖x_i −
    x̄‖²)`` over all n nodes: x̄ from the fixed-order sum of the kernel's
    per-shard column sums, the residual from a second pass per shard (the
    cancellation-free form) summed in shard order; a global round's
    residual is exactly 0.

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
    mesh = spec.mesh
    k = _shard_count(mesh, spec.node_axis, n_nodes, who)
    if phase not in ("gossip", "global", "pod_avg"):
        raise ValueError(f"{who}: no sharded kernel for phase {phase!r}")
    if phase == "pod_avg":
        _check_pods(n_nodes, n_pods, "mixing.communicate_sharded")
    km = model_shard_count(mesh, spec.model_axis, spec.node_axis)
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
                mesh=mesh, node_axis=spec.node_axis,
                model_axis=spec.model_axis,
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
            n_pods=n_pods, k=k, comm_dtype=comm_dtype, mesh=mesh, km=km)
    if grads is not None and gamma is None:
        raise ValueError("grads given without gamma")
    # grid gossip ignores comm_dtype in the reference path — mirror that
    wire_dtype = None if (phase == "gossip" and topology == "grid") \
        else comm_dtype
    n = n_nodes
    lay = mixing_cuda.ModelChunks(params, km)
    gam = None
    if grads is not None:
        gam = (gamma if torch.is_tensor(gamma) else torch.tensor(
            gamma, dtype=torch.float32)).to(torch.float32)
    if phase != "global":
        offsets, Mstack, dstack, _ = _device_shard_blocks(
            phase, topology, n, step, n_pods, k,
            tree_leaves(params)[0].device)
    outs, resids, rows = {}, {}, 0
    for c in _owned_chunks(mesh, km):
        x = lay.chunk(params, c)
        owned, m = _owned_rows(x, mesh, k, n, who)
        rows = x.shape[0]
        if grads is not None:
            x = x - gam * lay.chunk(grads, c)
        if phase == "global":
            parts = []
            for j in range(len(owned)):
                xr = x[j * m:(j + 1) * m]
                if wire_dtype is not None:
                    xr = xr.to(wire_dtype).to(torch.float32)
                parts.append(torch.sum(xr, dim=0, keepdim=True))
            outs[c] = [_divide(_shard_sum(mesh, parts), n)]
            continue
        out, acc = _shard_mix_rounds(x, offsets, Mstack, dstack, k,
                                     wire_dtype, with_residual, mesh=mesh,
                                     n=n)
        del x
        outs[c] = [out]
        if with_residual:
            xbar = _divide(acc, n)
            outs[c].append(xbar)
            resids[c] = _shard_sum(mesh, [
                torch.sum((out[j * m:(j + 1) * m] - xbar).square_())
                for j in range(len(owned))])
    got = _gather_chunks(mesh, km, outs)
    del outs
    if phase == "global":
        xbar = lay.unflatten(got[0], drop_node=True)
        mixed = tree_map(lambda p: p[None].expand(
            (rows,) + tuple(p.shape)).contiguous(), xbar)
        if with_residual:
            return mixed, xbar, torch.zeros((), dtype=torch.float32,
                                            device=got[0][0].device)
        return mixed
    mixed = lay.unflatten(got[0])
    if not with_residual:
        return mixed
    return (mixed, lay.unflatten(got[1], drop_node=True),
            _chunk_sum(mesh, km, resids))


def _shard_rows(arrs, rows: int, j: int, m: int):
    """The j-th local shard's slice of the wire arrays: rows ``j·m … j·m +
    m − 1`` of the node-stacked ones (leading axis ``rows``, this
    process's node rows); node-independent arrays (leading axis 1, e.g.
    randk's shared column indices) ride whole."""
    return [a[j * m:(j + 1) * m] if a.shape[0] == rows else a for a in arrs]


def _chunk_wires(arrs, rows: int, c: int, kc: int):
    """Column chunk c of a round's flat wire arrays: an array whose
    columns slice over the model axis
    (:func:`repro_torch.models.sharding.wire_column_spec`: node-stacked,
    its columns a multiple of ``kc``) gives its c-th column slice; the
    others (per-row scales, node-independent arrays) ride whole."""
    if kc == 1:
        return arrs
    from repro_torch.models.sharding import wire_column_spec
    out = []
    for a in arrs:
        spec = wire_column_spec(tuple(a.shape), rows, ("node",), ("model",),
                                kc)
        if len(spec) >= 2 and spec[-1] is not None:
            w = a.shape[-1] // kc
            out.append(a[..., c * w:(c + 1) * w])
        else:
            out.append(a)
    return out


def _halo_wires(mesh, arrs, rows: int, r: int, j: int, offsets, m: int,
                k: int, *, in_flight: bool = False):
    """For each offset q, the wire arrays of shard ``(r + q) mod k``'s
    row-block: slices of the local rows, or on a rank mesh the node-stacked
    arrays of the own block packed into one message per offset through
    ``Exchange.halo`` (the node-independent ones, the same on every
    rank, ride as they are here).  ``in_flight``: a :class:`_Pending` of
    that list, the rank mesh's message left in flight
    (``Exchange.halo_start``)."""
    if not mesh.distributed:
        out = [_shard_rows(arrs, rows, (r + q) % k, m) for q in offsets]
        return _Pending(lambda: out) if in_flight else out
    from repro_torch.core.mesh import pack_arrays, unpack_arrays

    own = _shard_rows(arrs, rows, j, m)
    stacked = [a for a, b in zip(own, arrs) if b.shape[0] == rows]

    def unpack(msgs):
        out = []
        for jq in range(len(offsets)):
            got = iter(unpack_arrays(msgs[jq], stacked))
            out.append([next(got) if b.shape[0] == rows else a
                        for a, b in zip(own, arrs)])
        return out

    msg = pack_arrays(stacked)[None]
    if in_flight:
        return _Pending(mesh.exchange.halo_start(msg, offsets).wait, unpack)
    return unpack(mesh.exchange.halo(msg, offsets))


def _sharded_wire_build(params: PyTree, *, compressor, ef_state, seed,
                        kc: int = 1):
    """Row-local compression of the node-stacked rows of ``params`` into
    per-leaf wire arrays (+ the EF update), as every shard compresses its
    own rows.  With ``kc`` column chunks each leaf's rows are zero-padded
    to a multiple of ``kc`` first (appended zero columns: the scales and
    the column hash's draws on real columns are the 1-D round's, and pad
    columns code to zero).  Returns ``(wires, new_ef_state, widths)``,
    ``widths`` each leaf's columns in one chunk (the decode side's)."""
    from repro_torch import compress as compress_mod
    from repro_torch.compress.collective import pad_cols

    leaves = tree_leaves(params)
    rows = leaves[0].shape[0]
    sizes = [int(np.prod(lf.shape[1:], dtype=np.int64)) for lf in leaves]
    x2 = [pad_cols(lf.reshape(rows, -1).to(torch.float32), kc)
          for lf in leaves]
    e2 = None
    if ef_state is not None:
        ef_leaves, ef_def = tree_flatten(ef_state)
        e2 = [pad_cols(e.reshape(rows, -1).to(torch.float32), kc)
              for e in ef_leaves]
    wires, new_e2 = compress_mod.compress_tree(compressor, x2, e2, seed)
    new_ef = None
    if ef_state is not None:
        new_ef = tree_unflatten(ef_def, [
            e[:, :s].reshape(lf.shape).to(lf.dtype)
            for e, s, lf in zip(new_e2, sizes, ef_leaves)])
    return wires, new_ef, [-(-s // kc) for s in sizes]


def _wire_arrays(wires):
    """The wire arrays of every leaf, flat: payload then aux, leaf by leaf."""
    return [a for w in wires for a in (*w.payload, *w.aux)]


def _wire_build_q(compressor, wires, sizes):
    """Factory of the row-block estimate rebuild: ``build_q(arrs, out)``
    decodes a flat list of wire arrays into the dense ``(rows, D)``
    estimate, leaf by leaf into ``out``'s column ranges (``sizes``: each
    leaf's columns, one chunk's on a 2-D round)."""
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
                                    k: int, comm_dtype=None, mesh,
                                    km: int = 1):
    """Compressed sharded round: each shard's rows are compressed
    (row-local, :func:`_sharded_wire_build`), then the gossip and pod
    phases run :func:`_sharded_compensated_gossip` on the wires.  The
    ``"global"`` phase applies ``x + (q̄ − q)``
    around the fixed-order sum of the shards' column sums of ``q``,
    wire-cast per ``comm_dtype`` (both occurrences).  On ``km`` model
    shards a quantizer's round runs 2-D (its code arrays column-sliced
    with the packed matrix, the per-row scales whole), a sparsifier's
    1-D (:func:`_quant_chunks`).  Returns ``(mixed, new_ef_state)``."""
    from repro_torch.kernels import mixing_cuda

    kc = _quant_chunks(compressor, km)
    wires, new_ef, widths = _sharded_wire_build(
        params, compressor=compressor, ef_state=ef_state, seed=seed, kc=kc)
    if phase != "global":
        return _sharded_compensated_gossip(
            params, wires, compressor=compressor, widths=widths,
            phase=phase, topology=topology, n_nodes=n_nodes, step=step,
            n_pods=n_pods, k=k, mesh=mesh, kc=kc), new_ef
    arrs = _wire_arrays(wires)
    build_q = _wire_build_q(compressor, wires, widths)
    lay = mixing_cuda.ModelChunks(params, kc)
    outs = {}
    for c in _owned_chunks(mesh, kc):
        x = lay.chunk(params, c)
        owned, m = _owned_rows(x, mesh, k, n_nodes, "communicate_sharded")
        arrs_c = _chunk_wires(arrs, x.shape[0], c, kc)
        q = torch.empty_like(x)
        parts = []
        for j in range(len(owned)):
            qr = build_q(_shard_rows(arrs_c, x.shape[0], j, m),
                         q[j * m:(j + 1) * m])
            if comm_dtype is not None:
                qr.copy_(qr.to(comm_dtype))
            parts.append(torch.sum(qr, dim=0, keepdim=True))
        outs[c] = [x + (_divide(_shard_sum(mesh, parts), n_nodes) - q)]
        del x, q
    return lay.unflatten(_gather_chunks(mesh, kc, outs)[0]), new_ef


def _sharded_compensated_gossip(params: PyTree, wires, *, compressor,
                                widths, phase: str, topology: str,
                                n_nodes: int, step: int, n_pods: int,
                                k: int, mesh, kc: int = 1,
                                halos=None) -> PyTree:
    """The apply half of a compressed sharded gossip (or pod) round: shard
    by shard, the wire arrays of the row-blocks the round's block
    decomposition names are gathered (:func:`_halo_wires`) and decoded
    into their estimates ``qs`` (``widths``: each leaf's columns in one of
    the ``kc`` column chunks), and ``shard_cmix.cu`` writes ``x_r + (M_r ·
    qs − (1 − d_r) ⊙ q_self)`` into the shard's rows of one fresh output,
    chunk by chunk.  ``wires`` may be the buffered, one-step-stale payload
    of an overlapped round (:func:`finish_round`): the compensation keeps
    the node average for any estimate, so the synchronous and the
    overlapped rounds share this apply.  ``halos`` (an issued round's,
    :func:`issue_round`): per ``(chunk, local shard)`` the
    :class:`_Pending` gather of the wire arrays, in place of gathering
    them here."""
    from repro_torch.kernels import mixing_cuda

    n = n_nodes
    arrs = _wire_arrays(wires)
    build_q = _wire_build_q(compressor, wires, widths)
    lay = mixing_cuda.ModelChunks(params, kc)
    offsets, Mstack, _, wstack = _device_shard_blocks(
        phase, topology, n, step, n_pods, k, tree_leaves(params)[0].device)
    outs = {}
    for c in _owned_chunks(mesh, kc):
        x = lay.chunk(params, c)
        owned, m = _owned_rows(x, mesh, k, n, "communicate_sharded")
        rows, D = x.shape
        arrs_c = _chunk_wires(arrs, rows, c, kc)
        out = torch.empty_like(x)
        for j, r in enumerate(owned):
            qs = torch.empty((len(offsets) * m, D), dtype=torch.float32,
                             device=x.device)
            got = (halos[c, j].get() if halos is not None else
                   _halo_wires(mesh, arrs_c, rows, r, j, offsets, m, k))
            for jq, blk in enumerate(got):
                build_q(blk, qs[jq * m:(jq + 1) * m])
            if 0 in offsets:
                j0 = offsets.index(0)
                q_self = qs[j0 * m:(j0 + 1) * m]
            else:
                q_self = build_q(_shard_rows(arrs_c, rows, j, m),
                                 torch.empty((m, D), dtype=torch.float32,
                                             device=x.device))
            mixing_cuda.shard_comp_mix_block(
                x[j * m:(j + 1) * m], q_self, qs, wstack[r], Mstack[r],
                out=out[j * m:(j + 1) * m])
            del qs, q_self
        outs[c] = [out]
        del x
    return lay.unflatten(_gather_chunks(mesh, kc, outs)[0])


def _pod_runs(owned, m: int, per: int):
    """``(lo, hi, pod)``: the runs of this process's local node rows (its
    owned shards' rows, in order) that lie in one pod of ``per`` nodes."""
    runs = []
    for j, r in enumerate(owned):
        g = r * m
        while g < (r + 1) * m:
            p = g // per
            end = min((r + 1) * m, (p + 1) * per)
            runs.append((j * m + g - r * m, j * m + end - r * m, p))
            g = end
    return runs


def _communicate_sharded_collective(params: PyTree, *, compressor, ef_state,
                                    seed, phase: str, n_nodes: int,
                                    n_pods: int, mesh,
                                    node_axis: str = "data",
                                    model_axis: str = "model",
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
    owners' stage-2 codes and exponent bytes is their concatenation.  On a
    local mesh both are slices of this process's rows; on a rank mesh
    they are ``Exchange.all_to_all`` and ``Exchange.all_gather`` of the
    packed codes and exponent bytes.  The packed columns are padded to
    ``k_model · k · qblock`` so every segment starts on a scale block.

    On k_model > 1 model shards (2-D) the padded columns split into
    k_model contiguous slices of ``width`` columns (the reference slices
    the plain packed matrix here, not the chunk layout), each slice into
    k node segments of ``seg = width / k``: owner (s, c) re-quantizes at
    ``col0 = c·width + s·seg``.  Every operation is per column or per
    block at absolute columns, so each real column gets the 1-D round's
    bits.  A 2-D rank computes its slice c only (stage 1 at ``col0 =
    c·width``, the exchanges among the node ranks of slice c), then the
    slices are gathered across the model axis into whole rows.  Returns
    ``(x + (r − ρ), e')`` on this process's rows."""
    from repro_torch.compress import collective as ccol
    from repro_torch.core.mesh import pack_arrays, unpack_arrays
    from repro_torch.kernels import mixing_cuda

    who = caller or "mixing._communicate_sharded_collective"
    k = _shard_count(mesh, node_axis, n_nodes, who)
    km = model_shard_count(mesh, model_axis, node_axis)
    n = n_nodes
    pods = n_pods if phase == "pod_avg" else 1
    _check_pods(n, pods, who)
    kind = compressor.name
    qb = ccol.QBLOCK if qblock is None else qblock

    xf, unflatten = mixing_cuda.flatten_nodes(params)
    owned, m = _owned_rows(xf, mesh, k, n, who)
    D = xf.shape[1]
    xp = ccol.pad_cols(xf, km * k * qb)
    del xf
    Dp = xp.shape[1]
    width = Dp // km
    seg = width // k
    nbs = seg // qb
    cs = _owned_chunks(mesh, km)
    lo, hi = cs[0] * width, (cs[-1] + 1) * width
    xs = xp[:, lo:hi]
    y = xs
    ef_unflatten = None
    if ef_state is not None:
        ef2, ef_unflatten = mixing_cuda.flatten_nodes(ef_state)
        y = xs + ccol.pad_cols(ef2, km * k * qb)[:, lo:hi]
        del ef2
    s1, s2 = ccol.stage_seeds(seed)
    codes1, scales1, q1 = ccol.quantize_blocks(y, kind, s1, qb, col0=lo)
    new_ef = None if ef_unflatten is None else y - q1
    del y
    rho = ccol.quantize_blocks(q1, kind, s2, qb, col0=lo)[2]
    del q1
    exps1 = ccol.scale_exponents(scales1)

    def segment(t):
        return [codes1[:, t * seg:(t + 1) * seg],
                exps1[:, t * nbs:(t + 1) * nbs]]

    def stage2(t, c1, e1):
        q_seg = ccol.dequant_blocks(c1, ccol.exponent_scales(e1), qb)
        mbar = ccol.anchored_mean(q_seg, pods)
        c2, sc2, _ = ccol.quantize_blocks(mbar, kind, s2, qb,
                                          col0=lo + t * seg)
        return c2, ccol.scale_exponents(sc2)

    r_all = torch.empty((pods, hi - lo), dtype=torch.float32,
                        device=xp.device)
    if mesh.distributed:
        ex = mesh.exchange
        like = [a.contiguous() for a in segment(0)]
        got = ex.all_to_all([pack_arrays(segment(s)) for s in range(k)])
        parts = [unpack_arrays(g, like) for g in got]
        owner = stage2(mesh.node_rank, torch.cat([p[0] for p in parts]),
                       torch.cat([p[1] for p in parts]))
        del got, parts
        done = [(s, *unpack_arrays(g, owner))
                for s, g in enumerate(ex.all_gather(pack_arrays(owner)))]
    else:
        done = ((t, *stage2(t, *segment(t)))
                for t in range((hi - lo) // seg))
    for t, c2, e2 in done:
        r_all[:, t * seg:(t + 1) * seg] = ccol.dequant_blocks(
            c2, ccol.exponent_scales(e2), qb)
        del c2
    del codes1
    mixed = torch.empty_like(xs)
    for a, b, p in _pod_runs(owned, m, n // pods):
        mixed[a:b] = xs[a:b] + (r_all[p:p + 1] - rho[a:b])
    del rho, xp, xs
    if mesh.distributed and km > 1:
        outs = [mixed] + ([new_ef] if new_ef is not None else [])
        got = _gather_chunks(mesh, km, {cs[0]: outs})
        mixed = torch.cat(got[0], dim=1)
        if new_ef is not None:
            new_ef = torch.cat(got[1], dim=1)
    return unflatten(mixed[:, :D]), (None if ef_unflatten is None
                                     else ef_unflatten(new_ef[:, :D]))


# ---------------------------------------------------------------------------
# Overlap: the double-buffered gossip round
# ---------------------------------------------------------------------------
def start_round(params: PyTree, spec: CommSpec, *,
                ef_state: Optional[PyTree] = None, seed: int = 0):
    """Open one overlapped gossip round: capture the payload of ``params``
    that :func:`finish_round` applies one step later.  Returns
    ``(round_state, new_ef_state)``, ``round_state`` a dict:

    * dense modes (no lossy gossip codec): ``{"q": buffer}``, the params
      cast to ``spec.comm_dtype`` when one is set (the wire cast, made
      once at capture, so both occurrences of the buffer in the apply see
      the same value).  The buffer is a copy that owns its storage: the
      fused rounds consume staging buffers in place and the optimizer's
      outputs become the next state, so a buffer sharing storage with
      the params could change under the step;
    * lossy sharded mode: ``{"wire": [...]}``, each leaf's wire arrays
      (``{"payload": ..., "aux": ...}``), the EF memory advanced against
      them;
    * lossy stacked modes: ``{"q": estimate}``, the dense decoded
      estimate, the EF memory advanced here too.

    The round counts as issued at capture: :func:`finish_round` takes the
    issuing step's shift."""
    tel = _hub()
    if tel is None:
        return _start_round_impl(params, spec, ef_state=ef_state, seed=seed)
    with tel.span("comm/issue") as sp:
        out = sp.fence(_start_round_impl(params, spec, ef_state=ef_state,
                                         seed=seed))
    _meter(tel, params, spec, phase="gossip", step=0, role="issue",
           wires=out[0].get("wire"))
    return out


def _start_round_impl(params: PyTree, spec: CommSpec, *,
                      ef_state: Optional[PyTree] = None, seed: int = 0):
    n = spec.n_nodes
    if n == 1 or not spec.lossy:
        cast = spec.comm_dtype if n > 1 else None
        return {"q": tree_map(
            lambda p: p.to(dtype=p.dtype if cast is None else cast,
                           copy=True), params)}, ef_state
    if spec.uses_sharded():
        _shard_count(spec.mesh, spec.node_axis, n, "mixing.start_round")
        km = model_shard_count(spec.mesh, spec.model_axis, spec.node_axis)
        wires, new_ef, _ = _sharded_wire_build(
            params, compressor=spec.compressor, ef_state=ef_state, seed=seed,
            kc=_quant_chunks(spec.compressor, km))
        return {"wire": [{"payload": tuple(w.payload), "aux": tuple(w.aux)}
                         for w in wires]}, new_ef
    from repro_torch import compress as compress_mod
    q, new_ef = compress_mod.apply_tree(spec.compressor, params, ef_state,
                                        seed)
    return {"q": q}, new_ef


def finish_round(params: PyTree, round_state, spec: CommSpec, *,
                 step: int = 0) -> PyTree:
    """Close the overlapped round opened by :func:`start_round`: mix the
    buffered payload ``b`` into the current iterate as the compensated
    correction ``x ← params + (M·b − (1 − diag W)⊙b)`` (≡ ``params + (W −
    I)·b``), which keeps the node average for any buffer, the one-step-
    stale one included: ``x_{t+1} = y_t + (W − I)·y_{t−1}``.  ``step`` is
    the shift step of the *issuing* step (the one that called
    :func:`start_round`).  Only gossip rounds overlap; averaging rounds go
    through :func:`overlap_flush`.

    Backends: stacked ``"pallas"`` launches ``shard_cmix.cu`` once per
    dispatch group with ``q_self = qs = b``
    (:func:`repro_torch.kernels.mixing_cuda.compensated_apply`); stacked
    ``"reference"`` the dense matmul oracle; sharded, the per-shard
    compensated kernel over the gathered halo of the buffer (dense) or
    of its wire arrays (lossy).  A round state from :func:`issue_round`
    carries that halo in flight: the apply waits for it (``step`` must be
    the shift it was issued for) and launches on the same operands."""
    tel = _hub()
    if tel is None:
        return _finish_round_impl(params, round_state, spec, step=step)
    _meter(tel, params, spec, phase="gossip", step=step, role="apply",
           wires=round_state.get("wire"))
    with tel.span("comm/apply", shift=int(step)) as sp:
        return sp.fence(_finish_round_impl(params, round_state, spec,
                                           step=step))


def _finish_round_impl(params: PyTree, round_state, spec: CommSpec, *,
                       step: int = 0) -> PyTree:
    n = spec.n_nodes
    if n == 1:
        return params
    halo = round_state.get("halo")
    if halo is not None and halo["step"] != step:
        raise ValueError(f"mixing.finish_round: the round's halo was issued "
                         f"for shift {halo['step']}, applied with {step}")
    if "wire" in round_state:
        return _overlap_finish_sharded_wire(params, round_state, spec,
                                            step=step)
    q = round_state["q"]
    if spec.uses_sharded():
        return _overlap_finish_sharded_dense(params, q, spec, step=step,
                                             halo=halo)
    if spec.backend == "pallas":
        from repro_torch.kernels import mixing_cuda
        return mixing_cuda.compensated_apply(
            params, q, topology=spec.topology, n_nodes=n, step=step,
            n_pods=spec.n_pods, leaf_threshold=spec.leaf_threshold)
    return _compressed_round_reference(params, q, "gossip", spec.topology,
                                       n, step, spec.n_pods)


def overlap_flush(params: PyTree, spec: CommSpec, *, phase: str,
                  step: int = 0, axis: int = 0,
                  ef_state: Optional[PyTree] = None, seed: int = 0):
    """Synchronous round and buffer re-prime at a period boundary: the
    global and pod averages must see the current iterate to restore the
    exact average, so they do not overlap.  Runs :func:`communicate` for
    ``phase``, then :func:`start_round` from its result.  Returns
    ``(mixed, round_state, new_ef_state)``.  With a lossy gossip codec the
    EF memory advances twice, once in the round and once in the re-prime:
    the two payloads the step produces."""
    tel = _hub()
    if tel is not None:
        _meter(tel, params, spec, phase=phase, step=step, role="flush")
    span = (tel.span("comm/flush", phase=phase) if tel is not None
            else contextlib.nullcontext())
    with span:
        out = _communicate_impl(params, spec, phase=phase, step=step,
                                axis=axis, ef_state=ef_state, seed=seed)
        if spec.compressor is not None \
                or spec.global_compressor is not None:
            mixed, ef2 = out
        else:
            mixed, ef2 = out, ef_state
        buf, ef3 = start_round(mixed, spec, ef_state=ef2, seed=seed)
    # repro: allow(RPR003) start_round copies: buf shares nothing with mixed
    return mixed, buf, ef3


def _overlap_finish_sharded_dense(params: PyTree, q: PyTree,
                                  spec: CommSpec, *, step: int,
                                  halo=None) -> PyTree:
    """Sharded apply of a dense buffer: shard by shard (chunk by chunk on
    a 2-D mesh), the buffered row-blocks at the round's halo offsets are
    gathered (wire-cast as they are sent, then upcast: exact, the buffer
    was cast at capture) and ``shard_cmix.cu`` writes ``x_r + (M_r · qs −
    (1 − d_r) ⊙ b_r)`` into the shard's rows of one fresh output.
    ``halo`` (:func:`issue_round`'s): each chunk's packed buffer and its
    shards' :class:`_Pending` gathered stacks."""
    from repro_torch.kernels import mixing_cuda

    n, mesh = spec.n_nodes, spec.mesh
    k = _shard_count(mesh, spec.node_axis, n, "mixing.finish_round")
    km = model_shard_count(mesh, spec.model_axis, spec.node_axis)
    lay = mixing_cuda.ModelChunks(params, km)
    offsets, Mstack, _, wstack = _device_shard_blocks(
        "gossip", spec.topology, n, step, spec.n_pods, k,
        tree_leaves(params)[0].device)
    wire = spec.comm_dtype
    outs = {}
    for c in _owned_chunks(mesh, km):
        x = lay.chunk(params, c)
        owned, m = _owned_rows(x, mesh, k, n, "mixing.finish_round")
        if halo is not None:
            qf, pending = halo["chunks"][c]
        else:
            qf = lay.chunk(q, c)
            send = qf.to(wire) if wire is not None else qf
        out = torch.empty_like(x)
        for j, r in enumerate(owned):
            qs = (pending[j].get() if halo is not None
                  else _halo(mesh, qf, send, r, j, offsets, m, k))
            mixing_cuda.shard_comp_mix_block(
                x[j * m:(j + 1) * m], qf[j * m:(j + 1) * m], qs, wstack[r],
                Mstack[r], out=out[j * m:(j + 1) * m])
            del qs
        if halo is None:
            del send
        del qf, x
        outs[c] = [out]
    return lay.unflatten(_gather_chunks(mesh, km, outs)[0])


def _overlap_finish_sharded_wire(params: PyTree, round_state,
                                 spec: CommSpec, *, step: int) -> PyTree:
    """Sharded apply of a lossy buffer: rebuild the leaves' wires from
    ``round_state`` and run the apply half of the synchronous compressed
    round on them (:func:`_sharded_compensated_gossip`), in the column
    chunks :func:`start_round` compressed them for."""
    from repro_torch.compress import LeafWire

    n = spec.n_nodes
    k = _shard_count(spec.mesh, spec.node_axis, n, "mixing.finish_round")
    kc = _quant_chunks(spec.compressor, model_shard_count(
        spec.mesh, spec.model_axis, spec.node_axis))
    widths = [-(-int(np.prod(lf.shape[1:], dtype=np.int64)) // kc)
              for lf in tree_leaves(params)]
    wires = [LeafWire(payload=tuple(w["payload"]), aux=tuple(w["aux"]))
             for w in round_state["wire"]]
    halo = round_state.get("halo")
    return _sharded_compensated_gossip(
        params, wires, compressor=spec.compressor, widths=widths,
        phase="gossip", topology=spec.topology, n_nodes=n, step=step,
        n_pods=spec.n_pods, k=k, mesh=spec.mesh, kc=kc,
        halos=None if halo is None else halo["chunks"])


def issue_round(round_state, spec: CommSpec, *, step: int):
    """Start the exchange of an overlapped round's buffered halos, so it
    runs under the step that will apply it (the reference's ``ppermute``
    of the buffered row-blocks inside the next step's graph, ahead of its
    forward and backward).  Returns ``round_state`` with ``"halo"``: for
    each column chunk and node shard this process owns, the gather
    :func:`finish_round` would make of the buffer at the halo offsets of
    shift ``step`` — the row-blocks of a dense buffer, wire-cast as the
    serial apply casts them, or each leaf's packed wire arrays of a lossy
    one — in flight:

    * on a rank mesh, through ``Exchange.halo_start`` (its own process
      group, so the step's folds and gathers run meanwhile);
    * on a one-process mesh on the card, on a side CUDA stream (it waits
      for the caller's stream first; an event closes it, and every tensor
      it reads or makes is recorded on the stream that frees it last);
    * on CPU tensors, at once.

    :func:`finish_round` with the same ``step`` waits for it and applies;
    call :func:`drain_round` on the result if the step fails in between.
    A stacked spec's round (nothing to gather) is returned as it is.
    Nothing falls back: a failed exchange raises where it is waited for.
    """
    n = spec.n_nodes
    if n == 1 or not spec.uses_sharded():
        return round_state
    if "halo" in round_state:
        raise ValueError("mixing.issue_round: the round is already issued")
    from repro_torch.kernels import mixing_cuda

    mesh = spec.mesh
    k = _shard_count(mesh, spec.node_axis, n, "mixing.issue_round")
    km = model_shard_count(mesh, spec.model_axis, spec.node_axis)
    m = n // k
    chunks = {}
    if "wire" in round_state:
        from repro_torch.compress import LeafWire
        kc = _quant_chunks(spec.compressor, km)
        arrs = _wire_arrays([LeafWire(payload=tuple(w["payload"]),
                                      aux=tuple(w["aux"]))
                             for w in round_state["wire"]])
        offsets = _device_shard_blocks("gossip", spec.topology, n, step,
                                       spec.n_pods, k, arrs[0].device)[0]
        rows = len(mesh.owned_shards(k)) * m
        for c in _owned_chunks(mesh, kc):
            arrs_c = _chunk_wires(arrs, rows, c, kc)
            for j, r in enumerate(mesh.owned_shards(k)):
                chunks[c, j] = _halo_wires(mesh, arrs_c, rows, r, j,
                                           offsets, m, k, in_flight=True)
        return {**round_state, "halo": {"step": step, "chunks": chunks,
                                        "pending": list(chunks.values())}}
    q = round_state["q"]
    lay = mixing_cuda.ModelChunks(q, km)
    offsets = _device_shard_blocks("gossip", spec.topology, n, step,
                                   spec.n_pods, k,
                                   tree_leaves(q)[0].device)[0]
    pending = []
    for c in _owned_chunks(mesh, km):
        qf = lay.chunk(q, c)
        owned, _ = _owned_rows(qf, mesh, k, n, "mixing.issue_round")
        chunks[c] = (qf, _issue_halos(mesh, qf, spec.comm_dtype, owned,
                                      offsets, m, k))
        pending += chunks[c][1]
    return {**round_state, "halo": {"step": step, "chunks": chunks,
                                    "pending": pending}}


def drain_round(round_state) -> None:
    """Wait for every halo :func:`issue_round` left in flight in
    ``round_state`` (a no-op for one already applied or never issued), so
    no exchange stays pending when a step fails between the issue and the
    apply.  Every halo is waited for; the first failure is raised."""
    halo = round_state.get("halo") if round_state is not None else None
    if halo is None:
        return
    first = None
    for pending in halo["pending"]:
        try:
            pending.wait()
        except Exception as e:   # waited for all, the first re-raised
            first = first or e
    if first is not None:
        raise first


class _Pending:
    """One gather of an issued round: :meth:`wait` waits for it and
    returns what it landed (a rank mesh's ``HaloInFlight.wait``, the side
    stream's event, or the value itself); :meth:`get` also maps that
    through ``then`` into what the apply takes."""

    def __init__(self, wait, then=None):
        self.wait, self.then = wait, then

    def get(self):
        got = self.wait()
        return got if self.then is None else self.then(got)


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device):
    """The side stream of the one-process halo gathers on ``device``, one
    for every round: the blocks the allocator caches for a stream are
    reused only by that stream."""
    return torch.cuda.Stream(device)


def _issue_halos(mesh, qf: torch.Tensor, wire, owned, offsets, m: int,
                 k: int) -> list:
    """Per local shard j, the :class:`_Pending` fp32 halo stack that
    :func:`_halo` gathers from the packed buffer chunk ``qf`` (sent as
    ``wire`` when set), the gather started now (:func:`issue_round`)."""
    if mesh.distributed:
        (j,) = range(len(owned))
        if wire is None and tuple(offsets) == (0,):
            own = qf[j * m:(j + 1) * m]
            return [_Pending(lambda: own)]
        send = qf.to(wire) if wire is not None else qf
        handle = mesh.exchange.halo_start(send[j * m:(j + 1) * m], offsets)
        return [_Pending(handle.wait, lambda t: t.to(torch.float32))]
    if qf.device.type != "cuda":
        send = qf.to(wire) if wire is not None else qf
        got = [_halo_rows(qf, send, r, offsets, m, k) for r in owned]
        return [_Pending(functools.partial(got.__getitem__, j))
                for j in range(len(owned))]
    main = torch.cuda.current_stream(qf.device)
    side = _side_stream(qf.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        send = qf.to(wire) if wire is not None else qf
        got = [_halo_rows(qf, send, r, offsets, m, k) for r in owned]
        done = torch.cuda.Event()
        done.record(side)
    # qf is read on the side stream; the stacks made there are freed
    # after the caller's stream has read them
    qf.record_stream(side)
    for t in got:
        t.record_stream(main)
    del send

    def landed(j: int) -> torch.Tensor:
        torch.cuda.current_stream(qf.device).wait_event(done)
        return got[j]
    return [_Pending(functools.partial(landed, j))
            for j in range(len(owned))]


# ---------------------------------------------------------------------------
# Push-sum: a runtime dense column-stochastic W
# ---------------------------------------------------------------------------
def push_sum_shard_offsets(n: int, k: int, shifts) -> Tuple[int, ...]:
    """Static shard-offset superset of the sharded push-sum rounds.

    A shift ``s`` over ``m = n/k`` rows per shard reaches the shard
    offsets ``(s // m) % k`` and, when it straddles a shard boundary
    (``s % m != 0``), ``(s // m + 1) % k``.  Offset 0 is always included:
    fault renormalization puts dropped nodes on diagonal entries."""
    m = n // k
    offs = {0}
    for s in shifts:
        s = s % n
        offs.add((s // m) % k)
        if s % m:
            offs.add((s // m + 1) % k)
    return tuple(sorted(offs))


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) as a float32 tensor on
    ``device``, rounded to float32 as the reference rounds it; to a card
    it is copied from pinned memory without blocking the host (PyTorch's
    pinned-memory cache keeps the block until the copy has run).  A
    tensor already on ``device`` is taken as it is."""
    t = a if torch.is_tensor(a) else torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32))
    t = t.to(torch.float32)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _host_matrix(W) -> Optional[np.ndarray]:
    """W as a host array when it is one (no device read), else None."""
    if not torch.is_tensor(W):
        # repro: allow(RPR001) W is a host array here, never a device read
        return np.asarray(W, dtype=np.float32)
    # repro: allow(RPR001) .numpy() of a CPU tensor only: no device read
    return W.numpy() if W.device.type == "cpu" else None


def _check_halo(W: np.ndarray, n: int, k: int, offsets) -> None:
    """Raise when W mixes a row-block from a shard offset that the sharded
    round does not gather (a shift outside the static superset)."""
    m = n // k
    M = W - np.diag(np.diag(W))
    for r in range(k):
        gathered = {(r + q) % k for q in offsets}
        for c in range(k):
            if c not in gathered and np.any(
                    M[r * m:(r + 1) * m, c * m:(c + 1) * m]):
                raise ValueError(
                    f"mixing._push_sum_sharded: W mixes shard {c}'s rows "
                    f"into shard {r}, offset {(c - r) % k}, outside the "
                    f"halo offsets {tuple(offsets)} (a shift outside the "
                    f"static superset: widen fault_hops/offsets)")


def _dense_shard_stacks(W: torch.Tensor, n: int, k: int, offsets):
    """Each shard's ``(m, |offsets|·m)`` mixing factor and ``(m, 1)`` self
    weights gathered from a runtime dense W on its device (block slices,
    no host round trip): ``(Mstack (k, m, |off|·m), dstack (k, m, 1))``."""
    from repro_torch.kernels.mixing_cuda import dense_factors

    m = n // k
    d, M = dense_factors(W, n)
    Mstack = torch.stack([
        torch.cat([M[r * m:(r + 1) * m,
                     ((r + q) % k) * m:(((r + q) % k) + 1) * m]
                   for q in offsets], dim=1)
        for r in range(k)])
    return Mstack, d.reshape(k, m, 1)


def _mix_dense_reference(params: PyTree, W: torch.Tensor, n: int,
                         comm_dtype=None) -> PyTree:
    """Reference dense round ``x ← d ⊙ x + M · wire(x)`` for a runtime W,
    leaf by leaf (the oracle of the fused and sharded paths); only the
    neighbour term is wire-cast."""
    from repro_torch.kernels.mixing_cuda import dense_factors

    d, M = dense_factors(W, n)

    def one(x):
        x2 = x.reshape(n, -1).to(torch.float32)
        xw = (x2.to(comm_dtype).to(torch.float32) if comm_dtype is not None
              else x2)
        return (d * x2 + torch.matmul(M, xw)).reshape(x.shape).to(x.dtype)

    return tree_map(one, params)


def _compressed_round_dense(params: PyTree, q: PyTree, W: torch.Tensor,
                            n: int) -> PyTree:
    """Compensated compressed round ``x + (M·q − (1−d)⊙q)`` for a runtime
    dense W (the oracle of ``compressed_step_mix_dense``)."""
    from repro_torch.kernels.mixing_cuda import dense_factors

    d, M = dense_factors(W, n)
    w = 1.0 - d
    leaves, treedef = tree_flatten(params)
    out = []
    for x, qq in zip(leaves, tree_flatten(q)[0]):
        x2 = x.reshape(n, -1).to(torch.float32)
        q2 = qq.reshape(n, -1).to(torch.float32)
        out.append((x2 + (torch.matmul(M, q2) - w * q2)).reshape(
            x.shape).to(x.dtype))
    return tree_unflatten(treedef, out)


def _push_sum_sharded(joint: PyTree, *, W: torch.Tensor,
                      W_host: Optional[np.ndarray], n_nodes: int, offsets,
                      comm_dtype, mesh, node_axis: str,
                      model_axis: str = "model") -> PyTree:
    """Sharded push-sum round: the joint ``(x, w)`` tree packed into one
    ``(n, D + 1)`` matrix (the weight column rides it, wire-cast with it;
    on a 2-D mesh chunk by chunk, the weight in chunk 0 and zero pad
    columns in the others), each shard's factor gathered from the runtime
    W over the static halo ``offsets`` (default: every shard offset), and
    the per-shard body of the sharded gossip round
    (:func:`_shard_mix_rounds`, ``shard_mix.cu``).  A W that mixes rows
    from outside the halo raises ``ValueError``; it is checked on the host
    copy, read back from the device only when the caller passed a device W
    with a restricted halo."""
    from repro_torch.kernels import mixing_cuda

    who = "mixing._push_sum_sharded"
    n = n_nodes
    k = _shard_count(mesh, node_axis, n, who)
    offsets = tuple(range(k)) if offsets is None else tuple(offsets)
    if set(range(k)) - {q % k for q in offsets}:
        # repro: allow(RPR001) a device W without W_host: off the step path
        _check_halo(W_host if W_host is not None else W.cpu().numpy(), n, k,
                    offsets)
    km = model_shard_count(mesh, model_axis, node_axis)
    lay = mixing_cuda.ModelChunks(joint, km)
    Mstack, dstack = _dense_shard_stacks(W, n, k, offsets)
    outs = {}
    for c in _owned_chunks(mesh, km):
        x = lay.chunk(joint, c)
        outs[c] = [_shard_mix_rounds(x, offsets, Mstack, dstack, k,
                                     comm_dtype, mesh=mesh, n=n)[0]]
        del x
    return lay.unflatten(_gather_chunks(mesh, km, outs)[0])


def _meter_push_sum(tel, params: PyTree, n: int, *, backend: str,
                    sharded: bool, comm_dtype, compressor) -> None:
    """The push round's ``comm_round`` record: its W is runtime data, so
    the static shift accounting does not apply; one send's worth of
    payload bytes from the live tree, ``sends=-1`` (data-dependent) and
    no analytic figure, as the reference reports it."""
    try:
        from repro_torch.obs import meters as obs_meters
        sizes = obs_meters.per_node_leaf_sizes(params, n)
        elem = (torch.empty((), dtype=comm_dtype).element_size()
                if comm_dtype is not None else 4)
        tel.emit(
            "comm_round", phase="push_sum", role="round",
            topology="runtime", backend=backend, sharded=sharded,
            n_nodes=int(n), sends=-1,
            compression=(compressor.name if compressor is not None
                         else "none"),
            measured_bytes=int(sum(sizes)) * int(elem),
            analytic_bytes=None, traced=False)
    except Exception as e:                           # pragma: no cover
        warnings.warn(f"mixing: push-sum comm meter failed ({e}); "
                      f"round unaffected")


def communicate_push_sum(params: PyTree, weight: torch.Tensor, *, W,
                         n_nodes: int, comm_dtype=None,
                         backend: str = "reference", mesh=None,
                         node_axis: str = "data", shard_mode: str = "auto",
                         model_axis: str = "model",
                         leaf_threshold: Optional[int] = None, offsets=None,
                         compressor=None, ef_state: Optional[PyTree] = None,
                         seed: int = 0):
    """One push-sum round ``(x, w) ← (W·x, W·w)`` for a **runtime**
    column-stochastic ``W``.

    ``weight`` is the per-node push-sum scalar ``(n, 1)``; readers
    de-bias with ``x/w`` (:func:`repro_torch.train.state.debias`).  ``W``
    is an ``(n, n)`` host array (numpy or CPU tensor: copied to the
    device without blocking the host) or a tensor on the params' device.
    The weight column rides the same round as the parameters (packed into
    the staging buffer or the sharded row-blocks with them), so x and w
    see the same mixing arithmetic, the bf16 wire cast included.

    Backends: ``"reference"`` (dense matmul oracle), ``"pallas"`` stacked
    (:func:`repro_torch.kernels.mixing_cuda.fused_step_mix_dense`) and,
    when ``mesh``'s node axis is sharded, the per-shard rounds
    (:func:`_push_sum_sharded`) over the halo ``offsets``
    (:func:`push_sum_shard_offsets`; default every shard offset).

    With a lossy ``compressor`` the parameters run the compensated
    compressed round while the weight is mixed exactly (``W @ w``
    outside the codec); returns ``(mixed, new_weight, new_ef_state)``.
    Without a compressor returns ``(mixed, new_weight)``; the identity
    codec takes the exact path and passes ``ef_state`` through.  Sharded
    + compressed raises ``ValueError``, as in the reference.
    """
    _check_backend(backend, 0, caller="mixing.communicate_push_sum")
    n = n_nodes
    # a rank mesh's process holds the m = n/k rows of its node shard
    rows = (n // mesh.node_count if mesh is not None and mesh.distributed
            else n)
    if weight.shape[0] != rows:
        raise ValueError(f"communicate_push_sum: weight has {weight.shape[0]}"
                         f" rows for n_nodes={n} ({rows} here)")
    w2 = weight.reshape(rows, -1).to(torch.float32)
    sharded = use_sharded_backend(backend, mesh, node_axis, shard_mode,
                                  model_axis)
    tel = _hub()
    if tel is not None:
        _meter_push_sum(tel, params, n, backend=backend, sharded=sharded,
                        comm_dtype=comm_dtype, compressor=compressor)
    if compressor is not None and compressor.lossy and sharded:
        raise ValueError(
            "mixing.communicate_push_sum: compressed push-sum has no "
            "sharded path (the fault-varying W would need runtime wire "
            "layouts); use comm_shard_mode='stacked'")
    W_host = _host_matrix(W)
    Wd = upload(W, weight.device)

    if compressor is not None and compressor.lossy:
        if backend == "pallas":
            from repro_torch.kernels import mixing_cuda
            mixed, new_ef = mixing_cuda.compressed_step_mix_dense(
                params, W=Wd, compressor=compressor, ef_state=ef_state,
                seed=seed, n_nodes=n)
        else:
            from repro_torch import compress as compress_mod
            q, new_ef = compress_mod.apply_tree(compressor, params,
                                                ef_state, seed)
            mixed = _compressed_round_dense(params, q, Wd, n)
        # the weight is the de-bias denominator: mix it exactly, outside
        # the lossy codec (a column-stochastic W keeps Σw = n)
        new_w = torch.matmul(Wd, w2).to(weight.dtype).reshape(weight.shape)
        return mixed, new_w, new_ef

    joint = {"x": params, "w": weight}
    if sharded:
        out = _push_sum_sharded(joint, W=Wd, W_host=W_host, n_nodes=n,
                                offsets=offsets, comm_dtype=comm_dtype,
                                mesh=mesh, node_axis=node_axis,
                                model_axis=model_axis)
    elif backend == "pallas":
        from repro_torch.kernels import mixing_cuda
        out = mixing_cuda.fused_step_mix_dense(
            joint, Wd, n_nodes=n, comm_dtype=comm_dtype,
            leaf_threshold=leaf_threshold)
    else:
        out = _mix_dense_reference(joint, Wd, n, comm_dtype=comm_dtype)
    if compressor is not None:
        return out["x"], out["w"], ef_state
    return out["x"], out["w"]
