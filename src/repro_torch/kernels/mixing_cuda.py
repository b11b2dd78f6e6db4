"""Fused communication rounds on the packed node-major ``(n, D)`` matrix —
the port of ``repro/kernels/mixing_pallas.py`` (stacked entry points).

Three hand-written CUDA kernels (``repro_torch/csrc/``), each replacing a
TPU kernel of ``mixing_pallas.py`` and each behind a wrapper that launches
it for a CUDA tensor (or raises) and takes its plain PyTorch twin — also
the kernel's oracle on the card — for a CPU tensor:

* ``mix.cu`` (``_mix_kernel``): optional SGD half-step, the mix
  ``o = d ⊙ x + M · wire(x)``, optional consensus residual;
  :func:`mix_flat` / :func:`mix_flat_plain`;
* ``cmix.cu`` (``_cmix_kernel``): the compensated compressed round
  ``o = x + (M·q − w⊙q)`` with int8/fp8 stochastic codes of ``x + e``
  made in the kernel, or ``q`` given (topk/randk);
  :func:`cmix_flat` / :func:`cmix_flat_plain`; and the rows' maxima of
  ``|x + e|`` from which its scales are made, :func:`cmix_absmax` /
  :func:`cmix_absmax_plain`;
* ``collective.cu`` (``_collective_kernel``): the two-stage compressed
  global/pod average per 1024-column block;
  :func:`collective_flat` / :func:`collective_flat_plain`;
* ``shard_mix.cu`` (``_shard_mix_kernel``): one node shard's
  ``d ⊙ x + M_r · xs`` over its gathered halo rows, optional column sums;
  :func:`shard_mix_block` / :func:`shard_mix_block_plain`;
* ``shard_cmix.cu`` (``_shard_cmix_kernel``): one node shard's compensated
  ``x + (M_r · qs − w ⊙ q_self)``;
  :func:`shard_comp_mix_block` / :func:`shard_comp_mix_block_plain`; also
  the stacked apply of an overlapped gossip round, the whole node stack
  as one shard with ``q_self = qs`` the buffer, once per dispatch group
  (:func:`compensated_apply`).

Each wrapper counts its launches in ``<wrapper>.launches``.  The mix and
cmix rounds have two instances each, picked by one rule
(:func:`use_vector_mix`, :func:`use_vector_cmix`): the register instance
(16-byte accesses, the columns in registers; counted in
``mix_flat.vector_launches`` / ``cmix_flat.vector_launches``) for n in
:data:`VECTOR_NODES`, D a multiple of its vector width and 16-byte aligned
rows, and the generic one (``.launches``) for the rest; the two compute
the same bits.  :func:`cmix_absmax` counts in
``cmix_flat.absmax_launches``.  The kernels are built on first use by
:mod:`repro_torch.kernels.cuda_build`; importing this module builds
nothing.

The round factors come from the round kind (``phase_matrices``, made once
per kind on the device) or, for push-sum, from a runtime ``(n, n)`` W
tensor built on the device every call (:func:`dense_factors`,
:func:`fused_step_mix_dense`, :func:`compressed_step_mix_dense`).

Uncompressed rounds concatenate leaves below ``leaf_threshold`` per-node
elements into one private staging buffer, which the kernel consumes in
place (the TPU's ``input_output_aliases``); larger leaves are mixed
straight from ``leaf.reshape(n, -1)`` into a fresh output, never touching
the caller's tensor.  Wire semantics match the reference: gossip casts only
the neighbour (M) term to bf16, averaging rounds cast everything (d = 0),
and the grid topology ignores ``comm_dtype``.  Compressed gossip rounds
dispatch per leaf (scales and seeds are per leaf); the compressed
collective runs once on the packed matrix.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.kernels import cuda_build
from repro_torch.tree import (pairwise_mean, tree_flatten, tree_leaves,
                              tree_unflatten)

PyTree = Any

KERNEL_PHASES = ("gossip", "global", "pod_avg")
LEAF_DISPATCH_THRESHOLD = 262_144

# dynamic shared memory a block of mix.cu may opt into: the H100's 227 KB
# less the kernel's 4 KB static reduction buffer
_MAX_SMEM = cuda_build.MAX_SMEM - 4_096
# node counts of the register instances of mix.cu and cmix.cu
VECTOR_NODES = (4, 8, 16, 32)
# the register instance of mix.cu: at most this many blocks, one residual
# partial each (the H100 holds at most 8 blocks of 256 threads on each of
# its 132 multiprocessors)
VECTOR_MAX_GRID = 2048
# cmix.cu's row maxima: at most this many blocks per row (kAbsmaxMaxChunks)
ABSMAX_MAX_CHUNKS = 256


# ---------------------------------------------------------------------------
# Phase -> (self-weight diagonal d, off/cast factor M)
# ---------------------------------------------------------------------------
def phase_matrices(phase: str, topology: str, n: int, step: int = 0,
                   n_pods: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Decompose one round into ``x ← d ⊙ x + M · cast(x)``: ``d`` (n, 1),
    ``M`` (n, n), fp32.  Gossip: ``d = diag(W)``, ``M = W − diag(W)``;
    global: ``d = 0``, ``M = 𝟙𝟙ᵀ/n``; pod_avg: ``d = 0``,
    ``M = blockdiag(𝟙𝟙ᵀ/per)``."""
    if phase == "gossip":
        W = topo.mixing_matrix(topology, n, step=step)
        d = np.diag(W).copy()
        M = W - np.diag(d)
        return d.reshape(n, 1).astype(np.float32), M.astype(np.float32)
    if phase == "global":
        M = np.full((n, n), 1.0 / n)
        return np.zeros((n, 1), np.float32), M.astype(np.float32)
    if phase == "pod_avg":
        if n % n_pods != 0:
            raise ValueError(f"n={n} not divisible by n_pods={n_pods}")
        per = n // n_pods
        M = np.zeros((n, n))
        for p in range(n_pods):
            M[p * per:(p + 1) * per, p * per:(p + 1) * per] = 1.0 / per
        return np.zeros((n, 1), np.float32), M.astype(np.float32)
    raise ValueError(f"no kernel decomposition for phase {phase!r}")


@functools.lru_cache(maxsize=64)
def _device_factors(phase: str, topology: str, n: int, step: int,
                    n_pods: int, device: torch.device):
    """``(d, M)`` on ``device``, made once per round kind: a fresh
    host-to-device copy every round would wait for the stream.  The one
    copy goes from pinned memory without blocking the host
    (``core.mixing.upload``)."""
    from repro_torch.core.mixing import upload
    d, M = phase_matrices(phase, topology, n, step=step, n_pods=n_pods)
    return upload(d, device), upload(M, device)


# ---------------------------------------------------------------------------
# Pytree <-> (n, D) node-major matrix
# ---------------------------------------------------------------------------
def _leaf_size(leaf: torch.Tensor) -> int:
    return int(np.prod(leaf.shape[1:], dtype=np.int64))


def _pack_rows(leaves, n: int) -> torch.Tensor:
    """Concatenate leaves' non-node dims into one fp32 ``(n, D)`` matrix
    (a view of the leaf when there is one fp32 leaf)."""
    cols = [lf.reshape(n, -1).to(torch.float32) for lf in leaves]
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)


def flatten_nodes(tree: PyTree):
    """``(flat, unflatten)`` for a node-stacked pytree: ``flat`` is the fp32
    ``(n, D)`` packing of every leaf in sorted-key order (the reference's
    ``jax.tree.flatten`` order, so offsets agree); ``unflatten(f,
    drop_node=False)`` restores structure, shapes and dtypes, and with
    ``drop_node=True`` maps a ``(1, D)`` row back to unstacked leaves."""
    leaves, treedef = tree_flatten(tree)
    n = leaves[0].shape[0]
    shapes = [lf.shape for lf in leaves]
    dtypes = [lf.dtype for lf in leaves]
    sizes = [_leaf_size(lf) for lf in leaves]
    flat = _pack_rows(leaves, n)

    def unflatten(f: torch.Tensor, drop_node: bool = False) -> PyTree:
        out, off = [], 0
        for shape, dtype, size in zip(shapes, dtypes, sizes):
            piece = f[:, off:off + size]
            lead = () if drop_node else (n,)
            out.append(piece.reshape(lead + tuple(shape[1:])).to(dtype))
            off += size
        return tree_unflatten(treedef, out)

    return flat, unflatten


class ModelChunks:
    """The column layout of a node-stacked pytree sliced over ``k_model``
    model shards, the reference's ``flatten_nodes_sharded``: each leaf's
    columns are zero-padded to a multiple of ``k_model`` and split into
    ``k_model`` chunks of ``widths[i]`` columns; model chunk j is chunk j
    of every leaf, in leaf order, ``W`` columns wide.

    :meth:`chunk` packs one model chunk of a tree of this layout into its
    own contiguous fp32 ``(rows, W)`` tensor (the per-shard kernels take
    contiguous operands); :meth:`unflatten` puts the ``k_model`` chunks of
    an output back into leaves.  At ``k_model == 1`` both are
    :func:`flatten_nodes`' (chunk 0 is its matrix, made contiguous)."""

    def __init__(self, tree: PyTree, k_model: int):
        leaves, self.treedef = tree_flatten(tree)
        self.k_model = max(int(k_model), 1)
        self.shapes = [tuple(lf.shape) for lf in leaves]
        self.dtypes = [lf.dtype for lf in leaves]
        self.sizes = [_leaf_size(lf) for lf in leaves]
        self.widths = [-(-s // self.k_model) for s in self.sizes]
        self.W = sum(self.widths)

    def chunk(self, tree: PyTree, j: int) -> torch.Tensor:
        """Model chunk ``j`` of ``tree`` (this layout's structure, any row
        count) as a contiguous fp32 ``(rows, W)`` tensor."""
        leaves = tree_leaves(tree)
        rows = leaves[0].shape[0]
        if self.k_model == 1:
            return _pack_rows(leaves, rows).contiguous()
        out = torch.empty((rows, self.W), dtype=torch.float32,
                          device=leaves[0].device)
        off = 0
        for lf, size, c in zip(leaves, self.sizes, self.widths):
            lo, hi = min(j * c, size), min((j + 1) * c, size)
            if hi > lo:
                out[:, off:off + hi - lo] = lf.reshape(rows, -1)[:, lo:hi]
            if hi - lo < c:
                out[:, off + hi - lo:off + c] = 0.0
            off += c
        return out

    def unflatten(self, parts, drop_node: bool = False) -> PyTree:
        """The tree whose model chunk j is ``parts[j]`` (``k_model`` fp32
        ``(rows, W)`` tensors); ``drop_node`` maps ``(1, W)`` chunks to
        unstacked leaves.  Pad columns are dropped."""
        rows = parts[0].shape[0]
        if self.k_model == 1:
            out, off = [], 0
            for shape, dtype, size in zip(self.shapes, self.dtypes,
                                          self.sizes):
                lead = () if drop_node else (rows,)
                out.append(parts[0][:, off:off + size].reshape(
                    lead + shape[1:]).to(dtype))
                off += size
            return tree_unflatten(self.treedef, out)
        out, off = [], 0
        for shape, dtype, size, c in zip(self.shapes, self.dtypes,
                                         self.sizes, self.widths):
            leaf = torch.empty((rows, size), dtype=torch.float32,
                               device=parts[0].device)
            for j, part in enumerate(parts):
                lo, hi = min(j * c, size), min((j + 1) * c, size)
                if hi > lo:
                    leaf[:, lo:hi] = part[:, off:off + hi - lo]
            lead = () if drop_node else (rows,)
            out.append(leaf.reshape(lead + shape[1:]).to(dtype))
            off += c
        return tree_unflatten(self.treedef, out)


def flatten_nodes_sharded(tree: PyTree, k_model: int):
    """``(flat, unflatten)`` in the reference's model-sharded layout
    (``flatten_nodes_sharded``): the ``k_model`` chunks of
    :class:`ModelChunks` side by side in one ``(n, k_model·W)`` fp32
    matrix, so columns ``j·W … (j+1)·W − 1`` are model shard j's.
    ``k_model <= 1`` is :func:`flatten_nodes`, byte for byte."""
    if k_model <= 1:
        return flatten_nodes(tree)
    lay = ModelChunks(tree, k_model)
    flat = torch.cat([lay.chunk(tree, j) for j in range(lay.k_model)], dim=1)

    def unflatten(f: torch.Tensor, drop_node: bool = False) -> PyTree:
        return lay.unflatten([f[:, j * lay.W:(j + 1) * lay.W]
                              for j in range(lay.k_model)], drop_node)

    return flat, unflatten


def _dispatch_groups(leaves, threshold: int):
    """Leaf indices per kernel launch: one group of every leaf below
    ``threshold`` per-node elements (the staging buffer), plus one group
    per large leaf."""
    sizes = [_leaf_size(lf) for lf in leaves]
    small = [i for i, s in enumerate(sizes) if s < threshold]
    big = [i for i, s in enumerate(sizes) if s >= threshold]
    groups = [small] if small else []
    return groups + [[i] for i in big]


def _block_size(n: int) -> int:
    """Threads per block: 256, halved until the per-thread column state
    (2n floats) fits the 48 KB every block gets without opting in; past
    n = 192 the kernel opts into more shared memory at 32 threads."""
    block = 256
    while block > 32 and 8 * n * block > 48 * 1024:
        block //= 2
    if 8 * n * block > _MAX_SMEM:
        raise ValueError(f"mix kernel: n={n} nodes need "
                         f"{8 * n * block} bytes of shared memory per "
                         f"block, over the H100's {_MAX_SMEM}")
    return block


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"repro_torch: {what} kernel launch failed with "
                           f"cudaError {err}")


def _check_operands(caller: str, xf: torch.Tensor, others) -> torch.device:
    """Shape/dtype/device checks shared by the compressed wrappers; returns
    the device, raising on one the port has no path for."""
    if xf.dim() != 2 or xf.dtype != torch.float32:
        raise ValueError(f"{caller}: x must be (n, D) float32, got "
                         f"{tuple(xf.shape)} {xf.dtype}")
    if any(t.dtype != torch.float32 for t in others):
        raise ValueError(f"{caller}: every operand must be float32")
    devices = {t.device for t in [xf, *others]}
    if len(devices) != 1:
        raise ValueError(f"{caller}: operands on several devices {devices}")
    dev = xf.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{caller}: unsupported device {dev}")
    if dev.type == "cuda":
        if not all(t.is_contiguous() for t in [xf, *others]):
            raise ValueError(f"{caller}: operands must be contiguous")
        if xf.shape[1] == 0:
            raise ValueError(f"{caller}: empty parameter matrix")
    return dev


def vector_width(n: int) -> int:
    """Columns a thread of the register instances holds at n nodes (16
    bytes a row up to n = 8), as ``vec_width`` in mix.cu and cmix.cu."""
    return 4 if n <= 8 else (2 if n <= 16 else 1)


def _vector_rows(n: int, D: int, tensors) -> bool:
    return (n in VECTOR_NODES and D % vector_width(n) == 0
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0
                    for t in tensors))


def use_vector_mix(xf: torch.Tensor,
                   gf: Optional[torch.Tensor] = None) -> bool:
    """Whether a CUDA round on ``xf`` (n, D) (and ``gf``) launches the
    register instance of mix.cu: n in :data:`VECTOR_NODES`, D a multiple
    of :func:`vector_width`, contiguous operands at 16-byte aligned
    pointers (so every row is aligned; the outputs are fresh or ``xf``).
    Pure: reads shapes, strides and pointers only."""
    n, D = xf.shape
    return _vector_rows(n, D, [xf] + ([gf] if gf is not None else []))


def _launch(xf, gf, gamma, d, M, *, with_g, with_residual, wire, inplace,
            vector: bool):
    n, D = xf.shape
    if xf.device.type != "cuda":
        raise ValueError("mix kernel: CUDA operands expected")
    if vector and not use_vector_mix(xf, gf if with_g else None):
        raise ValueError("mix_vector: operands outside use_vector_mix's rule")
    o = xf if inplace else torch.empty_like(xf)
    block = _block_size(n)
    dev = xf.device
    xbar = partial = resid = None
    if with_residual:
        xbar = torch.empty((1, D), dtype=torch.float32, device=dev)
        partial = torch.empty(
            (VECTOR_MAX_GRID if vector else (D + block - 1) // block,),
            dtype=torch.float32, device=dev)
        resid = torch.empty((), dtype=torch.float32, device=dev)
    args = (_ptr(xf), _ptr(gf), _ptr(gamma), _ptr(d), _ptr(M), _ptr(o),
            _ptr(xbar), _ptr(partial), _ptr(resid), D, n, int(with_g),
            int(wire), int(with_residual))
    if vector:
        err = cuda_build.entry("mix_vector")(*args, VECTOR_MAX_GRID,
                                             _stream(dev))
    else:
        err = cuda_build.entry("mix")(*args, block, _stream(dev))
    _check_launch(err, f"mix (n={n}, D={D}, vector={vector})")
    return (o, xbar, resid) if with_residual else o


def mix_generic(xf, gf, gamma, d, M, *, with_g: bool, with_residual: bool,
                wire: bool, inplace: bool = False):
    """Launch mix.cu's generic instance on CUDA operands (any n, D and
    alignment); counted in ``mix_flat.launches``."""
    out = _launch(xf, gf, gamma, d, M, with_g=with_g,
                  with_residual=with_residual, wire=wire, inplace=inplace,
                  vector=False)
    mix_flat.launches += 1
    return out


def mix_vector(xf, gf, gamma, d, M, *, with_g: bool, with_residual: bool,
               wire: bool, inplace: bool = False):
    """Launch mix.cu's register instance on CUDA operands that
    :func:`use_vector_mix` accepts (raises otherwise); counted in
    ``mix_flat.vector_launches``."""
    out = _launch(xf, gf, gamma, d, M, with_g=with_g,
                  with_residual=with_residual, wire=wire, inplace=inplace,
                  vector=True)
    mix_flat.vector_launches += 1
    return out


# ---------------------------------------------------------------------------
# The wrapper and its plain twin
# ---------------------------------------------------------------------------
def mix_flat_plain(xf, gf, gamma, d, M, *, with_g: bool,
                   with_residual: bool, wire: bool):
    """Plain PyTorch version of the round: ``d⊙x + M @ wire(x)`` (+ x̄ and
    ``Σ‖o − x̄‖²``)."""
    x = xf.to(torch.float32)
    if with_g:
        x = x - gamma.reshape(()) * gf.to(torch.float32)
    onwire = x.to(torch.bfloat16).to(torch.float32) if wire else x
    o = torch.matmul(M, onwire) + d * x
    if not with_residual:
        return o
    xbar = pairwise_mean(o)
    return o, xbar, torch.sum(torch.square(o - xbar))


def mix_flat(xf: torch.Tensor, gf: Optional[torch.Tensor],
             gamma: Optional[torch.Tensor], d: torch.Tensor,
             M: torch.Tensor, *, with_g: bool, with_residual: bool,
             wire: bool, inplace: bool = False):
    """Run the fused round over an already-packed ``(n, D)`` fp32 matrix.

    Returns ``o`` or, with ``with_residual``, ``(o, xbar (1, D),
    residual)``.  A CUDA ``xf`` launches the instance of mix.cu that
    :func:`use_vector_mix` picks (:func:`mix_vector` or
    :func:`mix_generic`); a CPU ``xf`` takes :func:`mix_flat_plain`.
    ``inplace`` lets the kernel write ``o`` into ``xf``: only for a private
    staging buffer that nobody reads again.
    """
    n = xf.shape[0]
    if tuple(d.shape) != (n, 1) or tuple(M.shape) != (n, n):
        raise ValueError("mix_flat: d must be (n, 1) and M (n, n)")
    if with_g and (gf.shape != xf.shape or gamma.numel() != 1):
        raise ValueError("mix_flat: g must match x and gamma be one value")
    dev = _check_operands("mix_flat", xf,
                          [d, M] + ([gf, gamma] if with_g else []))
    if dev.type == "cpu":
        return mix_flat_plain(xf, gf, gamma, d, M, with_g=with_g,
                              with_residual=with_residual, wire=wire)
    launch = (mix_vector if use_vector_mix(xf, gf if with_g else None)
              else mix_generic)
    return launch(xf, gf, gamma, d, M, with_g=with_g,
                  with_residual=with_residual, wire=wire, inplace=inplace)


mix_flat.launches = 0
mix_flat.vector_launches = 0


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def fused_step_mix(params: PyTree, grads: Optional[PyTree] = None,
                   gamma=None, *, phase: str, topology: str = "ring",
                   n_nodes: int, step: int = 0, comm_dtype=None,
                   n_pods: int = 1, with_residual: bool = False,
                   leaf_threshold: Optional[int] = None):
    """Fused ``W · (params − γ·grads)`` for one round (grads/γ optional).

    Returns the mixed pytree or, with ``with_residual``, ``(mixed, xbar,
    residual)``: ``xbar`` the node average (leaves without the node axis),
    ``residual = Σ_i ‖x_i − x̄‖²`` of the mixed iterate, summed over the
    launches.
    """
    if phase not in KERNEL_PHASES:
        raise ValueError(f"phase {phase!r} has no fused kernel "
                         f"(expected one of {KERNEL_PHASES})")
    if comm_dtype is not None and comm_dtype != torch.bfloat16:
        raise ValueError(f"the fused kernel wire-casts to bfloat16 only "
                         f"(got comm_dtype={comm_dtype})")
    leaves = tree_flatten(params)[0]
    d, M = _device_factors(phase, topology, n_nodes, step, n_pods,
                           leaves[0].device)
    wire = (comm_dtype is not None
            and not (phase == "gossip" and topology == "grid"))
    return _mix_groups(params, d, M, wire=wire, grads=grads, gamma=gamma,
                       with_residual=with_residual,
                       leaf_threshold=leaf_threshold)


def _mix_groups(params: PyTree, d: torch.Tensor, M: torch.Tensor, *,
                wire: bool, grads: Optional[PyTree] = None, gamma=None,
                with_residual: bool = False,
                leaf_threshold: Optional[int] = None):
    """One :func:`mix_flat` launch per dispatch group of ``params`` with
    the round's ``(d, M)`` on the leaves' device; the body of
    :func:`fused_step_mix` and :func:`fused_step_mix_dense`."""
    thresh = (LEAF_DISPATCH_THRESHOLD if leaf_threshold is None
              else leaf_threshold)
    leaves, treedef = tree_flatten(params)
    n = leaves[0].shape[0]
    dev = leaves[0].device
    with_g = grads is not None
    if with_g and gamma is None:
        raise ValueError("grads given without gamma")
    gleaves = tree_flatten(grads)[0] if with_g else None
    gam = None
    if with_g:
        gam = torch.as_tensor(gamma, dtype=torch.float32,
                              device=dev).reshape(1)
    mixed_leaves: list = [None] * len(leaves)
    xbar_leaves: list = [None] * len(leaves)
    resid = None
    for group in _dispatch_groups(leaves, thresh):
        xf = _pack_rows([leaves[i] for i in group], n)
        # a concatenation is a private staging buffer: consume in place
        private = xf.data_ptr() != leaves[group[0]].data_ptr()
        gf = (_pack_rows([gleaves[i] for i in group], n).contiguous()
              if with_g else None)
        out = mix_flat(xf.contiguous(), gf, gam, d, M, with_g=with_g,
                       with_residual=with_residual, wire=wire,
                       inplace=private)
        if with_residual:
            mixed, xbar, r = out
            resid = r if resid is None else resid + r
        else:
            mixed, xbar = out, None
        off = 0
        for i in group:
            shape, size = leaves[i].shape, _leaf_size(leaves[i])
            dtype = leaves[i].dtype
            mixed_leaves[i] = mixed[:, off:off + size].reshape(shape).to(
                dtype)
            if with_residual:
                xbar_leaves[i] = xbar[:, off:off + size].reshape(
                    shape[1:]).to(dtype)
            off += size
    mixed_tree = tree_unflatten(treedef, mixed_leaves)
    if with_residual:
        return mixed_tree, tree_unflatten(treedef, xbar_leaves), resid
    return mixed_tree


def dense_factors(W: torch.Tensor, n_nodes: int):
    """``(d, M)`` of a runtime ``(n, n)`` mixing matrix on W's device:
    ``d = diag(W)`` (n, 1) and ``M = W − diag(W)``, built there from the
    tensor (no host round trip, nothing cached: a push-sum W is new data
    every step)."""
    if tuple(W.shape) != (n_nodes, n_nodes):
        raise ValueError(f"dense round: W must be ({n_nodes}, {n_nodes}), "
                         f"got {tuple(W.shape)}")
    Wf = W.to(torch.float32)
    diag = torch.diagonal(Wf)
    return diag.reshape(n_nodes, 1).contiguous(), Wf - torch.diag(diag)


def fused_step_mix_dense(params: PyTree, W: torch.Tensor, *, n_nodes: int,
                         comm_dtype=None,
                         leaf_threshold: Optional[int] = None) -> PyTree:
    """Fused mixing round for a **runtime** dense ``W`` (push-sum): the
    kernel of :func:`fused_step_mix`, with ``d = diag(W)`` and ``M = W −
    diag(W)`` built on the device from the W tensor each call
    (:func:`dense_factors`), so a new fault pattern is new data.  Gossip
    wire semantics: ``comm_dtype`` (bf16 only) casts the M term.  The
    push-sum weight column rides the packed staging buffer as one more
    leaf of ``params``."""
    if comm_dtype is not None and comm_dtype != torch.bfloat16:
        raise ValueError(
            f"fused_step_mix_dense wire-casts to bfloat16 only (got "
            f"comm_dtype={comm_dtype}); use backend='reference'")
    d, M = dense_factors(W, n_nodes)
    return _mix_groups(params, d, M, wire=comm_dtype is not None,
                       leaf_threshold=leaf_threshold)


def global_average(params: PyTree, n_nodes: int, *, comm_dtype=None,
                   with_residual: bool = False,
                   leaf_threshold: Optional[int] = None):
    """Fused periodic global averaging ``x ← (1/n)𝟙𝟙ᵀ x`` (PGA round)."""
    return fused_step_mix(params, phase="global", n_nodes=n_nodes,
                          comm_dtype=comm_dtype, with_residual=with_residual,
                          leaf_threshold=leaf_threshold)


def pod_average(params: PyTree, n_nodes: int, n_pods: int, *,
                comm_dtype=None, with_residual: bool = False,
                leaf_threshold: Optional[int] = None):
    """Fused intra-pod exact averaging (the Hier-PGA round)."""
    return fused_step_mix(params, phase="pod_avg", n_nodes=n_nodes,
                          n_pods=n_pods, comm_dtype=comm_dtype,
                          with_residual=with_residual,
                          leaf_threshold=leaf_threshold)


def mix_residual(params: PyTree, grads: Optional[PyTree] = None,
                 gamma=None, *, phase: str, topology: str = "ring",
                 n_nodes: int, step: int = 0, comm_dtype=None,
                 n_pods: int = 1, leaf_threshold: Optional[int] = None):
    """``(W·x, x̄, Σ_i ‖x_i − x̄‖²)`` in one pass."""
    return fused_step_mix(params, grads, gamma, phase=phase,
                          topology=topology, n_nodes=n_nodes, step=step,
                          comm_dtype=comm_dtype, n_pods=n_pods,
                          with_residual=True, leaf_threshold=leaf_threshold)


# ---------------------------------------------------------------------------
# Compressed rounds: the compensated gossip kernel (cmix.cu) and the
# compressed collective (collective.cu)
# ---------------------------------------------------------------------------
CMIX_KINDS = {"int8": 0, "fp8": 1, "precomputed": 2}
COLLECTIVE_KINDS = {"int8": 0, "fp8": 1}
COLLECTIVE_BLOCK = 256      # threads per 1024-column scale block


def cmix_flat_plain(xf, ef, qf, seed, scale, w, M, *, kind: str,
                    with_ef: bool, wire: bool):
    """Plain PyTorch version of the compensated round on one ``(n, D)``
    leaf: ``(o, ef_out)``.  ``Σ_k M_ik q_k`` is summed in the kernel's
    order, k = 0 … n−1, with separately rounded products and sums."""
    from repro_torch.compress import quantize as cq
    from repro_torch.compress.base import (column_bits, column_range,
                                           uniform_columns)

    ef_out = None
    if kind == "precomputed":
        q = qf
    else:
        y = xf + ef if with_ef else xf
        cols = column_range(xf.shape[1], xf.device)[None, :]
        if kind == "int8":
            codes = cq.int8_codes(y, scale, uniform_columns(seed, cols))
            q = cq.int8_dequant(codes, scale)
        else:
            codes = cq.fp8_codes(y, scale, column_bits(seed, cols))
            q = cq.fp8_dequant(codes, scale)
        if with_ef:
            ef_out = y - q
    if wire:
        q = q.to(torch.bfloat16).to(torch.float32)
    acc = torch.zeros_like(xf)
    for k in range(xf.shape[0]):
        acc = acc + M[:, k:k + 1] * q[k:k + 1]
    return xf + (acc - w * q), ef_out


def use_vector_cmix(xf: torch.Tensor, ef: Optional[torch.Tensor] = None,
                    qf: Optional[torch.Tensor] = None) -> bool:
    """Whether a CUDA round on ``xf`` (n, D) (with ``ef`` or ``qf``)
    launches the register instance of cmix.cu: the rule of
    :func:`use_vector_mix` over every row operand (the outputs are fresh).
    Pure: reads shapes, strides and pointers only."""
    n, D = xf.shape
    return _vector_rows(n, D, [t for t in (xf, ef, qf) if t is not None])


def cmix_flat(xf: torch.Tensor, ef: Optional[torch.Tensor],
              qf: Optional[torch.Tensor], seed: int,
              scale: Optional[torch.Tensor], w: torch.Tensor,
              M: torch.Tensor, *, kind: str, with_ef: bool, wire: bool):
    """Run the compensated compressed round over one ``(n, D)`` fp32 leaf:
    ``(o, ef_out)`` (``ef_out`` None without error feedback).

    ``kind``: "int8"/"fp8" make ``q`` in the kernel from ``x (+ ef)``,
    the per-row ``scale`` and the uint32 ``seed``; "precomputed" takes
    ``qf``.  A CUDA ``xf`` launches, into fresh outputs, the instance of
    cmix.cu that :func:`use_vector_cmix` picks (:func:`cmix_vector` or
    :func:`cmix_generic`); a CPU ``xf`` takes :func:`cmix_flat_plain`.
    """
    quant, with_ef = _check_cmix(xf, ef, qf, scale, w, M, kind, with_ef)
    if xf.device.type == "cpu":
        return cmix_flat_plain(xf, ef, qf, seed, scale, w, M, kind=kind,
                               with_ef=with_ef, wire=wire)
    vector = use_vector_cmix(xf, ef if with_ef else None,
                             None if quant else qf)
    launch = cmix_vector if vector else cmix_generic
    return launch(xf, ef, qf, seed, scale, w, M, kind=kind, with_ef=with_ef,
                  wire=wire)


def _check_cmix(xf, ef, qf, scale, w, M, kind, with_ef):
    """Operand checks of the cmix wrappers; returns ``(quant, with_ef)``."""
    if kind not in CMIX_KINDS:
        raise ValueError(f"cmix_flat: unknown kind {kind!r} "
                         f"(expected one of {tuple(CMIX_KINDS)})")
    quant = kind != "precomputed"
    with_ef = with_ef and quant
    n, D = xf.shape
    if tuple(w.shape) != (n, 1) or tuple(M.shape) != (n, n):
        raise ValueError("cmix_flat: w must be (n, 1) and M (n, n)")
    operands = [w, M] + ([scale] if quant else [qf]) + (
        [ef] if with_ef else [])
    if any(t.shape != xf.shape for t in operands[3:] if t is not None) or (
            quant and tuple(scale.shape) != (n, 1)):
        raise ValueError("cmix_flat: q/ef must match x and scale be (n, 1)")
    _check_operands("cmix_flat", xf, operands)
    return quant, with_ef


def _launch_cmix(xf, ef, qf, seed, scale, w, M, kind, with_ef, wire,
                 vector: bool):
    quant, with_ef = _check_cmix(xf, ef, qf, scale, w, M, kind, with_ef)
    if xf.device.type != "cuda":
        raise ValueError("cmix kernel: CUDA operands expected")
    if vector and not use_vector_cmix(xf, ef if with_ef else None,
                                      None if quant else qf):
        raise ValueError("cmix_vector: operands outside use_vector_cmix's "
                         "rule")
    n, D = xf.shape
    o = torch.empty_like(xf)
    ef_out = torch.empty_like(xf) if with_ef else None
    args = (_ptr(xf), _ptr(ef if with_ef else None),
            _ptr(None if quant else qf), _ptr(scale if quant else None),
            _ptr(w), _ptr(M), _ptr(o), _ptr(ef_out), int(seed) & 0xFFFFFFFF,
            D, n, CMIX_KINDS[kind], int(with_ef), int(wire))
    if vector:
        err = cuda_build.entry("cmix_vector")(*args, _stream(xf.device))
    else:
        err = cuda_build.entry("cmix")(*args, _block_size(n),
                                       _stream(xf.device))
    _check_launch(err, f"cmix (n={n}, D={D}, kind={kind}, vector={vector})")
    return o, ef_out


def cmix_generic(xf, ef, qf, seed, scale, w, M, *, kind: str, with_ef: bool,
                 wire: bool):
    """Launch cmix.cu's generic instance on CUDA operands; counted in
    ``cmix_flat.launches``."""
    out = _launch_cmix(xf, ef, qf, seed, scale, w, M, kind, with_ef, wire,
                       vector=False)
    cmix_flat.launches += 1
    return out


def cmix_vector(xf, ef, qf, seed, scale, w, M, *, kind: str, with_ef: bool,
                wire: bool):
    """Launch cmix.cu's register instance on CUDA operands that
    :func:`use_vector_cmix` accepts (raises otherwise); counted in
    ``cmix_flat.vector_launches``."""
    out = _launch_cmix(xf, ef, qf, seed, scale, w, M, kind, with_ef, wire,
                       vector=True)
    cmix_flat.vector_launches += 1
    return out


cmix_flat.launches = 0
cmix_flat.vector_launches = 0
cmix_flat.absmax_launches = 0


def cmix_absmax_plain(xf: torch.Tensor,
                      ef: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the rows' maxima: ``(n, 1)`` of
    ``max_j |x_kj + e_kj|`` (``|x_kj|`` without ``ef``)."""
    from repro_torch.compress import quantize as cq
    return cq.absmax_rows(xf if ef is None else xf + ef)


def cmix_absmax(xf: torch.Tensor,
                ef: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rows' maxima from which the compressed round makes its int8/fp8
    scales, reading x and e once and writing no ``x + e``.  A CUDA ``xf``
    launches cmix.cu's ``repro_cmix_absmax`` (counted in
    ``cmix_flat.absmax_launches``); a CPU ``xf`` takes
    :func:`cmix_absmax_plain`.  Both give the same bits, NaN rows
    included."""
    if ef is not None and ef.shape != xf.shape:
        raise ValueError("cmix_absmax: ef must match x")
    dev = _check_operands("cmix_absmax", xf, [] if ef is None else [ef])
    if dev.type == "cpu":
        return cmix_absmax_plain(xf, ef)
    n, D = xf.shape
    m = torch.empty((n, 1), dtype=torch.float32, device=dev)
    partial = torch.empty((n * ABSMAX_MAX_CHUNKS,), dtype=torch.float32,
                          device=dev)
    err = cuda_build.entry("cmix_absmax")(
        _ptr(xf), _ptr(ef), _ptr(partial), _ptr(m), D, n, int(ef is not None),
        ABSMAX_MAX_CHUNKS, _stream(dev))
    _check_launch(err, f"cmix_absmax (n={n}, D={D})")
    cmix_flat.absmax_launches += 1
    return m


def collective_flat_plain(xf, ef, s1: int, s2: int, *, kind: str,
                          with_ef: bool, n_pods: int, qblock: int):
    """Plain PyTorch version of the compressed collective on the packed
    ``(n, D)`` matrix: ``(o, ef_out)``."""
    from repro_torch.compress import collective as ccol
    return ccol.collective_round_seeds(xf, ef if with_ef else None, kind,
                                       s1, s2, n_pods=n_pods, qblock=qblock)


def collective_smem(n: int, n_pods: int, qblock: int, tiled: bool) -> int:
    """Bytes of shared memory a block of ``collective.cu`` takes: the q1
    tile (tiled instance only), the warp partials and both stages'
    scales (``launch`` there)."""
    nwarps = COLLECTIVE_BLOCK // 32
    return 4 * ((n * qblock if tiled else 0) + (n_pods + n) * nwarps
                + n_pods + 2 * n)


def collective_flat(xf: torch.Tensor, ef: Optional[torch.Tensor], s1: int,
                    s2: int, *, kind: str, with_ef: bool, n_pods: int,
                    qblock: int, inplace: bool = False,
                    tiled: Optional[bool] = None):
    """Run the compressed collective over the packed ``(n, D)`` fp32 matrix:
    ``(o, ef_out)``.  The kernel masks the ragged last ``qblock`` block, so
    nothing is padded.  ``inplace`` writes ``o`` into ``xf`` and ``ef_out``
    into ``ef``: only for private packed buffers nobody reads again.  A
    CUDA ``xf`` launches ``collective.cu`` (counted in
    ``collective_flat.launches``): the instance that keeps the q1 tile in
    shared memory while it fits the card's 227 KB, else the one that
    recomputes q1 (bitwise the same; ``tiled`` forces one); a CPU ``xf``
    takes :func:`collective_flat_plain`."""
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"collective_flat: unsupported kind {kind!r} "
                         f"(expected one of {tuple(COLLECTIVE_KINDS)})")
    n, D = xf.shape
    if n_pods < 1 or n % n_pods:
        raise ValueError(f"collective_flat: n_pods={n_pods} does not divide "
                         f"n={n}")
    if with_ef and ef.shape != xf.shape:
        raise ValueError("collective_flat: ef must match x")
    dev = _check_operands("collective_flat", xf, [ef] if with_ef else [])
    if dev.type == "cpu":
        return collective_flat_plain(xf, ef, s1, s2, kind=kind,
                                     with_ef=with_ef, n_pods=n_pods,
                                     qblock=qblock)
    if qblock % COLLECTIVE_BLOCK:
        raise ValueError(f"collective_flat: qblock={qblock} must be a "
                         f"multiple of {COLLECTIVE_BLOCK} on the card")
    if tiled is None:
        tiled = collective_smem(n, n_pods, qblock, True) <= \
            cuda_build.MAX_SMEM
    if collective_smem(n, n_pods, qblock, tiled) > cuda_build.MAX_SMEM:
        raise ValueError(f"collective_flat: n={n} rows of a {qblock}-column "
                         f"block need more shared memory than the H100's "
                         f"{cuda_build.MAX_SMEM} bytes")
    o = xf if inplace else torch.empty_like(xf)
    ef_out = None
    if with_ef:
        ef_out = ef if inplace else torch.empty_like(ef)
    err = cuda_build.entry("collective")(
        _ptr(xf), _ptr(ef if with_ef else None), _ptr(o), _ptr(ef_out),
        int(s1) & 0xFFFFFFFF, int(s2) & 0xFFFFFFFF, D, n, n_pods, qblock,
        COLLECTIVE_KINDS[kind], int(with_ef), COLLECTIVE_BLOCK, int(tiled),
        _stream(dev))
    _check_launch(err, f"collective (n={n}, D={D}, kind={kind})")
    collective_flat.launches += 1
    return o, ef_out


collective_flat.launches = 0


@functools.lru_cache(maxsize=64)
def _device_compensated(phase: str, topology: str, n: int, step: int,
                        n_pods: int, device: torch.device):
    """``(w, M)`` of the compensated round on ``device``, made once per
    round kind (``w = 1 − diag(W)``), copied as :func:`_device_factors`
    copies its factors."""
    from repro_torch.core.mixing import upload
    d, M = phase_matrices(phase, topology, n, step=step, n_pods=n_pods)
    w = (1.0 - d).astype(np.float32)
    return upload(w, device), upload(M, device)


def compressed_step_mix(params: PyTree, *, compressor,
                        ef_state: Optional[PyTree] = None, seed: int = 0,
                        phase: str, topology: str = "ring", n_nodes: int,
                        step: int = 0, n_pods: int = 1, comm_dtype=None):
    """Fused compressed round ``mixed = x + (M·q − (1−d)⊙q)``, ``q`` the
    compressed-wire estimate of ``x (+ ef)``, one kernel pass per leaf.

    int8/fp8 make ``q`` in the kernel (the per-leaf scale comes from the
    rows' maxima of ``x + ef``, :func:`cmix_absmax`); topk/randk precompute ``q`` with the
    reference codec and the kernel fuses the compensated mix.  Returns
    ``(mixed, new_ef_state)`` (None without ``ef_state``).  The consensus
    residual does not fuse with compression: callers use
    ``train.state.consensus_distance``.
    """
    if phase not in KERNEL_PHASES:
        raise ValueError(f"phase {phase!r} has no fused kernel "
                         f"(expected one of {KERNEL_PHASES})")
    # global phase: the averaging operand is uncompressed fp32 sums, so
    # comm_dtype still wire-casts the estimate (both occurrences)
    wire = phase == "global" and comm_dtype is not None
    if wire and comm_dtype != torch.bfloat16:
        raise ValueError(f"compressed_step_mix: the fused kernel wire-casts "
                         f"to bfloat16 only (got comm_dtype={comm_dtype})")
    dev = tree_flatten(params)[0][0].device
    w, M = _device_compensated(phase, topology, n_nodes, step, n_pods, dev)
    kind = (compressor.name if compressor.name in ("int8", "fp8")
            else "precomputed")
    return _compressed_leaf_loop(params, compressor, ef_state, seed, w, M,
                                 kind=kind, wire=wire)


def compressed_step_mix_dense(params: PyTree, *, W: torch.Tensor,
                              compressor, ef_state: Optional[PyTree] = None,
                              seed: int = 0, n_nodes: int):
    """Compensated compressed gossip round for a runtime dense ``W``
    (push-sum under faults): the kernel of :func:`compressed_step_mix`
    with ``w = 1 − diag(W)`` and ``M = W − diag(W)`` built on the device
    from the W tensor.  ``mixed = x + (M·q − w⊙q)`` combines one shared
    per-node estimate q, so a column-stochastic W conserves the push-sum
    mass as the exact round does; the caller mixes the weight column
    outside this lossy codec.  Returns ``(mixed, new_ef_state)``."""
    d, M = dense_factors(W, n_nodes)
    w = 1.0 - d
    kind = (compressor.name if compressor.name in ("int8", "fp8")
            else "precomputed")
    # gossip wire semantics only: the push-sum global round is never
    # compressed (DistConfig refuses it), so no wire cast here
    return _compressed_leaf_loop(params, compressor, ef_state, seed, w, M,
                                 kind=kind, wire=False)


def _compressed_leaf_loop(params: PyTree, compressor, ef_state, seed,
                          w: torch.Tensor, M: torch.Tensor, *, kind: str,
                          wire: bool):
    """Per-leaf dispatch of the compensated round: scales, salts and
    sparsifier selections are per leaf, so leaves are never packed."""
    from repro_torch import compress as compress_mod
    from repro_torch.compress import quantize as cq

    with_ef = ef_state is not None
    leaves, treedef = tree_flatten(params)
    n = leaves[0].shape[0]
    ef_leaves = (tree_flatten(ef_state)[0] if with_ef
                 else [None] * len(leaves))
    new_ef = None
    if kind == "precomputed":
        q_tree, new_ef = compress_mod.apply_tree(compressor, params,
                                                 ef_state, seed)
        q_leaves = tree_flatten(q_tree)[0]
    mixed_leaves, new_ef_leaves = [], []
    for i, (leaf, e) in enumerate(zip(leaves, ef_leaves)):
        x2 = leaf.reshape(n, -1).to(torch.float32).contiguous()
        if kind == "precomputed":
            q2 = q_leaves[i].reshape(n, -1).contiguous()
            mixed, _ = cmix_flat(x2, None, q2, 0, None, w, M, kind=kind,
                                 with_ef=False, wire=wire)
        else:
            e2 = (e.reshape(n, -1).to(torch.float32).contiguous()
                  if e is not None else None)
            m = cmix_absmax(x2, e2)
            scale = (cq.int8_scale_of_max(m) if kind == "int8"
                     else cq.fp8_scale_of_max(m))
            mixed, ef_out = cmix_flat(
                x2, e2, None, compress_mod.leaf_seed(seed, i), scale, w, M,
                kind=kind, with_ef=with_ef, wire=wire)
            if with_ef:
                new_ef_leaves.append(ef_out.reshape(e.shape).to(e.dtype))
        mixed_leaves.append(mixed.reshape(leaf.shape).to(leaf.dtype))
    mixed_tree = tree_unflatten(treedef, mixed_leaves)
    if not with_ef:
        return mixed_tree, None
    if kind == "precomputed":
        return mixed_tree, new_ef
    return mixed_tree, tree_unflatten(treedef, new_ef_leaves)


def collective_step_mix(params: PyTree, *, compressor,
                        ef_state: Optional[PyTree] = None, seed: int = 0,
                        phase: str, n_nodes: int, n_pods: int = 1,
                        qblock: Optional[int] = None):
    """Fused compressed global/pod-averaging round: the packed ``(n, D)``
    state goes through quantize → anchored accumulate → re-quantize →
    compensate in one kernel pass (scales per ``qblock`` column block, so
    the dispatch is the packed matrix, not per leaf).  Returns
    ``(mixed, new_ef_state)`` (None without ``ef_state``)."""
    from repro_torch.compress import collective as ccol

    if phase not in ("global", "pod_avg"):
        raise ValueError(f"collective_step_mix: phase {phase!r} is not an "
                         f"averaging round (expected 'global' or 'pod_avg')")
    pods = n_pods if phase == "pod_avg" else 1
    if pods < 1 or n_nodes % pods:
        raise ValueError(f"collective_step_mix: n_pods={pods} does not "
                         f"divide n_nodes={n_nodes}")
    qb = ccol.QBLOCK if qblock is None else qblock
    xf, unflatten = flatten_nodes(params)
    leaf0 = tree_flatten(params)[0][0]
    # a concatenation is private: the kernel may write o into it
    private = xf.data_ptr() != leaf0.data_ptr()
    with_ef = ef_state is not None
    ef2 = ef_unflatten = None
    if with_ef:
        ef2, ef_unflatten = flatten_nodes(ef_state)
        private = private and (ef2.data_ptr()
                               != tree_flatten(ef_state)[0][0].data_ptr())
    s1, s2 = ccol.stage_seeds(seed)
    mixed, ef_out = collective_flat(
        xf.contiguous(), ef2.contiguous() if with_ef else None, s1, s2,
        kind=compressor.name, with_ef=with_ef, n_pods=pods, qblock=qb,
        inplace=private)
    del xf, ef2
    return (unflatten(mixed),
            ef_unflatten(ef_out) if with_ef else None)


# ---------------------------------------------------------------------------
# Per-shard rounds of the sharded path: shard_mix.cu and shard_cmix.cu
# ---------------------------------------------------------------------------
def _shard_block(K: int) -> int:
    """Threads per block: 256, halved until the K halo floats each thread
    keeps in shared memory fit the 48 KB every block gets without opting
    in; past that the kernel opts into more at 32 threads."""
    block = 256
    while block > 32 and 4 * K * block > 48 * 1024:
        block //= 2
    if 4 * K * block > cuda_build.MAX_SMEM:
        raise ValueError(f"shard kernels: K={K} halo rows need "
                         f"{4 * K * block} bytes of shared memory per "
                         f"block, over the H100's {cuda_build.MAX_SMEM}")
    return block


def _check_shard_out(caller: str, out: Optional[torch.Tensor],
                     x: torch.Tensor, inputs) -> None:
    """``out`` must be a fresh ``(m, D)`` fp32 buffer on x's device that
    shares no storage with an input: a later shard's halo reads the
    round's input rows, so no shard may write over them."""
    if out is None:
        return
    if (out.shape != x.shape or out.dtype != torch.float32
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"{caller}: out must be a contiguous (m, D) "
                         f"float32 tensor on {x.device}")
    base = out.untyped_storage().data_ptr()
    if any(t.untyped_storage().data_ptr() == base for t in inputs):
        raise ValueError(f"{caller}: out shares storage with an input; "
                         f"every shard writes into a fresh output")


def shard_mix_block_plain(x, xs, d, M, *, with_residual: bool):
    """Plain PyTorch version of one shard's round: ``d⊙x + M @ xs`` (+ its
    column sums ``(1, D)``)."""
    o = torch.matmul(M, xs) + d * x
    if not with_residual:
        return o
    return o, torch.sum(o, dim=0, keepdim=True)


def shard_mix_block(x: torch.Tensor, xs: torch.Tensor, d: torch.Tensor,
                    M: torch.Tensor, *, with_residual: bool = False,
                    out: Optional[torch.Tensor] = None):
    """One node shard's fused round over its ``(m, D)`` row-block.

    ``x`` is the shard's uncast rows, ``xs`` the ``(K, D)`` stack of
    gathered halo rows (self and neighbour blocks, wire-cast by the
    caller), ``d`` the shard's ``(m, 1)`` self weights and ``M`` its
    ``(m, K)`` factor over the halo rows.  Returns ``o`` or, with
    ``with_residual``, ``(o, column sums (1, D))``.  ``o`` is written into
    ``out`` when given (a fresh buffer apart from the inputs), else into a
    new tensor.  A CUDA ``x`` launches ``shard_mix.cu`` (counted in
    ``shard_mix_block.launches``); a CPU ``x`` takes
    :func:`shard_mix_block_plain`.
    """
    m, D = x.shape
    K = xs.shape[0]
    if xs.dim() != 2 or xs.shape[1] != D or tuple(d.shape) != (m, 1) \
            or tuple(M.shape) != (m, K):
        raise ValueError("shard_mix_block: xs must be (K, D), d (m, 1) and "
                         "M (m, K)")
    dev = _check_operands("shard_mix_block", x, [xs, d, M])
    _check_shard_out("shard_mix_block", out, x, [x, xs])
    if dev.type == "cpu":
        res = shard_mix_block_plain(x, xs, d, M,
                                    with_residual=with_residual)
        if out is None:
            return res
        o = res[0] if with_residual else res
        out.copy_(o)
        return (out, res[1]) if with_residual else out
    o = torch.empty_like(x) if out is None else out
    cs = (torch.empty((1, D), dtype=torch.float32, device=dev)
          if with_residual else None)
    block = _shard_block(K)
    err = cuda_build.entry("shard_mix")(
        _ptr(x), _ptr(xs), _ptr(d), _ptr(M), _ptr(o), _ptr(cs), D, m, K,
        int(with_residual), block, _stream(dev))
    _check_launch(err, f"shard_mix (m={m}, K={K}, D={D})")
    shard_mix_block.launches += 1
    return (o, cs) if with_residual else o


shard_mix_block.launches = 0


def shard_comp_mix_block_plain(x, q_self, qs, w, M):
    """Plain PyTorch version of one shard's compensated round:
    ``x + (M @ qs − w⊙q_self)``."""
    return x + (torch.matmul(M, qs) - w * q_self)


def shard_comp_mix_block(x: torch.Tensor, q_self: torch.Tensor,
                         qs: torch.Tensor, w: torch.Tensor, M: torch.Tensor,
                         *, out: Optional[torch.Tensor] = None):
    """One node shard's compensated compressed round over its ``(m, D)``
    row-block: ``x + (M_r·qs − w⊙q_self)``, ``qs`` the ``(K, D)`` rebuilt
    halo estimates, ``q_self`` the shard's own, ``w = 1 − d`` its ``(m,
    1)`` rows.  ``out`` as in :func:`shard_mix_block`.  A CUDA ``x``
    launches ``shard_cmix.cu`` (counted in
    ``shard_comp_mix_block.launches``); a CPU ``x`` takes
    :func:`shard_comp_mix_block_plain`."""
    m, D = x.shape
    K = qs.shape[0]
    if q_self.shape != x.shape or qs.dim() != 2 or qs.shape[1] != D \
            or tuple(w.shape) != (m, 1) or tuple(M.shape) != (m, K):
        raise ValueError("shard_comp_mix_block: q_self must match x, qs be "
                         "(K, D), w (m, 1) and M (m, K)")
    dev = _check_operands("shard_comp_mix_block", x, [q_self, qs, w, M])
    _check_shard_out("shard_comp_mix_block", out, x, [x, q_self, qs])
    if dev.type == "cpu":
        o = shard_comp_mix_block_plain(x, q_self, qs, w, M)
        return o if out is None else out.copy_(o)
    o = torch.empty_like(x) if out is None else out
    block = _shard_block(K)
    err = cuda_build.entry("shard_cmix")(
        _ptr(x), _ptr(q_self), _ptr(qs), _ptr(w), _ptr(M), _ptr(o), D, m, K,
        block, _stream(dev))
    _check_launch(err, f"shard_cmix (m={m}, K={K}, D={D})")
    shard_comp_mix_block.launches += 1
    return o


shard_comp_mix_block.launches = 0


def compensated_apply(params: PyTree, q: PyTree, *, topology: str,
                      n_nodes: int, step: int = 0, n_pods: int = 1,
                      leaf_threshold: Optional[int] = None) -> PyTree:
    """The stacked apply of an overlapped gossip round, ``params + (M·q −
    (1 − d)⊙q)`` for the gossip round at ``step``: one
    :func:`shard_comp_mix_block` launch per dispatch group of ``params``
    (:func:`_dispatch_groups`), the whole node stack as one shard (m = K =
    n) with ``q_self = qs`` the group's columns of ``q``, into a fresh
    output.  ``q`` is the buffer of ``core.mixing.start_round``, in any
    dtype (upcast exactly to fp32).  The factors are those of
    ``core.mixing.compensated_round_factors``, made once per round kind on
    the device."""
    thresh = (LEAF_DISPATCH_THRESHOLD if leaf_threshold is None
              else leaf_threshold)
    leaves, treedef = tree_flatten(params)
    qleaves = tree_flatten(q)[0]
    n = n_nodes
    w, M = _device_compensated("gossip", topology, n, step, n_pods,
                               leaves[0].device)
    out_leaves: list = [None] * len(leaves)
    for group in _dispatch_groups(leaves, thresh):
        xf = _pack_rows([leaves[i] for i in group], n).contiguous()
        qf = _pack_rows([qleaves[i] for i in group], n).contiguous()
        o = shard_comp_mix_block(xf, qf, qf, w, M)
        del xf, qf
        off = 0
        for i in group:
            size = _leaf_size(leaves[i])
            out_leaves[i] = o[:, off:off + size].reshape(
                leaves[i].shape).to(leaves[i].dtype)
            off += size
    return tree_unflatten(treedef, out_leaves)

