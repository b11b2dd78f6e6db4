"""Fused mixing round on the packed node-major ``(n, D)`` matrix — the
port of ``repro/kernels/mixing_pallas.py`` (stacked entry points).

The whole communication round (optional SGD half-step, the mix
``o = d ⊙ x + M · wire(x)``, optional consensus residual) is one pass of
the hand-written CUDA kernel in ``repro_torch/csrc/mix.cu``, which replaces
the TPU kernel ``_mix_kernel`` (``mixing_pallas.py``, launched by
``_mix_flat``).  :func:`mix_flat` is the kernel's wrapper: a CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain PyTorch twin
:func:`mix_flat_plain`, which is also the kernel's oracle on the card.

The kernel is built on first use with ``nvcc`` into a shared library with
a plain C interface (``src/repro_torch/_build/``, listed in .gitignore)
and bound with ``ctypes``; importing this module builds nothing.

Leaves below ``leaf_threshold`` per-node elements are concatenated into one
private staging buffer, which the kernel consumes in place (the TPU's
``input_output_aliases``); larger leaves are mixed straight from
``leaf.reshape(n, -1)`` into a fresh output, never touching the caller's
tensor.  Wire semantics match the reference: gossip casts only the
neighbour (M) term to bf16, averaging rounds cast everything (d = 0), and
the grid topology ignores ``comm_dtype``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.tree import tree_flatten, tree_unflatten

PyTree = Any

KERNEL_PHASES = ("gossip", "global", "pod_avg")
LEAF_DISPATCH_THRESHOLD = 262_144

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "mix.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# dynamic shared memory a block may opt into on the H100: 227 KB less the
# kernel's 4 KB static reduction buffer
_MAX_SMEM = 232_448 - 4_096


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
    host-to-device copy every round would wait for the stream."""
    d, M = phase_matrices(phase, topology, n, step=step, n_pods=n_pods)
    return torch.from_numpy(d).to(device), torch.from_numpy(M).to(device)


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


def _dispatch_groups(leaves, threshold: int):
    """Leaf indices per kernel launch: one group of every leaf below
    ``threshold`` per-node elements (the staging buffer), plus one group
    per large leaf."""
    sizes = [_leaf_size(lf) for lf in leaves]
    small = [i for i, s in enumerate(sizes) if s < threshold]
    big = [i for i, s in enumerate(sizes) if s >= threshold]
    groups = [small] if small else []
    return groups + [[i] for i in big]


# ---------------------------------------------------------------------------
# Build and bind the CUDA kernel
# ---------------------------------------------------------------------------
class _Lib:
    """The loaded kernel library (built at most once per process)."""
    handle: Optional[ctypes.CDLL] = None
    build_seconds: float = 0.0
    build_log: str = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME); "
                           "the mixing kernel is built on first use")
    return found


def build() -> ctypes.CDLL:
    """Compile ``csrc/mix.cu`` (once; the library is named by the source's
    hash) and load it.  ``_Lib.build_log`` keeps nvcc's ``-Xptxas -v``
    report."""
    if _Lib.handle is not None:
        return _Lib.handle
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libmix_{tag[:12]}.so"
    if not lib_path.exists():
        t0 = time.perf_counter()
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True)
        _Lib.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"repro_torch: nvcc failed on {SOURCE}:\n"
                               f"{_Lib.build_log}")
        os.replace(tmp, lib_path)
        _Lib.build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_mix.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.repro_mix.restype = ctypes.c_int
    _Lib.handle = lib
    return lib


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


def _launch(xf, gf, gamma, d, M, *, with_g, with_residual, wire, inplace):
    lib = build()
    n, D = xf.shape
    o = xf if inplace else torch.empty_like(xf)
    block = _block_size(n)
    dev = xf.device
    xbar = partial = resid = None
    if with_residual:
        xbar = torch.empty((1, D), dtype=torch.float32, device=dev)
        partial = torch.empty(((D + block - 1) // block,),
                              dtype=torch.float32, device=dev)
        resid = torch.empty((), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_mix(ptr(xf), ptr(gf), ptr(gamma), ptr(d), ptr(M),
                        ptr(o), ptr(xbar), ptr(partial), ptr(resid),
                        D, n, int(with_g), int(wire), int(with_residual),
                        block, stream)
    if err != 0:
        raise RuntimeError(f"repro_torch: mix kernel launch failed with "
                           f"cudaError {err} (n={n}, D={D}, block={block})")
    return (o, xbar, resid) if with_residual else o


# ---------------------------------------------------------------------------
# The wrapper and its plain twin
# ---------------------------------------------------------------------------
def _pairwise_mean(o: torch.Tensor) -> torch.Tensor:
    """Column mean, halving pairwise (``s[i] += s[m − h + i]``) exactly as
    the kernel does: exact for equal rows when n is a power of two."""
    s, m = o, o.shape[0]
    while m > 1:
        h = m // 2
        s = torch.cat([s[:h] + s[m - h:m], s[h:m - h]])
        m -= h
    return s[:1] / o.shape[0]


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
    xbar = _pairwise_mean(o)
    return o, xbar, torch.sum(torch.square(o - xbar))


def mix_flat(xf: torch.Tensor, gf: Optional[torch.Tensor],
             gamma: Optional[torch.Tensor], d: torch.Tensor,
             M: torch.Tensor, *, with_g: bool, with_residual: bool,
             wire: bool, inplace: bool = False):
    """Run the fused round over an already-packed ``(n, D)`` fp32 matrix.

    Returns ``o`` or, with ``with_residual``, ``(o, xbar (1, D),
    residual)``.  A CUDA ``xf`` launches the kernel (counted in
    ``mix_flat.launches``); a CPU ``xf`` takes :func:`mix_flat_plain`.
    ``inplace`` lets the kernel write ``o`` into ``xf``: only for a private
    staging buffer that nobody reads again.
    """
    n = xf.shape[0]
    if xf.dim() != 2 or xf.dtype != torch.float32:
        raise ValueError(f"mix_flat: x must be (n, D) float32, got "
                         f"{tuple(xf.shape)} {xf.dtype}")
    if tuple(d.shape) != (n, 1) or tuple(M.shape) != (n, n):
        raise ValueError("mix_flat: d must be (n, 1) and M (n, n)")
    operands = [xf, d, M] + ([gf, gamma] if with_g else [])
    if with_g and (gf.shape != xf.shape or gamma.numel() != 1):
        raise ValueError("mix_flat: g must match x and gamma be one value")
    if any(t.dtype != torch.float32 for t in operands):
        raise ValueError("mix_flat: every operand must be float32")
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"mix_flat: operands on several devices {devices}")
    dev = xf.device
    if dev.type == "cpu":
        return mix_flat_plain(xf, gf, gamma, d, M, with_g=with_g,
                              with_residual=with_residual, wire=wire)
    if dev.type != "cuda":
        raise ValueError(f"mix_flat: unsupported device {dev}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("mix_flat: operands must be contiguous")
    if xf.shape[1] == 0:
        raise ValueError("mix_flat: empty parameter matrix")
    out = _launch(xf, gf, gamma, d, M, with_g=with_g,
                  with_residual=with_residual, wire=wire, inplace=inplace)
    mix_flat.launches += 1
    return out


mix_flat.launches = 0


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
    thresh = (LEAF_DISPATCH_THRESHOLD if leaf_threshold is None
              else leaf_threshold)
    leaves, treedef = tree_flatten(params)
    n = leaves[0].shape[0]
    dev = leaves[0].device
    d, M = _device_factors(phase, topology, n_nodes, step, n_pods, dev)
    wire = (comm_dtype is not None
            and not (phase == "gossip" and topology == "grid"))
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
