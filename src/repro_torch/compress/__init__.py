"""Compressor registry and wire-bytes cost model (counterpart of
``repro/compress/__init__.py``).

``make_compressor`` resolves ``DistConfig.comm_compression`` into a
:class:`Compressor` (or None for the uncompressed path);
``round_wire_bytes`` is the analytic bytes-on-wire model of one round.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.compress.base import (Compressor, LeafWire, apply_tree,
                                       column_bits, compress_tree,
                                       decompress_tree, hash_u32,
                                       init_ef_state, leaf_seed,
                                       tree_wire_bytes, uniform_columns)
from repro_torch.compress.collective import (COLLECTIVE_COMPRESSORS, QBLOCK,
                                             collective_wire_bytes)
from repro_torch.compress.quantize import Fp8Compressor, Int8Compressor
from repro_torch.compress.sparsify import RandKCompressor, TopKCompressor

__all__ = [
    "COLLECTIVE_COMPRESSORS", "COMPRESSORS", "Compressor", "LeafWire",
    "apply_tree", "collective_wire_bytes", "column_bits", "compress_tree",
    "decompress_tree", "hash_u32", "init_ef_state", "leaf_seed",
    "make_compressor", "round_wire_bytes", "tree_wire_bytes",
    "uniform_columns",
]

# "none": no compressor object.  "identity": a registry entry whose round
# is routed to the exact uncompressed path.
COMPRESSORS = ("none", "identity", "int8", "fp8", "topk", "randk")


def make_compressor(name: str, k: int = 32) -> Optional[Compressor]:
    """Resolve a ``DistConfig.comm_compression`` name (``k`` feeds the
    sparsifiers)."""
    if name == "none":
        return None
    if name == "identity":
        return Compressor()
    if name == "int8":
        return Int8Compressor()
    if name == "fp8":
        return Fp8Compressor()
    if name == "topk":
        return TopKCompressor(k=k)
    if name == "randk":
        return RandKCompressor(k=k)
    raise ValueError(f"unknown comm_compression {name!r} "
                     f"(expected one of {COMPRESSORS})")


def round_wire_bytes(phase: str, topology: str, n_nodes: int,
                     per_node_params: int, *, comm_dtype: str = "float32",
                     compression: str = "none", k: int = 32,
                     step: int = 0, n_pods: int = 1,
                     leaf_sizes=None, global_compression: str = "none",
                     model_shards: int = 1) -> int:
    """Per-node bytes crossing the interconnect for one round, as the
    reference models them on one device per node: gossip counts one
    payload per nonzero off-diagonal shift; global/pod_avg one operand's
    worth (the compressed collective's codes + exponent bytes when
    ``global_compression`` is lossy); a lossy gossip compressor on pod_avg
    reaches the other ``n/n_pods − 1`` pod members.  Sparsifier ``k`` and
    quantizer scales are per leaf, hence ``leaf_sizes``.

    ``model_shards`` (the model axis of a 2-D ``(node, model)`` mesh)
    makes the answer per device: the packed columns and the quantizers'
    code arrays slice over the model axis, each leaf padded to the model
    grid (hence the per-leaf ceil); the quantizers' per-row scale words
    and the sparsifiers' payloads ride whole; the compressed collective
    moves whole ``QBLOCK`` blocks per model slice."""
    from repro_torch.core import topology as topo

    elem = 2 if comm_dtype == "bfloat16" else 4
    comp = make_compressor(compression, k=k)
    lossy = comp is not None and comp.lossy
    quant = lossy and comp.name in ("int8", "fp8")
    ms = max(int(model_shards), 1)
    sizes = list(leaf_sizes) if leaf_sizes else [per_node_params]
    dense_cols = sum(-(-d // ms) for d in sizes)
    # a sparsifier's round runs model-replicated end to end: its global
    # phase's operand stays full width per device
    psum_cols = sum(sizes) if (lossy and not quant) else dense_cols
    payload = None
    if lossy:
        if quant and ms > 1:
            # code bytes slice; the per-row scale word stays whole
            payload = sum(-(-d // ms)
                          + int(comp.wire_bytes_per_send(1, d)) - d
                          for d in sizes)
        else:
            payload = sum(int(comp.wire_bytes_per_send(1, d))
                          for d in sizes)
    if phase in ("global", "pod_avg") and global_compression in ("int8",
                                                                 "fp8"):
        nb = -(-per_node_params // QBLOCK)
        return -(-nb // ms) * (QBLOCK + 1)
    if phase == "global":
        return psum_cols * elem
    if phase == "pod_avg":
        if not lossy:
            return dense_cols * elem
        return (max(n_nodes // max(n_pods, 1), 1) - 1) * payload
    if phase != "gossip" or topology == "disconnected" or n_nodes == 1:
        return 0
    if topology == "grid":
        shifts = sum(1 for s in topo.grid_shift_weights(n_nodes)
                     if s != (0, 0))
        elem = 4  # grid gossip ignores comm_dtype
    else:
        shifts = sum(1 for s in topo.shift_weights(topology, n_nodes, step)
                     if s != 0)
    return shifts * (payload if lossy else dense_cols * elem)
