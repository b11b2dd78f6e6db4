"""Sparsifying compressors: top-k (per-node magnitude selection) and
rand-k (shared random column subset) (counterpart of
``repro/compress/sparsify.py``).

Selections are data-dependent gathers, so the fused kernel takes their
dense estimate ``q`` precomputed (``cmix``'s ``"precomputed"`` kind).

Ties: ``jax.lax.top_k`` keeps the lower index among equal values, and
``torch.topk`` promises no order.  Both selections here take the first
``k`` of a *stable* descending sort, which breaks ties by the lower index
exactly as the reference does, so identical rows select identical
columns.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.compress.base import (Compressor, LeafWire, column_range,
                                       uniform_columns)


def top_k_indices(v: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, ties by
    the lower index (``jax.lax.top_k``'s order)."""
    return torch.sort(v, dim=-1, descending=True, stable=True)[1][..., :k]


def _scatter_rows(vals: torch.Tensor, idx: torch.Tensor,
                  d: int) -> torch.Tensor:
    """(rows, k) values + column indices ((rows, k) or (1, k)) → dense
    (rows, d) with zeros."""
    rows = vals.shape[0]
    out = torch.zeros((rows, d), dtype=torch.float32, device=vals.device)
    return out.scatter_(1, idx.expand(vals.shape).to(torch.int64),
                        vals.to(torch.float32))


@dataclasses.dataclass(frozen=True)
class TopKCompressor(Compressor):
    """Keep each node's k largest-magnitude elements per leaf.
    Wire: k fp32 values + k int32 column indices per row."""
    name: str = "topk"
    lossy: bool = True
    k: int = 32

    def _k(self, d: int) -> int:
        return max(1, min(self.k, d))

    def compress_leaf(self, y2, seed):
        idx = top_k_indices(torch.abs(y2), self._k(y2.shape[-1]))
        vals = torch.gather(y2, -1, idx)
        return LeafWire(payload=(vals,), aux=(idx.to(torch.int32),))

    def decompress_leaf(self, wire, d):
        return _scatter_rows(wire.payload[0], wire.aux[0], d)

    def wire_bytes(self, rows, d):
        return rows * self._k(d) * (4 + 4)


@dataclasses.dataclass(frozen=True)
class RandKCompressor(Compressor):
    """Keep a shared random subset of k columns per leaf, redrawn each
    step from the round seed (the k smallest hashed uniforms)."""
    name: str = "randk"
    lossy: bool = True
    k: int = 32

    def _k(self, d: int) -> int:
        return max(1, min(self.k, d))

    def _columns(self, seed, d: int, device) -> torch.Tensor:
        u = uniform_columns(seed, column_range(d, device))
        return top_k_indices(-u, self._k(d)).to(torch.int32)

    def compress_leaf(self, y2, seed):
        idx = self._columns(seed, y2.shape[-1], y2.device)
        vals = y2[:, idx.to(torch.int64)]
        return LeafWire(payload=(vals,), aux=(idx[None, :],))

    def decompress_leaf(self, wire, d):
        return _scatter_rows(wire.payload[0], wire.aux[0], d)

    def wire_bytes(self, rows, d):
        return rows * self._k(d) * 4 + self._k(d) * 4

    def wire_bytes_per_send(self, rows, d):
        return rows * self._k(d) * 4
