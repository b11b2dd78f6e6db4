"""Compressed-gossip wire protocol, shared randomness and error-feedback
algebra (counterpart of ``repro/compress/base.py``).

A ``Compressor`` maps a node-stacked value to a compact wire
representation (``LeafWire``) and back; the mixing layer
(``core/mixing.py``) applies the round in the self-compensated form

    mixed = x + (M · q − (1 − d) ⊙ q),      q = decompress(compress(x + e))

so the node's own state never loses precision and, because every node
draws the *same* per-step random bits (:func:`uniform_columns`), a
constant state is an exact fixed point of the round.

Error feedback: ``y = x + e``, ``wire = compress(y)``, ``e' = y −
decompress(wire)``; the residual lives in ``TrainState.extras["ef_state"]``.

**The counter hash without uint32 shifts.**  This PyTorch raises on
``>>`` for ``torch.uint32``, so :func:`hash_u32` works on int64 tensors
holding values in [0, 2³²) and masks with ``& 0xFFFFFFFF`` after every
step.  A product of two 32-bit values needs up to 64 bits and would
overflow int64's sign bit, so the multiply is split into 16-bit halves of
the constant: ``h·c mod 2³² = (h·c_lo + ((h·c_hi) mod 2¹⁶)·2¹⁶) mod 2³²``,
each partial product below 2⁴⁸.  No step relies on wraparound.  Python
ints (the host-side seed path) use the same formula.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


class LeafWire(NamedTuple):
    """Wire representation of one compressed leaf row-block: ``payload``
    the bulk bytes (int8/fp8 codes, top-k values), ``aux`` the per-row
    metadata (scales, indices)."""
    payload: Tuple[torch.Tensor, ...]
    aux: Tuple[torch.Tensor, ...]

    @property
    def nbytes(self) -> int:
        """Total bytes-on-wire of this leaf (payload + aux)."""
        return int(sum(a.numel() * a.element_size()
                       for a in tuple(self.payload) + tuple(self.aux)))


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base compressor (identity): subclasses override the leaf codec.
    ``lossy = False`` routes ``mixing.communicate`` to the exact
    uncompressed path."""
    name: str = "identity"
    lossy: bool = False

    def compress_leaf(self, y2: torch.Tensor, seed) -> LeafWire:
        """``y2``: (rows, D) fp32; ``seed``: uint32 (already salted per
        leaf).  Identity sends the values verbatim."""
        return LeafWire(payload=(y2,), aux=())

    def decompress_leaf(self, wire: LeafWire, d: int) -> torch.Tensor:
        return wire.payload[0]

    def wire_bytes(self, rows: int, d: int) -> int:
        return rows * d * 4

    def wire_bytes_per_send(self, rows: int, d: int) -> int:
        return self.wire_bytes(rows, d)

    def compress(self, y2: torch.Tensor, state: Optional[torch.Tensor],
                 seed) -> Tuple[LeafWire, Optional[torch.Tensor]]:
        """EF-aware leaf compression: feeds the residual ``state`` into the
        wire input and returns the updated residual (``state=None``: no
        error feedback)."""
        y = y2 if state is None else y2 + state
        wire = self.compress_leaf(y, seed)
        if state is None:
            return wire, None
        q = self.decompress_leaf(wire, y2.shape[-1])
        return wire, y - q


# ---------------------------------------------------------------------------
# Shared randomness: one counter hash, identical on every node and in both
# the plain twins and the CUDA kernels (which use native uint32).
# ---------------------------------------------------------------------------
def _mul32(h, c: int):
    """``h · c mod 2³²`` for ``h`` in [0, 2³²) without int64 overflow."""
    lo = (h * (c & 0xFFFF)) & _MASK32
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash_u32(h):
    """32-bit avalanche (xorshift-multiply).  ``h``: a Python int or an
    int64 tensor of values in [0, 2³²); returns the same kind."""
    h = h & _MASK32
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    return h ^ (h >> 16)


def leaf_seed(seed, salt: int):
    """Per-leaf seed: fold the round seed with a static per-leaf salt
    (leaves are visited in sorted-key order, as the reference's
    ``jax.tree`` order).  An int seed gives an int: the kernels take it by
    value, so no round copies a seed to the device."""
    s = int(seed) & _MASK32 if not torch.is_tensor(seed) else (
        seed.to(torch.int64) & _MASK32)
    return hash_u32((s + (((salt + 1) * _GOLDEN) & _MASK32)) & _MASK32)


def column_bits(seed, cols: torch.Tensor) -> torch.Tensor:
    """uint32 random bits (as int64) per column index, independent of the
    node: every node rounds the same way."""
    return hash_u32(cols.to(torch.int64) ^ seed)


def uniform_columns(seed, cols: torch.Tensor) -> torch.Tensor:
    """U[0, 1) from the top 24 bits of :func:`column_bits` (fp32-exact)."""
    return (column_bits(seed, cols) >> 8).to(torch.float32) * (2.0 ** -24)


def column_range(d: int, device, col0: int = 0) -> torch.Tensor:
    """Absolute column indices ``col0 … col0 + d − 1`` as int64."""
    return torch.arange(col0, col0 + d, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# Pytree plumbing
# ---------------------------------------------------------------------------
def _rows_view(leaf: torch.Tensor) -> torch.Tensor:
    return leaf.reshape(leaf.shape[0], -1).to(torch.float32)


def compress_tree(comp: Compressor, x: PyTree, ef: Optional[PyTree], seed):
    """``(wires, new_ef)``: per-leaf ``LeafWire`` in sorted-key leaf order
    (the order fixes each leaf's salt) and the updated EF tree (None when
    ``ef`` is None)."""
    leaves, treedef = tree_flatten(x)
    ef_leaves = (tree_flatten(ef)[0] if ef is not None
                 else [None] * len(leaves))
    wires, new_ef = [], []
    for i, (leaf, e) in enumerate(zip(leaves, ef_leaves)):
        e2 = None if e is None else _rows_view(e)
        wire, e_new = comp.compress(_rows_view(leaf), e2, leaf_seed(seed, i))
        wires.append(wire)
        if e is not None:
            new_ef.append(e_new.reshape(e.shape).to(e.dtype))
    return wires, (tree_unflatten(treedef, new_ef) if ef is not None
                   else None)


def decompress_tree(comp: Compressor, wires, like: PyTree) -> PyTree:
    """Per-leaf ``(rows, D)`` estimates from the wires."""
    leaves, treedef = tree_flatten(like)
    return tree_unflatten(treedef, [
        comp.decompress_leaf(w, lf[0].numel())
        for w, lf in zip(wires, leaves)])


def apply_tree(comp: Compressor, x: PyTree, ef: Optional[PyTree], seed):
    """``(q, new_ef)``: the decompressed wire estimate of ``x (+ ef)``,
    leaves in their stacked shapes, fp32."""
    wires, new_ef = compress_tree(comp, x, ef, seed)
    q2 = tree_flatten(decompress_tree(comp, wires, x))[0]
    leaves, treedef = tree_flatten(x)
    return tree_unflatten(treedef, [q.reshape(lf.shape)
                                    for lf, q in zip(leaves, q2)]), new_ef


def init_ef_state(params: PyTree) -> PyTree:
    """Zero per-node error-feedback memory, fp32 whatever the params'
    dtype (the residual must not re-quantize)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def tree_wire_bytes(comp: Compressor, x: PyTree) -> int:
    """Analytic bytes-on-wire for one compressed broadcast of ``x``."""
    return sum(comp.wire_bytes(lf.shape[0], lf[0].numel())
               for lf in tree_flatten(x)[0])
