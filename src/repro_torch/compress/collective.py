"""Compressed global/pod-averaging collective, reference math
(counterpart of ``repro/compress/collective.py``).

On the packed ``(n, D)`` node-major matrix, per ``QBLOCK``-column block:

    q₁ = Q₁(x + e)                         stage 1, per-(row, block) scale
    m̄_p = q₁[p,0] + mean_r(q₁[p,r] − q₁[p,0])   anchored pod mean
    o  = x + (Q₂(m̄)[pod] − Q₂(q₁)),  e' = (x + e) − q₁

Scales are powers of two computed by exponent bit operations
(:func:`pow2_block_scale`), so every codec op is exact or one IEEE-rounded
add: equal inputs give equal codes on every path, the anchored mean of a
consensus block is the block itself, and a constant state is a bitwise
fixed point.  The fused kernel (``csrc/collective.cu``) is tested against
:func:`collective_round` through the plain twin in ``kernels/mixing_cuda``.

The pod mean sums ``q₁[p,r] − q₁[p,0]`` over r = 0 … per−1 in that order
and divides by ``per``: the kernel sums in the same order, because the
stage-2 rounding decision depends on the exact bits of m̄.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.compress import quantize as cq
from repro_torch.compress.base import (column_bits, column_range, hash_u32,
                                       leaf_seed, uniform_columns)

QBLOCK = 1024
COLLECTIVE_COMPRESSORS = ("none", "identity", "int8", "fp8")
KINDS = ("int8", "fp8")
# stage shift of pow2_block_scale per kind: int8 codes in (−128, 128],
# fp8 operands within e4m3 range
SHIFTS = {"int8": 7, "fp8": 8}

_STAGE2 = 0x9E3779B9
# blocks per pass of quantize_blocks (16,777,216 columns at QBLOCK)
CHUNK_BLOCKS = 1 << 14


def stage_seeds(seed, salt: int = 0) -> Tuple[int, int]:
    """Decorrelated uint32 seeds of the two quantization stages."""
    s1 = leaf_seed(seed, salt)
    return s1, hash_u32(s1 ^ _STAGE2)


def pad_cols(x2: Optional[torch.Tensor], mult: int) -> Optional[torch.Tensor]:
    """Zero-pad the column axis to a multiple of ``mult`` (zero columns
    quantize to zero codes at every stage)."""
    if x2 is None:
        return None
    pad = (-x2.shape[1]) % mult
    return torch.nn.functional.pad(x2, (0, pad)) if pad else x2


def pow2_block_scale(y2b: torch.Tensor, shift: int) -> torch.Tensor:
    """Per-(row, block) scale ``2^(ceil(log2 absmax) − shift)`` by exponent
    bit operations on the last axis' absmax; all-zero blocks map to 1."""
    m = torch.amax(torch.abs(y2b), dim=-1, keepdim=True).contiguous()
    bits = m.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    e = (bits >> 23) & 0xFF
    e = e + ((bits & 0x7FFFFF) != 0).to(torch.int64)     # ceil to next pow2
    sbits = (torch.clamp(e - shift, 1, 254) << 23).to(torch.int32)
    return torch.where(m > 0, sbits.view(torch.float32), torch.ones_like(m))


def scale_exponents(scales: torch.Tensor) -> torch.Tensor:
    """Power-of-two fp32 scales → one uint8 biased exponent each."""
    bits = scales.to(torch.float32).contiguous().view(torch.int32)
    return (bits >> 23).to(torch.uint8)


def exponent_scales(exps: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`scale_exponents`."""
    return (exps.to(torch.int32) << 23).view(torch.float32)


def quantize_blocks(y2: torch.Tensor, kind: str, seed,
                    qblock: int = QBLOCK, col0: int = 0):
    """Blockwise stochastic quantization of a ``(rows, Dp)`` fp32 matrix
    (``Dp`` a multiple of ``qblock``): ``(codes, scales, q)``.  Runs over
    :data:`CHUNK_BLOCKS` blocks at a time: every op is per element or per
    block, so the chunks give the one-pass bits while the column hash's
    int64 temporaries stay a chunk wide (at 138M columns one pass held
    about 5 GB of them, whatever the row count)."""
    if kind not in KINDS:
        raise ValueError(f"collective.quantize_blocks: unsupported kind "
                         f"{kind!r} (expected one of {KINDS})")
    rows, Dp = y2.shape
    if Dp % qblock:
        raise ValueError(f"collective.quantize_blocks: {Dp} columns not a "
                         f"multiple of qblock={qblock} (pad_cols first)")
    nb = Dp // qblock
    yb = y2.reshape(rows, nb, qblock)
    wire = q = None
    scale = torch.empty((rows, nb, 1), dtype=torch.float32, device=y2.device)
    for b0 in range(0, nb, CHUNK_BLOCKS):
        b1 = min(nb, b0 + CHUNK_BLOCKS)
        ybc = yb[:, b0:b1]
        cols = column_range((b1 - b0) * qblock, y2.device,
                            col0 + b0 * qblock).reshape(1, b1 - b0, qblock)
        sc = pow2_block_scale(ybc, SHIFTS[kind])
        if kind == "int8":
            codes = cq.int8_codes(ybc, sc, uniform_columns(seed, cols))
            qc = cq.int8_dequant(codes, sc)
            codes = codes.to(torch.int8)
        else:
            codes = cq.fp8_codes(ybc, sc, column_bits(seed, cols))
            qc = cq.fp8_dequant(codes, sc)
        if wire is None:
            wire = torch.empty((rows, nb, qblock), dtype=codes.dtype,
                               device=y2.device)
            q = torch.empty((rows, nb, qblock), dtype=qc.dtype,
                            device=y2.device)
        wire[:, b0:b1] = codes
        q[:, b0:b1] = qc
        scale[:, b0:b1] = sc
        del codes, qc, cols, sc
    return (wire.reshape(rows, Dp), scale.reshape(rows, nb),
            q.reshape(rows, Dp))


def dequant_blocks(codes: torch.Tensor, scales: torch.Tensor,
                   qblock: int = QBLOCK) -> torch.Tensor:
    rows, Dp = codes.shape
    nb = Dp // qblock
    return (codes.to(torch.float32).reshape(rows, nb, qblock)
            * scales.reshape(rows, nb, 1)).reshape(rows, Dp)


def anchored_mean(q1: torch.Tensor, n_pods: int = 1) -> torch.Tensor:
    """``m̄_p = q_{p,0} + (Σ_r (q_{p,r} − q_{p,0})) / per`` over the
    ``(n, Dp)`` stage-1 estimates → ``(n_pods, Dp)``, summed in row order."""
    n, Dp = q1.shape
    per = n // n_pods
    qp = q1.reshape(n_pods, per, Dp)
    anchor = qp[:, 0]
    s = torch.zeros_like(anchor)
    for r in range(per):
        s = s + (qp[:, r] - anchor)
    return anchor + s / torch.full_like(anchor[:, :1], float(per))


def collective_mean(y2: torch.Tensor, kind: str, seed, *, n_pods: int = 1,
                    qblock: int = QBLOCK):
    """Two-stage compressed mean of a ``(n, D)`` operand: ``(r, rho, q1)``
    trimmed to ``D`` columns, ``r`` expanded to one row per node."""
    r, rho, q1 = _two_stage(y2, kind, *stage_seeds(seed), n_pods=n_pods,
                            qblock=qblock)
    return r.repeat_interleave(y2.shape[0] // n_pods, dim=0), rho, q1


def _two_stage(y2, kind, s1, s2, *, n_pods, qblock):
    D = y2.shape[1]
    _, _, q1 = quantize_blocks(pad_cols(y2, qblock), kind, s1, qblock)
    _, _, r = quantize_blocks(anchored_mean(q1, n_pods), kind, s2, qblock)
    _, _, rho = quantize_blocks(q1, kind, s2, qblock)
    return r[:, :D], rho[:, :D], q1[:, :D]


def collective_round_seeds(x2: torch.Tensor, e2: Optional[torch.Tensor],
                           kind: str, s1: int, s2: int, *, n_pods: int = 1,
                           qblock: int = QBLOCK):
    """:func:`collective_round` from the two stage seeds: the plain twin of
    the fused kernel, which takes the seeds as arguments."""
    y2 = x2 if e2 is None else x2 + e2
    r, rho, q1 = _two_stage(y2, kind, s1, s2, n_pods=n_pods, qblock=qblock)
    n, D = x2.shape
    per = n // n_pods
    # each pod's row of r broadcast over its members, without a copy of r
    mixed = (x2.reshape(n_pods, per, D)
             + (r[:, None] - rho.reshape(n_pods, per, D))).reshape(n, D)
    return mixed, (None if e2 is None else y2 - q1)


def collective_round(x2: torch.Tensor, e2: Optional[torch.Tensor], kind: str,
                     seed, *, n_pods: int = 1, qblock: int = QBLOCK):
    """One compensated compressed-averaging round on the packed block:
    ``(x + (r − ρ), (x + e) − q₁)`` (the second None without ``e2``)."""
    return collective_round_seeds(x2, e2, kind, *stage_seeds(seed),
                                  n_pods=n_pods, qblock=qblock)


def collective_wire_bytes(kind: str, d: int, qblock: int = QBLOCK) -> int:
    """Per-node bytes on the wire of one compressed-collective round:
    codes + one uint8 exponent per block."""
    if kind not in KINDS:
        raise ValueError(f"collective_wire_bytes: unsupported kind {kind!r}")
    nb = -(-d // qblock)
    return nb * qblock * 1 + nb * 1
