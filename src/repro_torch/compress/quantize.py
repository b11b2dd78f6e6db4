"""Stochastic-rounding quantizers: int8 and fp8 (e4m3) with per-leaf,
per-node scales (counterpart of ``repro/compress/quantize.py``).

The element-wise math lives in small functions shared by the compressors
below, the plain twins of the kernels (``kernels/mixing_cuda.py``) and,
written out once more in CUDA, ``csrc/cmix.cu`` and ``csrc/collective.cu``:
every path makes the same rounding decision for the same inputs.

Rounding must match the reference bit for bit: ``floor(y/scale + u)``
with an IEEE division and one rounded add, or an int8 code moves by one
step (about absmax/127, which no tolerance covers).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.compress.base import (Compressor, LeafWire, column_bits,
                                       column_range, uniform_columns)

# fp8 e4m3fn: 3 mantissa bits, max finite 448.  Stochastic rounding keeps
# the top 3 fp32 mantissa bits after adding random low bits (the carry
# rounds up); _FP8_DROP fp32 mantissa bits are dropped.
FP8_MAX = 448.0
_FP8_DROP = 23 - 3
_FP8_MASK = (1 << _FP8_DROP) - 1
# the reference subtracts float32(log2(448)) in fp32
_LOG2_FP8_MAX = float(torch.tensor(math.log2(448.0), dtype=torch.float32))


def absmax_rows(y2: torch.Tensor) -> torch.Tensor:
    """(rows, 1) maxima of |y2| along the last axis (NaN where a row holds
    one)."""
    return torch.amax(torch.abs(y2), dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# int8: symmetric absmax scale, stochastic floor
# ---------------------------------------------------------------------------
def int8_scale(y2: torch.Tensor) -> torch.Tensor:
    """(rows, 1) per-row scale so codes land in [−127, 127]; an all-zero
    row maps to scale 1."""
    return int8_scale_of_max(absmax_rows(y2))


def int8_scale_of_max(m: torch.Tensor) -> torch.Tensor:
    """:func:`int8_scale` from the rows' maxima ``m`` = ``absmax_rows(y2)``
    (the compressed round's kernel computes them on the card)."""
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, one bit off the IEEE quotient
    return torch.where(m > 0, m / torch.full_like(m, 127.0),
                       torch.ones_like(m))


def int8_codes(y2: torch.Tensor, scale: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Stochastically rounded integer codes as fp32 in [−127, 127]."""
    return torch.clamp(torch.floor(y2 / scale + u), -127.0, 127.0)


def int8_dequant(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


@dataclasses.dataclass(frozen=True)
class Int8Compressor(Compressor):
    """8-bit stochastic quantization, per-(node, leaf) absmax scale."""
    name: str = "int8"
    lossy: bool = True

    def compress_leaf(self, y2, seed):
        cols = column_range(y2.shape[-1], y2.device)[None, :]
        scale = int8_scale(y2)
        codes = int8_codes(y2, scale, uniform_columns(seed, cols))
        return LeafWire(payload=(codes.to(torch.int8),), aux=(scale,))

    def decompress_leaf(self, wire, d):
        return int8_dequant(wire.payload[0], wire.aux[0])

    def wire_bytes(self, rows, d):
        return rows * d * 1 + rows * 4


# ---------------------------------------------------------------------------
# fp8 (e4m3): power-of-two scale, mantissa-bit stochastic rounding
# ---------------------------------------------------------------------------
def fp8_scale(y2: torch.Tensor) -> torch.Tensor:
    """(rows, 1) power-of-two scale with ``absmax/scale ≤ 448``."""
    return fp8_scale_of_max(absmax_rows(y2))


def fp8_scale_of_max(m: torch.Tensor) -> torch.Tensor:
    """:func:`fp8_scale` from the rows' maxima ``m`` = ``absmax_rows(y2)``."""
    e = torch.ceil(torch.log2(torch.clamp(m, min=1e-30)) - _LOG2_FP8_MAX)
    e = torch.clamp(e, -100.0, 100.0)
    return torch.where(m > 0, torch.exp2(e), torch.ones_like(m))


def fp8_codes(y2: torch.Tensor, scale: torch.Tensor,
              bits: torch.Tensor) -> torch.Tensor:
    """Stochastically rounded e4m3 codes (the fp8 tensor on the wire):
    add random low bits to the fp32 pattern, clear them (the carry rounds
    the magnitude up), clip, cast (exact for normals, round-to-nearest-even
    on the fp8 denormal tail).  The add is done on the int32 view: with
    |v| ≤ 448 it never overflows, so it equals the reference's uint32 add."""
    v = torch.clamp(y2 / scale, -FP8_MAX, FP8_MAX).contiguous()
    b = v.view(torch.int32)
    b = (b + (bits & _FP8_MASK).to(torch.int32)) & ~_FP8_MASK
    f = torch.clamp(b.view(torch.float32), -FP8_MAX, FP8_MAX)
    return f.to(torch.float8_e4m3fn)


def fp8_dequant(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


@dataclasses.dataclass(frozen=True)
class Fp8Compressor(Compressor):
    """fp8 (e4m3) stochastic quantization, per-(node, leaf) power-of-two
    scale."""
    name: str = "fp8"
    lossy: bool = True

    def compress_leaf(self, y2, seed):
        cols = column_range(y2.shape[-1], y2.device)[None, :]
        scale = fp8_scale(y2)
        codes = fp8_codes(y2, scale, column_bits(seed, cols))
        return LeafWire(payload=(codes,), aux=(scale,))

    def decompress_leaf(self, wire, d):
        return fp8_dequant(wire.payload[0], wire.aux[0])

    def wire_bytes(self, rows, d):
        return rows * d * 1 + rows * 4
