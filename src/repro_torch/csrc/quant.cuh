// Shared stochastic-rounding codec of the compressed kernels (cmix.cu,
// collective.cu): the counter hash, the int8 and fp8 (e4m3) codes and the
// power-of-two block scale, written to round exactly as the reference's
// element-wise math (src/repro/compress/{base,quantize,collective}.py) and
// the port's plain twins (src/repro_torch/compress/).
//
// Rounding: every division, product and sum goes through the _rn
// intrinsics, so nvcc contracts nothing into an FMA and no fast-math
// approximation applies (the sources are never built with
// --use_fast_math).  floor(y / scale + u) must round as the reference does,
// or an int8 code moves by one step, about absmax / 127.
//
// Denormals are kept (no flush to zero): XLA on the CPU flushes them, so a
// block whose absmax is itself a denormal gets scale 1 there and its own
// tiny scale here; the port's CPU tests pin this one divergence.

#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace repro {

constexpr float kFp8Max = 448.f;
constexpr uint32_t kFp8Mask = (1u << (23 - 3)) - 1u;  // dropped mantissa bits

// 32-bit avalanche (xorshift-multiply); native uint32 wraparound is the
// reference's uint32 arithmetic.
__device__ __forceinline__ uint32_t hash_u32(uint32_t h) {
  h = (h ^ (h >> 16)) * 0x7FEB352Du;
  h = (h ^ (h >> 15)) * 0x846CA68Bu;
  return h ^ (h >> 16);
}

// Random bits of an absolute column: the same on every node.
__device__ __forceinline__ uint32_t column_bits(uint32_t seed, uint32_t col) {
  return hash_u32(col ^ seed);
}

// U[0, 1) from the top 24 bits (exact in fp32).
__device__ __forceinline__ float uniform_of(uint32_t bits) {
  return __fmul_rn(static_cast<float>(bits >> 8), 5.9604644775390625e-08f);
}

__device__ __forceinline__ float clip(float v, float lim) {
  return fminf(fmaxf(v, -lim), lim);
}

// int8: codes clip(floor(y / scale + u), -127, 127), dequantized.
__device__ __forceinline__ float int8_q(float y, float scale, float u) {
  const float c = clip(floorf(__fadd_rn(__fdiv_rn(y, scale), u)), 127.f);
  return __fmul_rn(c, scale);
}

// fp8 e4m3: add random low mantissa bits, clear them (the carry rounds the
// magnitude up), clip, cast with round-to-nearest-even (which only acts on
// the fp8 denormal tail), dequantize.  |v| <= 448 keeps the add inside the
// exponent field.
__device__ __forceinline__ float fp8_q(float y, float scale, uint32_t bits) {
  const float v = clip(__fdiv_rn(y, scale), kFp8Max);
  const uint32_t b = (__float_as_uint(v) + (bits & kFp8Mask)) & ~kFp8Mask;
  const float f = clip(__uint_as_float(b), kFp8Max);
  const __nv_fp8_storage_t s = __nv_cvt_float_to_fp8(f, __NV_SATFINITE,
                                                     __NV_E4M3);
  const __half h(__nv_cvt_fp8_to_halfraw(s, __NV_E4M3));
  return __fmul_rn(__half2float(h), scale);
}

// Power-of-two scale 2^(ceil(log2 m) - shift) from m's exponent bits,
// biased exponent clipped to [1, 254]; m = 0 maps to 1.
__device__ __forceinline__ float pow2_scale(float m, int shift) {
  if (!(m > 0.f)) return 1.f;
  const uint32_t bits = __float_as_uint(m);
  int e = static_cast<int>((bits >> 23) & 0xFFu);
  e += (bits & 0x7FFFFFu) != 0u;
  e = min(max(e - shift, 1), 254);
  return __uint_as_float(static_cast<uint32_t>(e) << 23);
}

__device__ __forceinline__ float warp_max(float m) {
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

}  // namespace repro
