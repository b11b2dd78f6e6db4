// Fused mixing round for Hopper (sm_90a): one pass over the packed
// node-major (n, D) parameter matrix.
//
// Replaces the TPU kernel `_mix_kernel` (src/repro/kernels/mixing_pallas.py,
// launched by `_mix_flat`).  Per column j, with rows i, k over the n nodes:
//
//   x'_k = x_k - gamma * g_k                     (optional half-step)
//   o_i  = d_i * x'_i + sum_k M_ik * wire(x'_k)  (wire: bf16 round trip, or
//                                                 the identity)
//   xbar = mean_i o_i, r = sum_i (o_i - xbar)^2  (optional consensus
//                                                 residual)
//
// What bounds it on the H100: bytes.  At n = 8 each column reads 8 (16 with
// g) floats and writes 8 (9 with xbar) and does about 2n flops per element,
// near 2 flops per byte, far below the ~20 flops per byte where fp32 FMA
// units, not HBM, become the limit.  So the design reads every input element
// once and writes every output element once, with neighbouring threads on
// neighbouring columns (coalesced 128-byte rows per warp per node row); the
// n x n mix runs out of shared memory, where each thread keeps its column.
//
// The TPU grid ran in order and carried the residual across grid steps in
// one scalar; GPU blocks run in any order, so each block writes its partial
// sum and `sum_partials` adds the partials in a fixed order (no atomics:
// the result is the same on every run).  gamma is read from device memory,
// so a step never waits on the host.  The ragged edge is masked, so no
// padding copy is made.  Every row of a global round uses the same weights
// in the same loop order, so its rows come out bitwise equal; the column
// mean halves pairwise, which is exact for equal rows when n is a power of
// two, so the residual after a global round is exactly 0.
//
// Products and sums use the _rn intrinsics so nvcc contracts nothing into an
// FMA: the half-step rounds exactly as the plain `x - gamma * g` does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 1024;

__device__ __forceinline__ float wire_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One thread per column.  Dynamic shared memory holds, per thread, the
// column's n half-stepped inputs (sx) and n outputs (so), laid out
// [row][thread] so that a warp touches 32 consecutive words.  `o` may alias
// `x` (the private staging buffer is consumed in place): a thread reads all
// of its column before it writes any of it, and no thread touches another's.
__global__ void mix_kernel(const float* x, const float* __restrict__ g,
                           const float* __restrict__ gamma,
                           const float* __restrict__ d,
                           const float* __restrict__ M, float* o,
                           float* __restrict__ xbar,
                           float* __restrict__ partial, int n, long long D,
                           int with_g, int wire, int with_residual) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxBlock];
  const int bd = blockDim.x;
  const int t = threadIdx.x;
  float* sx = smem;
  float* so = smem + n * bd;
  const long long j = static_cast<long long>(blockIdx.x) * bd + t;
  float r = 0.f;
  if (j < D) {
    const float gam = with_g ? gamma[0] : 0.f;
    for (int k = 0; k < n; ++k) {
      float v = x[k * D + j];
      if (with_g) v = __fsub_rn(v, __fmul_rn(gam, g[k * D + j]));
      sx[k * bd + t] = v;
    }
    for (int i = 0; i < n; ++i) {
      float acc = 0.f;
      for (int k = 0; k < n; ++k) {
        const float v = sx[k * bd + t];
        acc = __fadd_rn(acc, __fmul_rn(__ldg(M + i * n + k),
                                       wire ? wire_bf16(v) : v));
      }
      so[i * bd + t] = __fadd_rn(acc, __fmul_rn(__ldg(d + i), sx[i * bd + t]));
    }
    for (int i = 0; i < n; ++i) o[i * D + j] = so[i * bd + t];
    if (with_residual) {
      // sx is free now: halve pairwise, s[i] += s[m - h + i]
      for (int i = 0; i < n; ++i) sx[i * bd + t] = so[i * bd + t];
      for (int m = n; m > 1;) {
        const int h = m / 2;
        for (int i = 0; i < h; ++i)
          sx[i * bd + t] = __fadd_rn(sx[i * bd + t], sx[(m - h + i) * bd + t]);
        m -= h;
      }
      const float mean = __fdiv_rn(sx[t], static_cast<float>(n));
      xbar[j] = mean;
      for (int i = 0; i < n; ++i) {
        const float e = __fsub_rn(so[i * bd + t], mean);
        r = __fadd_rn(r, __fmul_rn(e, e));
      }
    }
  }
  if (with_residual) {  // uniform over the block
    red[t] = r;
    __syncthreads();
    for (int s = bd / 2; s > 0; s >>= 1) {
      if (t < s) red[t] = __fadd_rn(red[t], red[t + s]);
      __syncthreads();
    }
    if (t == 0) partial[blockIdx.x] = red[0];
  }
}

// One block adds the per-block partials in a fixed order.
__global__ void sum_partials(const float* __restrict__ partial,
                             long long count, float* __restrict__ out) {
  __shared__ float red[kMaxBlock];
  const int t = threadIdx.x;
  float s = 0.f;
  for (long long i = t; i < count; i += blockDim.x)
    s = __fadd_rn(s, partial[i]);
  red[t] = s;
  __syncthreads();
  for (int k = blockDim.x / 2; k > 0; k >>= 1) {
    if (t < k) red[t] = __fadd_rn(red[t], red[t + k]);
    __syncthreads();
  }
  if (t == 0) out[0] = red[0];
}

}  // namespace

// Plain C entry point (bound with ctypes).  `block` must be a power of two
// in [32, 1024]; the wrapper sizes `partial` as ceil(D / block) floats.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int repro_mix(const void* x, const void* g, const void* gamma,
                         const void* d, const void* M, void* o, void* xbar,
                         void* partial, void* resid, long long D, int n,
                         int with_g, int wire, int with_residual, int block,
                         void* stream) {
  if (n < 1 || D < 1 || block < 32 || block > kMaxBlock ||
      (block & (block - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2ull * n * block * sizeof(float);
  if (smem > 48u * 1024u) {
    const cudaError_t e = cudaFuncSetAttribute(
        mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = (D + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mix_kernel<<<static_cast<unsigned>(grid), block, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(gamma), static_cast<const float*>(d),
      static_cast<const float*>(M), static_cast<float*>(o),
      static_cast<float*>(xbar), static_cast<float*>(partial), n, D, with_g,
      wire, with_residual);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !with_residual) return static_cast<int>(e);
  sum_partials<<<1, kMaxBlock, 0, s>>>(static_cast<const float*>(partial),
                                       grid, static_cast<float*>(resid));
  return static_cast<int>(cudaGetLastError());
}
