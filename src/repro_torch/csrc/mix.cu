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
//
// Two instances of the round, picked by the wrapper's rule
// (kernels/mixing_cuda.py `use_vector_mix`):
//
// * `mix_vector_kernel`, for n in {4, 8, 16, 32}, D a multiple of the
//   vector width and 16-byte aligned pointers.  Timing variants of the
//   generic kernel on the H100 showed what held it well above its bound:
//   not the n dependent chains of the mix, but the column's round trips
//   through shared memory (the residual's halving among them), the n^2
//   loads of M from inside the i-k loop, and 4-byte accesses from loops
//   that cannot unroll (PERF.md).  So n is a template parameter,
//   every loop unrolls, and a thread holds VEC adjacent columns in
//   registers (VEC = 4 at n <= 8: one 16-byte load or store per row).  It
//   issues all n row loads before any arithmetic, runs the mix, the
//   halving and the residual in registers, and keeps no column in shared
//   memory.  M and d are read once a block into shared memory; each group
//   reads them from there by 16-byte loads, and each M value serves VEC
//   columns.  The wire cast is made once per (k, column).
//   The arithmetic is the generic kernel's, in the same order with the same
//   _rn intrinsics, so o and xbar come out bit for bit the same.  A
//   grid-stride loop over column groups, with a grid of as many blocks as
//   fit on the card at once, keeps the residual's partials to one per
//   block; they are added in a fixed order by `sum_partials`.
// * `mix_kernel`, one thread per column, the n x n mix out of shared
//   memory: every other n, D and alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "columns.cuh"

namespace {

using repro::kVecBlock;
using repro::load_row;
using repro::load_vec;
using repro::store_vec;

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

// ---------------------------------------------------------------------------
// The register instance
// ---------------------------------------------------------------------------
// s[i] += s[m - h + i] for i < h = m / 2, then m -= h, down to one row:
// the generic kernel's halving, unrolled so that s stays in registers.
template <int M>
__device__ __forceinline__ void halve(float* s) {
  if constexpr (M > 1) {
    constexpr int h = M / 2;
#pragma unroll
    for (int i = 0; i < h; ++i) s[i] = __fadd_rn(s[i], s[M - h + i]);
    halve<M - h>(s);
  }
}

// Sum over the block in a fixed order (shuffle tree in each warp, then the
// warps' sums in order), written by thread 0.
__device__ __forceinline__ void block_sum_to(float r, float* out) {
  __shared__ float warp_sums[kVecBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    r = __fadd_rn(r, __shfl_down_sync(0xffffffffu, r, off));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = r;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kVecBlock / 32; ++w) s = __fadd_rn(s, warp_sums[w]);
    *out = s;
  }
}

// `o` may alias `x` (the staging buffer consumed in place): in each group a
// thread loads every row of its columns before it stores any, and no thread
// touches another's columns, so neither pointer is __restrict__.
template <int N, bool WITH_G, bool WIRE, bool RESID>
__global__ void __launch_bounds__(kVecBlock)
    mix_vector_kernel(const float* x, const float* __restrict__ g,
                      const float* __restrict__ gamma,
                      const float* __restrict__ d,
                      const float* __restrict__ M, float* o,
                      float* __restrict__ xbar, float* __restrict__ partial,
                      long long D) {
  constexpr int V = repro::vec_width(N);
  __shared__ __align__(16) float sM[N * N];
  __shared__ float sd[N];
  for (int q = threadIdx.x; q < N * N; q += kVecBlock) sM[q] = M[q];
  if (threadIdx.x < N) sd[threadIdx.x] = d[threadIdx.x];
  __syncthreads();
  const float gam = WITH_G ? gamma[0] : 0.f;
  const long long groups = D / V;
  float r = 0.f;
  for (long long c = static_cast<long long>(blockIdx.x) * kVecBlock +
                     threadIdx.x;
       c < groups; c += static_cast<long long>(gridDim.x) * kVecBlock) {
    const long long j = c * V;
    float v[N][V];
#pragma unroll
    for (int k = 0; k < N; ++k) load_vec<V>(x + k * D + j, v[k]);
    if constexpr (WITH_G) {
      float gv[N][V];
#pragma unroll
      for (int k = 0; k < N; ++k) load_vec<V>(g + k * D + j, gv[k]);
#pragma unroll
      for (int k = 0; k < N; ++k)
#pragma unroll
        for (int u = 0; u < V; ++u)
          v[k][u] = __fsub_rn(v[k][u], __fmul_rn(gam, gv[k][u]));
    }
    float w[N][V];
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int u = 0; u < V; ++u) w[k][u] = WIRE ? wire_bf16(v[k][u]) : v[k][u];
    const int z = repro::opaque_zero();
    float out[N][V];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float m[N];
      load_row<N>(sM + z, i, m);
      const float di = sd[z + i];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < N; ++k)
          acc = __fadd_rn(acc, __fmul_rn(m[k], w[k][u]));
        out[i][u] = __fadd_rn(acc, __fmul_rn(di, v[i][u]));
      }
      store_vec<V>(o + i * D + j, out[i]);
    }
    if constexpr (RESID) {
      float mean[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        float s[N];
#pragma unroll
        for (int i = 0; i < N; ++i) s[i] = out[i][u];
        halve<N>(s);
        mean[u] = __fdiv_rn(s[0], static_cast<float>(N));
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float e = __fsub_rn(out[i][u], mean[u]);
          r = __fadd_rn(r, __fmul_rn(e, e));
        }
      }
      store_vec<V>(xbar + j, mean);
    }
  }
  if constexpr (RESID) block_sum_to(r, partial + blockIdx.x);
}

template <int N, bool WITH_G, bool WIRE, bool RESID>
cudaError_t launch_vector(const float* x, const float* g, const float* gamma,
                          const float* d, const float* M, float* o,
                          float* xbar, float* partial, float* resid,
                          long long D, int max_grid, cudaStream_t s) {
  const auto kernel = mix_vector_kernel<N, WITH_G, WIRE, RESID>;
  long long grid = 0;
  cudaError_t e = repro::resident_grid(kernel, D / repro::vec_width(N), &grid);
  if (e != cudaSuccess) return e;
  grid = grid < max_grid ? grid : max_grid;
  kernel<<<static_cast<unsigned>(grid), kVecBlock, 0, s>>>(
      x, g, gamma, d, M, o, xbar, partial, D);
  e = cudaGetLastError();
  if (e != cudaSuccess || !RESID) return e;
  sum_partials<<<1, kMaxBlock, 0, s>>>(partial, grid, resid);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_vector_n(int with_g, int wire, int with_residual,
                            const float* x, const float* g,
                            const float* gamma, const float* d,
                            const float* M, float* o, float* xbar,
                            float* partial, float* resid, long long D,
                            int max_grid, cudaStream_t s) {
  const int sel = (with_g ? 4 : 0) | (wire ? 2 : 0) | (with_residual ? 1 : 0);
#define REPRO_MIX_VECTOR(G, W, R)                                           \
  case (G ? 4 : 0) | (W ? 2 : 0) | (R ? 1 : 0):                             \
    return launch_vector<N, G, W, R>(x, g, gamma, d, M, o, xbar, partial,   \
                                     resid, D, max_grid, s);
  switch (sel) {
    REPRO_MIX_VECTOR(false, false, false)
    REPRO_MIX_VECTOR(false, false, true)
    REPRO_MIX_VECTOR(false, true, false)
    REPRO_MIX_VECTOR(false, true, true)
    REPRO_MIX_VECTOR(true, false, false)
    REPRO_MIX_VECTOR(true, false, true)
    REPRO_MIX_VECTOR(true, true, false)
    default:
      return launch_vector<N, true, true, true>(x, g, gamma, d, M, o, xbar,
                                                partial, resid, D, max_grid,
                                                s);
  }
#undef REPRO_MIX_VECTOR
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

// Plain C entry point of the register instance (bound with ctypes).
// n must be 4, 8, 16 or 32, D a multiple of the instance's vector width
// (4, 4, 2, 1) and every pointer 16-byte aligned; `partial` holds
// `max_grid` floats (the grid is at most that many blocks).  Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int repro_mix_vector(const void* x, const void* g,
                                const void* gamma, const void* d,
                                const void* M, void* o, void* xbar,
                                void* partial, void* resid, long long D,
                                int n, int with_g, int wire,
                                int with_residual, int max_grid,
                                void* stream) {
  const auto aligned = repro::aligned16;
  if (!repro::vector_nodes(n) || D < 1 || D % repro::vec_width(n) != 0 ||
      max_grid < 1 || !aligned(x) || !aligned(o) ||
      (with_g && !aligned(g)) || (with_residual && !aligned(xbar)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  const float* gm = static_cast<const float*>(gamma);
  const float* df = static_cast<const float*>(d);
  const float* Mf = static_cast<const float*>(M);
  float* of = static_cast<float*>(o);
  float* xb = static_cast<float*>(xbar);
  float* pa = static_cast<float*>(partial);
  float* rs = static_cast<float*>(resid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (n) {
    case 4:
      e = launch_vector_n<4>(with_g, wire, with_residual, xf, gf, gm, df, Mf,
                             of, xb, pa, rs, D, max_grid, s);
      break;
    case 8:
      e = launch_vector_n<8>(with_g, wire, with_residual, xf, gf, gm, df, Mf,
                             of, xb, pa, rs, D, max_grid, s);
      break;
    case 16:
      e = launch_vector_n<16>(with_g, wire, with_residual, xf, gf, gm, df,
                              Mf, of, xb, pa, rs, D, max_grid, s);
      break;
    default:
      e = launch_vector_n<32>(with_g, wire, with_residual, xf, gf, gm, df,
                              Mf, of, xb, pa, rs, D, max_grid, s);
  }
  return static_cast<int>(e);
}
