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
// Three instances of the round, picked by the wrapper's rules
// (kernels/mixing_cuda.py `mix_vector_width`, `use_nodes_mix`):
//
// * `mix_vector_kernel<N, V, ...>`, for n in {2, 4, 8, 16, 32} at any D
//   and alignment.  Timing variants of the generic kernel on the H100
//   showed what held it well above its bound: not the n dependent chains
//   of the mix, but the column's round trips through shared memory (the
//   residual's halving among them), the n^2 loads of M from inside the
//   i-k loop, and 4-byte accesses from loops that cannot unroll
//   (PERF.md).  So n is a template parameter, every loop unrolls, and a
//   thread holds V adjacent columns of every row in registers.  V is a
//   template parameter of its own: vec_width(n) (4 at n <= 8: one 16-byte
//   load or store per row; 2 at n = 16; 1 at n = 32) when D is a multiple
//   of it and every row operand is 16-byte aligned, else 1.  Rows of a
//   ragged D sit at different 16-byte phases, so no vector prologue could
//   serve them all; at V = 1 a thread still holds its column in registers
//   and a warp still reads 128 contiguous bytes a row.  A thread issues
//   all n row loads before any arithmetic, runs the mix, the halving and
//   the residual in registers, and keeps no column in shared memory.  M
//   and d are read once a block into shared memory; each group reads them
//   from there by 16-byte loads (8-byte at n = 2), and each M value serves
//   V columns.  The wire cast is made once per (k, column).  The
//   arithmetic is the generic kernel's, in the same order with the same
//   _rn intrinsics, so o and xbar come out bit for bit the same.  A
//   grid-stride loop over column groups, with a grid of as many blocks as
//   fit on the card at once, keeps the residual's partials to one per
//   block; they are added in a fixed order by `sum_partials`.
// * `mix_nodes_kernel` (nodes.cuh), contiguous rows at n >= 48, or at
//   n >= 3 on D <= 8,192 (the wrapper's `_nodes_rows`, from timings in
//   turns): the n x n mix spread over its outputs, 4 of them a thread,
//   each the generic chain in the generic order; the residual in a pass of
//   its own at the generic kernel's block width
//   (`mix_nodes_residual_kernel`, the generic kernel's tail:
//   `residual_column`, `block_tree`), so x̄ and the partials are the
//   generic instance's.  At the simulators' n = 100, D = 10 the generic
//   kernel ran the whole round on one warp, 10 of its lanes each through a
//   10,000-term chain: 0.34 ms a call against 0.003 ms for a one-element
//   launch, not launch-bound; this instance takes 0.006 ms, and 2.56 ms
//   against the generic 11.93 at n = 100, D = 1,000,003 (PERF.md, row
//   1d).  A lane takes one row, so at few nodes most lanes idle: there
//   the generic kernel wins on a wide D.
// * `mix_kernel`, one thread per column, the n x n mix out of shared
//   memory: any n, D and alignment; the route of strided rows and of
//   n < 48 on a D over 8,192 outside the register instance's n, and the
//   oracle the other two are held to bit for bit (`chip_smoke.py`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "columns.cuh"
#include "nodes.cuh"

namespace {

using repro::kNodesBlock;
using repro::kNodesCols;
using repro::kNodesRows;
using repro::kVecBlock;
using repro::load_vec;
using repro::store_vec;

constexpr int kMaxBlock = 1024;
// Bytes of dynamic shared memory a kernel with the static reduction buffer
// `red[kMaxBlock]` (4 KB) may take without opting in: the 48 KB a block
// gets by default hold both.
constexpr size_t kRedDefaultSmem = 48u * 1024u - kMaxBlock * sizeof(float);

// The node counts that have a register instance of the mix (cmix.cu's
// are columns.cuh's `vector_nodes`, without n = 2).
bool mix_vector_nodes(int n) {
  return n == 2 || n == 4 || n == 8 || n == 16 || n == 32;
}

__device__ __forceinline__ float wire_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x̄ of one column and the column's sum of squares about it: `s` holds the
// column's n values at a stride of `bd` words and is overwritten by the
// pairwise halving (s[i] += s[m - h + i]); `col` holds them again, at a
// stride of `stride`, for the sum of squares in row order.
__device__ __forceinline__ float residual_column(float* s, int bd,
                                                 const float* col,
                                                 long long stride, int n,
                                                 float* xbar_j) {
  for (int m = n; m > 1;) {
    const int h = m / 2;
    for (int i = 0; i < h; ++i)
      s[i * bd] = __fadd_rn(s[i * bd], s[(m - h + i) * bd]);
    m -= h;
  }
  const float mean = __fdiv_rn(s[0], static_cast<float>(n));
  *xbar_j = mean;
  float r = 0.f;
  for (int i = 0; i < n; ++i) {
    const float e = __fsub_rn(col[i * stride], mean);
    r = __fadd_rn(r, __fmul_rn(e, e));
  }
  return r;
}

// The block's threads' values added by a halving tree into *out (zeros from
// threads past D); every thread of the block calls it.
__device__ __forceinline__ void block_tree(float* red, float r, float* out) {
  const int t = threadIdx.x;
  red[t] = r;
  __syncthreads();
  for (int k = blockDim.x / 2; k > 0; k >>= 1) {
    if (t < k) red[t] = __fadd_rn(red[t], red[t + k]);
    __syncthreads();
  }
  if (t == 0) *out = red[0];
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
    if (with_residual) {  // sx is free now: it takes the halving
      for (int i = 0; i < n; ++i) sx[i * bd + t] = so[i * bd + t];
      r = residual_column(sx + t, bd, so + t, bd, n, xbar + j);
    }
  }
  // uniform over the block
  if (with_residual) block_tree(red, r, partial + blockIdx.x);
}

// One block adds the per-block partials in a fixed order.
__global__ void sum_partials(const float* __restrict__ partial,
                             long long count, float* __restrict__ out) {
  __shared__ float red[kMaxBlock];
  const int t = threadIdx.x;
  float s = 0.f;
  for (long long i = t; i < count; i += blockDim.x)
    s = __fadd_rn(s, partial[i]);
  block_tree(red, s, out);
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

// Row i of the block's shared (N, N) weights: columns.cuh's 16-byte
// loads, or one 8-byte load at N = 2.
template <int N>
__device__ __forceinline__ void weights_row(const float* sM, int i,
                                            float (&m)[N]) {
  if constexpr (N % 4 == 0) {
    repro::load_row<N>(sM, i, m);
  } else {
    static_assert(N == 2, "register instances at N = 2 or a multiple of 4");
    const float2 t = *reinterpret_cast<const float2*>(sM + i * N);
    m[0] = t.x; m[1] = t.y;
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
// touches another's columns, so neither pointer is __restrict__.  V = 1
// takes any D and 4-byte alignment; V > 1 needs D % V == 0 and 16-byte
// aligned rows.
template <int N, int V, bool WITH_G, bool WIRE, bool RESID>
__global__ void __launch_bounds__(kVecBlock)
    mix_vector_kernel(const float* x, const float* __restrict__ g,
                      const float* __restrict__ gamma,
                      const float* __restrict__ d,
                      const float* __restrict__ M, float* o,
                      float* __restrict__ xbar, float* __restrict__ partial,
                      long long D) {
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
      weights_row<N>(sM + z, i, m);
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

template <int N, int V, bool WITH_G, bool WIRE, bool RESID>
cudaError_t launch_vector(const float* x, const float* g, const float* gamma,
                          const float* d, const float* M, float* o,
                          float* xbar, float* partial, float* resid,
                          long long D, int max_grid, cudaStream_t s) {
  const auto kernel = mix_vector_kernel<N, V, WITH_G, WIRE, RESID>;
  long long grid = 0;
  cudaError_t e = repro::resident_grid(kernel, D / V, &grid);
  if (e != cudaSuccess) return e;
  grid = grid < max_grid ? grid : max_grid;
  kernel<<<static_cast<unsigned>(grid), kVecBlock, 0, s>>>(
      x, g, gamma, d, M, o, xbar, partial, D);
  e = cudaGetLastError();
  if (e != cudaSuccess || !RESID) return e;
  sum_partials<<<1, kMaxBlock, 0, s>>>(partial, grid, resid);
  return cudaGetLastError();
}

template <int N, int V>
cudaError_t launch_vector_n(int with_g, int wire, int with_residual,
                            const float* x, const float* g,
                            const float* gamma, const float* d,
                            const float* M, float* o, float* xbar,
                            float* partial, float* resid, long long D,
                            int max_grid, cudaStream_t s) {
  const int sel = (with_g ? 4 : 0) | (wire ? 2 : 0) | (with_residual ? 1 : 0);
#define REPRO_MIX_VECTOR(G, W, R)                                           \
  case (G ? 4 : 0) | (W ? 2 : 0) | (R ? 1 : 0):                             \
    return launch_vector<N, V, G, W, R>(x, g, gamma, d, M, o, xbar,         \
                                        partial, resid, D, max_grid, s);
  switch (sel) {
    REPRO_MIX_VECTOR(false, false, false)
    REPRO_MIX_VECTOR(false, false, true)
    REPRO_MIX_VECTOR(false, true, false)
    REPRO_MIX_VECTOR(false, true, true)
    REPRO_MIX_VECTOR(true, false, false)
    REPRO_MIX_VECTOR(true, false, true)
    REPRO_MIX_VECTOR(true, true, false)
    default:
      return launch_vector<N, V, true, true, true>(x, g, gamma, d, M, o, xbar,
                                                   partial, resid, D,
                                                   max_grid, s);
  }
#undef REPRO_MIX_VECTOR
}

// ---------------------------------------------------------------------------
// The node-parallel instance (nodes.cuh)
// ---------------------------------------------------------------------------
// o only: the residual is a pass of its own (`mix_nodes_residual_kernel`),
// since a column's rows may be spread over several blocks.  `o` may alias
// `x` only at gridDim.y = 1 (the entry point refuses the rest): a block
// then stages every row of its column tile before it writes any, and each
// thread reads x at its own outputs only before it writes them.  The
// half-step and the wire cast act in the staging and the closing term
// only, so they are runtime flags: one instance in all.
__global__ void __launch_bounds__(kNodesBlock)
    mix_nodes_kernel(const float* x, const float* __restrict__ g,
                     const float* __restrict__ gamma,
                     const float* __restrict__ d,
                     const float* __restrict__ M, float* o, int n,
                     long long D, int with_g, int wire) {
  extern __shared__ __align__(16) float nodes_buf[];
  float* sv = nodes_buf;
  float* sM = nodes_buf + n * kNodesCols;
  const int lane = threadIdx.x % 32;
  const int c0 = (threadIdx.x / 32) * 4;
  const long long col_tiles = (D + kNodesCols - 1) / kNodesCols;
  const int row_tiles = (n + kNodesRows - 1) / kNodesRows;
  const float gam = with_g ? gamma[0] : 0.f;
  int staged = -1;
  for (long long ct = blockIdx.x; ct < col_tiles; ct += gridDim.x) {
    const long long j0 = ct * kNodesCols;
    const int cols = repro::live_cols(j0, D);
    __syncthreads();  // the last tile's products are done with sv and sM
#pragma unroll 8
    for (int q = threadIdx.x; q < n * cols; q += kNodesBlock) {
      const int k = cols == kNodesCols ? q / kNodesCols : q / cols;
      const int c = q - k * cols;
      const long long at = k * D + j0 + c;
      float v = x[at];
      if (with_g) v = __fsub_rn(v, __fmul_rn(gam, g[at]));
      sv[k * kNodesCols + c] = wire ? wire_bf16(v) : v;
    }
    bool first = true;
    for (int r = blockIdx.y; r < row_tiles; r += gridDim.y) {
      if (r != staged) {  // uniform over the block
        if (!first) __syncthreads();  // the last row tile's products
        repro::stage_rows(M, sM, n, n, r * kNodesRows);
        staged = r;
      }
      first = false;
      __syncthreads();
      const int i = r * kNodesRows + lane;
      if (j0 + c0 >= D || i >= n) continue;  // past the ragged edges
      float acc[4] = {};
      repro::nodes_products(sv, sM, n, lane, c0, acc);
      const float di = __ldg(d + i);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long j = j0 + c0 + c;
        if (j >= D) continue;
        float xi;  // x'_ij before the wire cast
        if (wire) {
          xi = x[i * D + j];
          if (with_g) xi = __fsub_rn(xi, __fmul_rn(gam, g[i * D + j]));
        } else {
          xi = sv[i * kNodesCols + c0 + c];
        }
        o[i * D + j] = __fadd_rn(acc[c], __fmul_rn(di, xi));
      }
    }
  }
}

// The generic kernel's residual on the finished o: one thread per column
// and blocks of the generic kernel's width, so x̄ (the pairwise halving),
// each column's sum of squares in row order, the per-block tree and hence
// the partials are the generic instance's, bit for bit.
__global__ void mix_nodes_residual_kernel(const float* __restrict__ o,
                                          float* __restrict__ xbar,
                                          float* __restrict__ partial,
                                          int n, long long D) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxBlock];
  const int bd = blockDim.x;
  const int t = threadIdx.x;
  const long long j = static_cast<long long>(blockIdx.x) * bd + t;
  float r = 0.f;
  if (j < D) {
    for (int i = 0; i < n; ++i) smem[i * bd + t] = o[i * D + j];
    r = residual_column(smem + t, bd, o + j, D, n, xbar + j);
  }
  block_tree(red, r, partial + blockIdx.x);
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
  if (smem > kRedDefaultSmem) {
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
// n must be 2, 4, 8, 16 or 32 and vec its vector width (4, 4, 4, 2, 1) or
// 1; at vec > 1, D must be a multiple of vec and every row operand's
// pointer 16-byte aligned; at vec = 1 any D and 4-byte alignment.
// `partial` holds `max_grid` floats (the grid is at most that many
// blocks).  Returns cudaGetLastError() after the launches (0 = success),
// or cudaErrorInvalidValue for an (n, vec) with no instance: the caller
// picks the instance, nothing here picks another.
extern "C" int repro_mix_vector(const void* x, const void* g,
                                const void* gamma, const void* d,
                                const void* M, void* o, void* xbar,
                                void* partial, void* resid, long long D,
                                int n, int with_g, int wire,
                                int with_residual, int vec, int max_grid,
                                void* stream) {
  const auto aligned = repro::aligned16;
  if (!mix_vector_nodes(n) || D < 1 || max_grid < 1 ||
      (vec != 1 && vec != repro::vec_width(n)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec > 1 && (D % vec != 0 || !aligned(x) || !aligned(o) ||
                  (with_g && !aligned(g)) ||
                  (with_residual && !aligned(xbar))))
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
#define REPRO_MIX_NV(N, V)                                                  \
  launch_vector_n<N, V>(with_g, wire, with_residual, xf, gf, gm, df, Mf, of, \
                        xb, pa, rs, D, max_grid, s)
  cudaError_t e;
  const bool wide = vec > 1;
  switch (n) {
    case 2:
      e = wide ? REPRO_MIX_NV(2, 4) : REPRO_MIX_NV(2, 1);
      break;
    case 4:
      e = wide ? REPRO_MIX_NV(4, 4) : REPRO_MIX_NV(4, 1);
      break;
    case 8:
      e = wide ? REPRO_MIX_NV(8, 4) : REPRO_MIX_NV(8, 1);
      break;
    case 16:
      e = wide ? REPRO_MIX_NV(16, 2) : REPRO_MIX_NV(16, 1);
      break;
    default:
      e = REPRO_MIX_NV(32, 1);
  }
#undef REPRO_MIX_NV
  return static_cast<int>(e);
}

// Plain C entry point of the node-parallel instance (bound with ctypes):
// the arguments of repro_mix, then the grid, `grid_x` column tiles by
// `grid_y` row tiles at most (the blocks walk the rest).  `block` is the
// generic kernel's block width, which the residual pass takes; `partial`
// holds ceil(D / block) floats.  `o` may be `x` only at grid_y = 1.
// Returns cudaGetLastError() after the launches (0 = success), or
// cudaErrorInvalidValue for arguments it refuses.
extern "C" int repro_mix_nodes(const void* x, const void* g, const void* gamma,
                               const void* d, const void* M, void* o,
                               void* xbar, void* partial, void* resid,
                               long long D, int n, int with_g, int wire,
                               int with_residual, int block, int grid_x,
                               int grid_y, void* stream) {
  if (n < 1 || D < 1 || block < 32 || block > kMaxBlock ||
      (block & (block - 1)) != 0 || grid_x < 1 || grid_y < 1 ||
      grid_y > 65535 || (x == o && grid_y != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t tile_smem = repro::nodes_smem(n);
  cudaError_t e = cudaSuccess;
  if (tile_smem > 48u * 1024u)
    e = cudaFuncSetAttribute(mix_nodes_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(tile_smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  mix_nodes_kernel<<<dim3(static_cast<unsigned>(grid_x),
                          static_cast<unsigned>(grid_y)),
                     kNodesBlock, tile_smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(gamma), static_cast<const float*>(d),
      static_cast<const float*>(M), of, n, D, with_g, wire);
  e = cudaGetLastError();
  if (e != cudaSuccess || !with_residual) return static_cast<int>(e);
  const size_t smem = 1ull * n * block * sizeof(float);
  if (smem > kRedDefaultSmem) {
    e = cudaFuncSetAttribute(mix_nodes_residual_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = (D + block - 1) / block;
  mix_nodes_residual_kernel<<<static_cast<unsigned>(grid), block, smem, s>>>(
      of, static_cast<float*>(xbar), static_cast<float*>(partial), n, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_partials<<<1, kMaxBlock, 0, s>>>(static_cast<const float*>(partial),
                                       grid, static_cast<float*>(resid));
  return static_cast<int>(cudaGetLastError());
}
