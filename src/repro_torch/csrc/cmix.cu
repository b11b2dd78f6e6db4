// Compensated compressed mixing round for Hopper (sm_90a), one pass over a
// leaf's node-major (n, D) matrix.
//
// Replaces the TPU kernel `_cmix_kernel` (src/repro/kernels/mixing_pallas.py,
// launched by `_cmix_flat`).  Per column j, over the n node rows:
//
//   y_k  = x_k + e_k                          (e: error feedback, optional)
//   q_k  = Q(y_k)                             int8 / fp8 stochastic codes,
//                                             dequantized; or q given
//                                             ("precomputed": topk / randk)
//   ef_k = y_k - q_k                          (with error feedback)
//   q_k  = bf16(q_k)                          (global phase with a bf16 wire)
//   o_i  = x_i + (sum_k M_ik q_k - w_i q_i)
//
// The per-row scale is computed by the wrapper (one reduction per leaf, as
// the reference computes it outside its kernel) and read from device
// memory; the seed is a kernel argument, so a round copies nothing from the
// host.
//
// What bounds it on the H100: bytes.  With error feedback each element is
// read twice (x, e) and written twice (o, ef): 16 bytes for about 2n + 10
// flops, far below the ~20 flops per byte where the fp32 units would
// limit.  So every input element is read once and every output written
// once, neighbouring threads on neighbouring columns (coalesced rows).  The
// random bits depend only on the column, so each thread hashes its column
// once for all n rows; it keeps the column's n values of x and q in shared
// memory ([row][thread], conflict-free) and sums sum_k M_ik q_k in the
// fixed order k = 0 .. n-1, the order of the plain twin
// (kernels/mixing_cuda.py `cmix_flat_plain`), which therefore agrees bit
// for bit.  Equal rows give equal q and every row sums the same products,
// so the rows of a constant state stay equal bitwise; with the one-peer
// weights (1/2) the compensation cancels and the state comes back bitwise.
//
// The output is always a fresh buffer: x is a view of the caller's leaf.
//
// Three instances, picked by the wrapper's rules (kernels/mixing_cuda.py
// `use_vector_cmix`, `use_nodes_cmix`): `cmix_kernel` above, one thread
// per column with the column in shared memory, for any n, D and
// alignment (the route of strided rows, of n = 2 and of n < 48 on a
// D over 8,192 where the register instance refuses the round, and the
// oracle of the others); `cmix_nodes_kernel` (nodes.cuh), contiguous rows
// at n >= 48, or at n >= 3 on D <= 8,192 (the wrapper's `_nodes_rows`):
// the n x n mix spread over its outputs, the codes of a column tile made
// once a block (at the simulators' n = 100, D = 10: 0.007 ms a call, the
// generic one's single warp 0.27 ms; PERF.md, row 2b); and `cmix_vector_kernel`, for n in {4, 8, 16, 32}, D a multiple of
// the vector width and 16-byte aligned pointers.  The last follows what the
// timing of mix.cu's variants showed: a thread holds VEC adjacent columns
// in registers (VEC = 4 at n <= 8: 16-byte loads of x and e, 16-byte stores
// of o and ef), issues every row's loads before any arithmetic, hashes each
// column once, reads the n row scales once and M and w once a block (into
// shared memory), and walks the column groups in a grid-stride loop.  Its
// operations and their order are the first instance's, as are the
// node-parallel one's, so all three agree with the twin bit for bit.
//
// `repro_cmix_absmax` computes the row maxima max_j |x_kj + e_kj| (or
// |x_kj|) from which the wrapper makes the int8/fp8 scales, reading x and e
// once and writing no sum: per-block maxima, then one block per row takes
// the maximum of its blocks'.  A maximum does not depend on the order, so
// this is the plain `amax(abs(x + e))` bit for bit; a NaN anywhere in a row
// makes the row's maximum NaN, as torch.amax does (fmaxf would drop it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "columns.cuh"
#include "nodes.cuh"
#include "quant.cuh"

namespace {

using repro::kVecBlock;
using repro::load_row;
using repro::load_vec;
using repro::store_vec;

enum Kind { kInt8 = 0, kFp8 = 1, kPrecomputed = 2 };

template <int KIND, bool EF, bool WIRE>
__global__ void cmix_kernel(const float* __restrict__ x,
                            const float* __restrict__ e,
                            const float* __restrict__ q_in,
                            const float* __restrict__ scale,
                            const float* __restrict__ w,
                            const float* __restrict__ M,
                            float* __restrict__ o, float* __restrict__ ef,
                            uint32_t seed, int n, long long D) {
  extern __shared__ float smem[];
  const int bd = blockDim.x;
  const int t = threadIdx.x;
  float* sx = smem;
  float* sq = smem + n * bd;
  const long long j = static_cast<long long>(blockIdx.x) * bd + t;
  if (j >= D) return;  // no barrier below: the ragged edge just stops
  const uint32_t bits = repro::column_bits(seed, static_cast<uint32_t>(j));
  const float u = repro::uniform_of(bits);
  for (int k = 0; k < n; ++k) {
    const long long at = k * D + j;
    const float xv = x[at];
    sx[k * bd + t] = xv;
    float q;
    if (KIND == kPrecomputed) {
      q = q_in[at];
    } else {
      const float y = EF ? __fadd_rn(xv, e[at]) : xv;
      q = KIND == kInt8 ? repro::int8_q(y, scale[k], u)
                        : repro::fp8_q(y, scale[k], bits);
      if (EF) ef[at] = __fsub_rn(y, q);
    }
    if (WIRE) q = __bfloat162float(__float2bfloat16_rn(q));
    sq[k * bd + t] = q;
  }
  for (int i = 0; i < n; ++i) {
    float acc = 0.f;
    for (int k = 0; k < n; ++k)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(M + i * n + k), sq[k * bd + t]));
    const float corr = __fsub_rn(acc, __fmul_rn(__ldg(w + i), sq[i * bd + t]));
    o[i * D + j] = __fadd_rn(sx[i * bd + t], corr);
  }
}

template <int KIND, bool EF, bool WIRE>
cudaError_t launch(const float* x, const float* e, const float* q,
                   const float* scale, const float* w, const float* M,
                   float* o, float* ef, uint32_t seed, int n, long long D,
                   int block, cudaStream_t s) {
  const size_t smem = 2ull * n * block * sizeof(float);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        cmix_kernel<KIND, EF, WIRE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long grid = (D + block - 1) / block;
  cmix_kernel<KIND, EF, WIRE><<<static_cast<unsigned>(grid), block, smem, s>>>(
      x, e, q, scale, w, M, o, ef, seed, n, D);
  return cudaGetLastError();
}

template <int KIND, bool EF>
cudaError_t launch_wire(int wire, const float* x, const float* e,
                        const float* q, const float* scale, const float* w,
                        const float* M, float* o, float* ef, uint32_t seed,
                        int n, long long D, int block, cudaStream_t s) {
  return wire ? launch<KIND, EF, true>(x, e, q, scale, w, M, o, ef, seed, n,
                                       D, block, s)
              : launch<KIND, EF, false>(x, e, q, scale, w, M, o, ef, seed, n,
                                        D, block, s);
}


// ---------------------------------------------------------------------------
// The register instance
// ---------------------------------------------------------------------------
template <int N, int KIND, bool EF, bool WIRE>
__global__ void __launch_bounds__(kVecBlock)
    cmix_vector_kernel(const float* __restrict__ x,
                       const float* __restrict__ e,
                       const float* __restrict__ q_in,
                       const float* __restrict__ scale,
                       const float* __restrict__ w,
                       const float* __restrict__ M, float* __restrict__ o,
                       float* __restrict__ ef, uint32_t seed, long long D) {
  constexpr int V = repro::vec_width(N);
  __shared__ __align__(16) float sM[N * N];
  __shared__ float sw[N];
  for (int k = threadIdx.x; k < N * N; k += kVecBlock) sM[k] = M[k];
  if (threadIdx.x < N) sw[threadIdx.x] = w[threadIdx.x];
  __syncthreads();
  float sc[N];
  if constexpr (KIND != kPrecomputed) {
#pragma unroll
    for (int k = 0; k < N; ++k) sc[k] = __ldg(scale + k);
  }
  const long long groups = D / V;
  for (long long c = static_cast<long long>(blockIdx.x) * kVecBlock +
                     threadIdx.x;
       c < groups; c += static_cast<long long>(gridDim.x) * kVecBlock) {
    const long long j = c * V;
    float xv[N][V], q[N][V];
#pragma unroll
    for (int k = 0; k < N; ++k) load_vec<V>(x + k * D + j, xv[k]);
    if constexpr (KIND == kPrecomputed) {
#pragma unroll
      for (int k = 0; k < N; ++k) load_vec<V>(q_in + k * D + j, q[k]);
    } else {
      float ev[N][V];
      if constexpr (EF) {
#pragma unroll
        for (int k = 0; k < N; ++k) load_vec<V>(e + k * D + j, ev[k]);
      }
      uint32_t bits[V];
      float u[V];
#pragma unroll
      for (int t = 0; t < V; ++t) {
        bits[t] = repro::column_bits(seed, static_cast<uint32_t>(j + t));
        u[t] = repro::uniform_of(bits[t]);
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float efk[V];
#pragma unroll
        for (int t = 0; t < V; ++t) {
          const float y = EF ? __fadd_rn(xv[k][t], ev[k][t]) : xv[k][t];
          q[k][t] = KIND == kInt8 ? repro::int8_q(y, sc[k], u[t])
                                  : repro::fp8_q(y, sc[k], bits[t]);
          efk[t] = __fsub_rn(y, q[k][t]);
        }
        if constexpr (EF) store_vec<V>(ef + k * D + j, efk);
      }
    }
    if constexpr (WIRE) {
#pragma unroll
      for (int k = 0; k < N; ++k)
#pragma unroll
        for (int t = 0; t < V; ++t)
          q[k][t] = __bfloat162float(__float2bfloat16_rn(q[k][t]));
    }
    const int z = repro::opaque_zero();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float m[N];
      load_row<N>(sM + z, i, m);
      const float wi = sw[z + i];
      float out[V];
#pragma unroll
      for (int t = 0; t < V; ++t) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < N; ++k)
          acc = __fadd_rn(acc, __fmul_rn(m[k], q[k][t]));
        const float corr = __fsub_rn(acc, __fmul_rn(wi, q[i][t]));
        out[t] = __fadd_rn(xv[i][t], corr);
      }
      store_vec<V>(o + i * D + j, out);
    }
  }
}

template <int N, int KIND, bool EF, bool WIRE>
cudaError_t launch_vector(const float* x, const float* e, const float* q,
                          const float* scale, const float* w, const float* M,
                          float* o, float* ef, uint32_t seed, long long D,
                          cudaStream_t s) {
  const auto kernel = cmix_vector_kernel<N, KIND, EF, WIRE>;
  long long grid = 0;
  const cudaError_t err =
      repro::resident_grid(kernel, D / repro::vec_width(N), &grid);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(grid), kVecBlock, 0, s>>>(
      x, e, q, scale, w, M, o, ef, seed, D);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_vector_n(int kind, int with_ef, int wire, const float* x,
                            const float* e, const float* q,
                            const float* scale, const float* w,
                            const float* M, float* o, float* ef,
                            uint32_t seed, long long D, cudaStream_t s) {
#define REPRO_CMIX_VECTOR(K, E)                                              \
  return wire ? launch_vector<N, K, E, true>(x, e, q, scale, w, M, o, ef,    \
                                             seed, D, s)                     \
              : launch_vector<N, K, E, false>(x, e, q, scale, w, M, o, ef,   \
                                              seed, D, s)
  if (kind == kPrecomputed) REPRO_CMIX_VECTOR(kPrecomputed, false);
  if (kind == kInt8) {
    if (with_ef) REPRO_CMIX_VECTOR(kInt8, true);
    REPRO_CMIX_VECTOR(kInt8, false);
  }
  if (with_ef) REPRO_CMIX_VECTOR(kFp8, true);
  REPRO_CMIX_VECTOR(kFp8, false);
#undef REPRO_CMIX_VECTOR
}

// ---------------------------------------------------------------------------
// The node-parallel instance (nodes.cuh)
// ---------------------------------------------------------------------------
// Each block makes the codes of its column tile for every row, as
// `cmix_kernel` makes them (the column's hash, the row's scale, the EF
// residual, the wire cast), into shared memory; only the blocks at
// blockIdx.y = 0 write the new EF, so each element of it is written once.
// o = x + (sum_k M_ik q_k - w_i q_i), x read at the output.  The output is
// always a fresh buffer.  The code's kind, the EF and the wire cast act in
// the staging only, so they are runtime flags: one instance in all.
__global__ void __launch_bounds__(repro::kNodesBlock)
    cmix_nodes_kernel(const float* __restrict__ x,
                      const float* __restrict__ e,
                      const float* __restrict__ q_in,
                      const float* __restrict__ scale,
                      const float* __restrict__ w,
                      const float* __restrict__ M, float* __restrict__ o,
                      float* __restrict__ ef, uint32_t seed, int n,
                      long long D, int kind, int with_ef, int wire) {
  using repro::kNodesBlock;
  using repro::kNodesCols;
  using repro::kNodesRows;
  extern __shared__ __align__(16) float nodes_buf[];
  float* sq = nodes_buf;
  float* sM = nodes_buf + n * kNodesCols;
  const int lane = threadIdx.x % 32;
  const int c0 = (threadIdx.x / 32) * 4;
  const long long col_tiles = (D + kNodesCols - 1) / kNodesCols;
  const int row_tiles = (n + kNodesRows - 1) / kNodesRows;
  const bool write_ef = with_ef && blockIdx.y == 0;
  int staged = -1;
  for (long long ct = blockIdx.x; ct < col_tiles; ct += gridDim.x) {
    const long long j0 = ct * kNodesCols;
    const int cols = repro::live_cols(j0, D);
    __syncthreads();  // the last tile's products are done with sq and sM
#pragma unroll 8
    for (int p = threadIdx.x; p < n * cols; p += kNodesBlock) {
      const int k = cols == kNodesCols ? p / kNodesCols : p / cols;
      const int c = p - k * cols;
      const long long j = j0 + c;
      const long long at = k * D + j;
      float q;
      if (kind == kPrecomputed) {
        q = q_in[at];
      } else {
        const uint32_t bits =
            repro::column_bits(seed, static_cast<uint32_t>(j));
        const float y = with_ef ? __fadd_rn(x[at], e[at]) : x[at];
        q = kind == kInt8 ? repro::int8_q(y, scale[k],
                                          repro::uniform_of(bits))
                          : repro::fp8_q(y, scale[k], bits);
        if (write_ef) ef[at] = __fsub_rn(y, q);
      }
      if (wire) q = __bfloat162float(__float2bfloat16_rn(q));
      sq[k * kNodesCols + c] = q;
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
      repro::nodes_products(sq, sM, n, lane, c0, acc);
      const float wi = __ldg(w + i);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long j = j0 + c0 + c;
        if (j >= D) continue;
        const float corr =
            __fsub_rn(acc[c], __fmul_rn(wi, sq[i * kNodesCols + c0 + c]));
        o[i * D + j] = __fadd_rn(x[i * D + j], corr);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Row maxima of |x + e| for the int8/fp8 scales
// ---------------------------------------------------------------------------
constexpr int kAbsmaxBlock = 256;
constexpr int kAbsmaxMaxChunks = 256;  // blocks per row at most
constexpr int kAbsmaxPerThread = 8;    // groups a thread takes, at least

// max(a, b) that keeps a NaN from either side
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Block (chunk, row) takes the maximum over its share of the row's column
// groups; V = 4 reads 16 bytes a row (D % 4 == 0, aligned pointers).
template <bool EF, int V>
__global__ void __launch_bounds__(kAbsmaxBlock)
    absmax_partial_kernel(const float* __restrict__ x,
                          const float* __restrict__ e,
                          float* __restrict__ partial, long long D) {
  const int chunks = gridDim.x;
  const long long row = blockIdx.y;
  const long long groups = (D + V - 1) / V;
  const long long per = (groups + chunks - 1) / chunks;
  const long long begin = blockIdx.x * per;
  const long long end = begin + per < groups ? begin + per : groups;
  const float* xr = x + row * D;
  const float* er = EF ? e + row * D : nullptr;
  float m = 0.f;
  for (long long c = begin + threadIdx.x; c < end; c += kAbsmaxBlock) {
    if constexpr (V == 4) {
      const float4 a = *reinterpret_cast<const float4*>(xr + c * 4);
      float y[4] = {a.x, a.y, a.z, a.w};
      if constexpr (EF) {
        const float4 b = *reinterpret_cast<const float4*>(er + c * 4);
        y[0] = __fadd_rn(y[0], b.x);
        y[1] = __fadd_rn(y[1], b.y);
        y[2] = __fadd_rn(y[2], b.z);
        y[3] = __fadd_rn(y[3], b.w);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) m = nan_max(m, fabsf(y[t]));
    } else {
      const float y = EF ? __fadd_rn(xr[c], er[c]) : xr[c];
      m = nan_max(m, fabsf(y));
    }
  }
  __shared__ float warp_max[kAbsmaxBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_down_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.f;
#pragma unroll
    for (int k = 0; k < kAbsmaxBlock / 32; ++k) b = nan_max(b, warp_max[k]);
    partial[row * chunks + blockIdx.x] = b;
  }
}

// One block a row: the maximum of the row's chunk maxima.
__global__ void __launch_bounds__(kAbsmaxBlock)
    absmax_finish_kernel(const float* __restrict__ partial, int chunks,
                         float* __restrict__ out) {
  const long long row = blockIdx.x;
  float m = 0.f;
  for (int c = threadIdx.x; c < chunks; c += kAbsmaxBlock)
    m = nan_max(m, partial[row * chunks + c]);
  __shared__ float warp_max[kAbsmaxBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_down_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.f;
#pragma unroll
    for (int k = 0; k < kAbsmaxBlock / 32; ++k) b = nan_max(b, warp_max[k]);
    out[row] = b;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  kind: 0 int8, 1 fp8,
// 2 precomputed (q given, no error feedback).  `block` must be a power of
// two in [32, 1024].  Returns cudaGetLastError() after the launch.
extern "C" int repro_cmix(const void* x, const void* e, const void* q,
                          const void* scale, const void* w, const void* M,
                          void* o, void* ef, unsigned int seed, long long D,
                          int n, int kind, int with_ef, int wire, int block,
                          void* stream) {
  if (n < 1 || D < 1 || block < 32 || block > 1024 ||
      (block & (block - 1)) != 0 || kind < 0 || kind > 2 ||
      (kind == kPrecomputed && with_ef))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* ef_in = static_cast<const float*>(e);
  const float* qf = static_cast<const float*>(q);
  const float* sc = static_cast<const float*>(scale);
  const float* wf = static_cast<const float*>(w);
  const float* Mf = static_cast<const float*>(M);
  float* of = static_cast<float*>(o);
  float* ef_out = static_cast<float*>(ef);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kind == kPrecomputed)
    err = launch_wire<kPrecomputed, false>(wire, xf, ef_in, qf, sc, wf, Mf, of,
                                           ef_out, seed, n, D, block, s);
  else if (kind == kInt8)
    err = with_ef ? launch_wire<kInt8, true>(wire, xf, ef_in, qf, sc, wf, Mf,
                                             of, ef_out, seed, n, D, block, s)
                  : launch_wire<kInt8, false>(wire, xf, ef_in, qf, sc, wf, Mf,
                                              of, ef_out, seed, n, D, block, s);
  else
    err = with_ef ? launch_wire<kFp8, true>(wire, xf, ef_in, qf, sc, wf, Mf,
                                            of, ef_out, seed, n, D, block, s)
                  : launch_wire<kFp8, false>(wire, xf, ef_in, qf, sc, wf, Mf,
                                             of, ef_out, seed, n, D, block, s);
  return static_cast<int>(err);
}

// Plain C entry point of the register instance (bound with ctypes): the
// arguments of repro_cmix less `block`.  n must be 4, 8, 16 or 32, D a
// multiple of the instance's vector width (4, 4, 2, 1) and every pointer
// 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int repro_cmix_vector(const void* x, const void* e, const void* q,
                                 const void* scale, const void* w,
                                 const void* M, void* o, void* ef,
                                 unsigned int seed, long long D, int n,
                                 int kind, int with_ef, int wire,
                                 void* stream) {
  const auto aligned = repro::aligned16;
  const bool quant = kind != kPrecomputed;
  if (!repro::vector_nodes(n) || D < 1 || D % repro::vec_width(n) != 0 ||
      kind < 0 || kind > 2 || (!quant && with_ef) || !aligned(x) ||
      !aligned(o) || (!quant && !aligned(q)) ||
      (with_ef && (!aligned(e) || !aligned(ef))))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* ef_in = static_cast<const float*>(e);
  const float* qf = static_cast<const float*>(q);
  const float* sc = static_cast<const float*>(scale);
  const float* wf = static_cast<const float*>(w);
  const float* Mf = static_cast<const float*>(M);
  float* of = static_cast<float*>(o);
  float* ef_out = static_cast<float*>(ef);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n) {
    case 4:
      err = launch_vector_n<4>(kind, with_ef, wire, xf, ef_in, qf, sc, wf, Mf,
                               of, ef_out, seed, D, s);
      break;
    case 8:
      err = launch_vector_n<8>(kind, with_ef, wire, xf, ef_in, qf, sc, wf, Mf,
                               of, ef_out, seed, D, s);
      break;
    case 16:
      err = launch_vector_n<16>(kind, with_ef, wire, xf, ef_in, qf, sc, wf,
                                Mf, of, ef_out, seed, D, s);
      break;
    default:
      err = launch_vector_n<32>(kind, with_ef, wire, xf, ef_in, qf, sc, wf,
                                Mf, of, ef_out, seed, D, s);
  }
  return static_cast<int>(err);
}

// Plain C entry point of the node-parallel instance (bound with ctypes):
// the arguments of repro_cmix less `block`, then the grid, `grid_x` column
// tiles by `grid_y` row tiles at most (the blocks walk the rest).  Any n,
// D and 4-byte alignment.  Returns cudaGetLastError() after the launch.
extern "C" int repro_cmix_nodes(const void* x, const void* e, const void* q,
                                const void* scale, const void* w,
                                const void* M, void* o, void* ef,
                                unsigned int seed, long long D, int n,
                                int kind, int with_ef, int wire, int grid_x,
                                int grid_y, void* stream) {
  if (n < 1 || D < 1 || kind < 0 || kind > 2 ||
      (kind == kPrecomputed && with_ef) || grid_x < 1 || grid_y < 1 ||
      grid_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = repro::nodes_smem(n);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        cmix_nodes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cmix_nodes_kernel<<<dim3(static_cast<unsigned>(grid_x),
                           static_cast<unsigned>(grid_y)),
                      repro::kNodesBlock, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(e),
      static_cast<const float*>(q), static_cast<const float*>(scale),
      static_cast<const float*>(w), static_cast<const float*>(M),
      static_cast<float*>(o), static_cast<float*>(ef), seed, n, D, kind,
      with_ef, wire);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point of the row maxima (bound with ctypes): m[k] =
// max_j |x_kj + e_kj| (e null without error feedback) over the (n, D)
// rows.  `partial` holds n * max_chunks floats.  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_cmix_absmax(const void* x, const void* e, void* partial,
                                 void* m, long long D, int n, int with_ef,
                                 int max_chunks, void* stream) {
  if (n < 1 || n > 65535 || D < 1 || max_chunks < 1 || (with_ef && !e))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = repro::aligned16;
  const bool vec = D % 4 == 0 && aligned(x) && (!with_ef || aligned(e));
  const long long groups = vec ? D / 4 : D;
  long long chunks = (groups + kAbsmaxBlock * kAbsmaxPerThread - 1) /
                     (kAbsmaxBlock * kAbsmaxPerThread);
  chunks = chunks < kAbsmaxMaxChunks ? chunks : kAbsmaxMaxChunks;
  chunks = chunks < max_chunks ? chunks : max_chunks;
  const float* xf = static_cast<const float*>(x);
  const float* ef = static_cast<const float*>(e);
  float* pa = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(n));
  if (with_ef) {
    if (vec)
      absmax_partial_kernel<true, 4><<<grid, kAbsmaxBlock, 0, s>>>(xf, ef, pa, D);
    else
      absmax_partial_kernel<true, 1><<<grid, kAbsmaxBlock, 0, s>>>(xf, ef, pa, D);
  } else {
    if (vec)
      absmax_partial_kernel<false, 4><<<grid, kAbsmaxBlock, 0, s>>>(xf, ef, pa, D);
    else
      absmax_partial_kernel<false, 1><<<grid, kAbsmaxBlock, 0, s>>>(xf, ef, pa, D);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  absmax_finish_kernel<<<static_cast<unsigned>(n), kAbsmaxBlock, 0, s>>>(
      pa, static_cast<int>(chunks), static_cast<float*>(m));
  return static_cast<int>(cudaGetLastError());
}
