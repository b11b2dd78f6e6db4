// Per-shard compensated compressed mixing round for Hopper (sm_90a): one
// pass over one node shard's (m, D) row-block of the packed matrix.
//
// Replaces the TPU kernel `_shard_cmix_kernel` (src/repro/kernels/
// mixing_pallas.py, launched by `shard_comp_mix_block`).  Per column j,
// with the shard's m rows i and the K rows k of rebuilt halo estimates
// (the decoded wire arrays of the self block and the neighbour blocks):
//
//   o_i = x_i + (sum_k M_ik * qs_k - w_i * q_self_i)
//
// where x is the shard's exact state, q_self its own estimate and
// w = 1 - diag(W): the node keeps its own state at full precision and the
// node average is preserved for any estimate.
//
// What bounds it on the H100: bytes.  At m = 2 and K = 4 each column reads
// 8 floats and writes 2 for about 2mK + 3m flops, under 1 flop per byte.
// So every input element is read once and every output written once, one
// thread per column, neighbouring threads on neighbouring columns
// (coalesced rows).  The thread keeps the column's K estimates in shared
// memory ([row][thread], conflict-free) and sums each output in the fixed
// order k = 0 .. K-1.
//
// The TPU kernel aliased x with o; in one process the shards run one after
// another over the round's input, so o is always a buffer apart from the
// inputs (the wrapper checks it).  The ragged edge is masked, so no padding
// copy is made.  Products and sums use the _rn intrinsics so nvcc
// contracts nothing into an FMA.
//
// Two instances, picked by the wrapper (kernels/mixing_cuda.py
// `use_nodes_shard_cmix`):
//
// * `shard_cmix_kernel` below, one thread a column: the shard shapes of
//   the trainers (m = 2, K = 4 or 2 on a wide D; the stacked apply's
//   m = K = 8 on the packed width), where the columns fill the card;
// * `shard_cmix_nodes_kernel` (nodes.cuh), the m x K mix spread over its
//   outputs (i, j): the stacked apply of the overlapped simulator
//   ([ovsim]: m = K = 100, D = 10), where one thread a column leaves 10
//   live threads each running 100 chains of 100 terms.  A block of
//   kNodesBlock threads takes 32 columns by 32 rows: the column tile of
//   qs staged once as [k][j], the row tile of M transposed as [k][i] at a
//   pitch of 33, each output the column kernel's chain (acc = 0, then
//   acc + M_ik qs_k for k = 0 .. K - 1, each product and sum rounded on
//   its own), then x_i + (acc - w_i q_self_i): the bits are the column
//   kernel's, which stays as its oracle.  o is always fresh, so the grid
//   takes every row tile at once: 1 x 4 blocks at (100, 100, 10).

#include <cuda_runtime.h>

#include "nodes.cuh"

namespace {

constexpr int kMaxBlock = 1024;

__global__ void shard_cmix_kernel(const float* __restrict__ x,
                                  const float* __restrict__ q_self,
                                  const float* __restrict__ qs,
                                  const float* __restrict__ w,
                                  const float* __restrict__ M,
                                  float* __restrict__ o, int m, int K,
                                  long long D) {
  extern __shared__ float sqs[];
  const int bd = blockDim.x;
  const int t = threadIdx.x;
  const long long j = static_cast<long long>(blockIdx.x) * bd + t;
  if (j >= D) return;  // no barrier below: the ragged edge just stops
  for (int k = 0; k < K; ++k) sqs[k * bd + t] = qs[k * D + j];
  for (int i = 0; i < m; ++i) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(M + i * K + k), sqs[k * bd + t]));
    const float corr = __fsub_rn(acc, __fmul_rn(__ldg(w + i),
                                                q_self[i * D + j]));
    o[i * D + j] = __fadd_rn(x[i * D + j], corr);
  }
}

// The node-parallel instance: blocks (column tile, row tile) in
// grid-stride loops, both tiles staged in shared memory (nodes.cuh).
__global__ void __launch_bounds__(repro::kNodesBlock)
    shard_cmix_nodes_kernel(const float* __restrict__ x,
                            const float* __restrict__ q_self,
                            const float* __restrict__ qs,
                            const float* __restrict__ w,
                            const float* __restrict__ M,
                            float* __restrict__ o, int m, int K,
                            long long D) {
  using repro::kNodesBlock;
  using repro::kNodesCols;
  using repro::kNodesRows;
  extern __shared__ __align__(16) float nodes_buf[];
  float* sq = nodes_buf;
  float* sM = nodes_buf + K * kNodesCols;
  const int lane = threadIdx.x % 32;
  const int c0 = (threadIdx.x / 32) * 4;
  const long long col_tiles = (D + kNodesCols - 1) / kNodesCols;
  const int row_tiles = (m + kNodesRows - 1) / kNodesRows;
  int staged = -1;
  for (long long ct = blockIdx.x; ct < col_tiles; ct += gridDim.x) {
    const long long j0 = ct * kNodesCols;
    const int cols = repro::live_cols(j0, D);
    __syncthreads();  // the last tile's products are done with sq and sM
#pragma unroll 8
    for (int p = threadIdx.x; p < K * cols; p += kNodesBlock) {
      const int k = cols == kNodesCols ? p / kNodesCols : p / cols;
      const int c = p - k * cols;
      sq[k * kNodesCols + c] = qs[k * D + j0 + c];
    }
    bool first = true;
    for (int r = blockIdx.y; r < row_tiles; r += gridDim.y) {
      if (r != staged) {  // uniform over the block
        if (!first) __syncthreads();  // the last row tile's products
        repro::stage_rows(M, sM, m, K, r * kNodesRows);
        staged = r;
      }
      first = false;
      __syncthreads();
      const int i = r * kNodesRows + lane;
      if (j0 + c0 >= D || i >= m) continue;  // past the ragged edges
      float acc[4] = {};
      repro::nodes_products(sq, sM, K, lane, c0, acc);
      const float wi = __ldg(w + i);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long j = j0 + c0 + c;
        if (j >= D) continue;
        const float corr = __fsub_rn(acc[c], __fmul_rn(wi, q_self[i * D + j]));
        o[i * D + j] = __fadd_rn(x[i * D + j], corr);
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  `block` must be a power of two
// in [32, 1024]; the shared memory is K * block floats.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int repro_shard_cmix(const void* x, const void* q_self,
                                const void* qs, const void* w, const void* M,
                                void* o, long long D, int m, int K, int block,
                                void* stream) {
  if (m < 1 || K < 1 || D < 1 || block < 32 || block > kMaxBlock ||
      (block & (block - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(K) * block * sizeof(float);
  if (smem > 48u * 1024u) {
    const cudaError_t e = cudaFuncSetAttribute(
        shard_cmix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = (D + block - 1) / block;
  shard_cmix_kernel<<<static_cast<unsigned>(grid), block, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(q_self),
      static_cast<const float*>(qs), static_cast<const float*>(w),
      static_cast<const float*>(M), static_cast<float*>(o), m, K, D);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point of the node-parallel instance (bound with ctypes):
// the arguments of repro_shard_cmix less `block`, then the grid, `grid_x`
// column tiles by `grid_y` row tiles at most (the blocks walk the rest).
// The shared memory is repro::nodes_smem(K).  Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int repro_shard_cmix_nodes(const void* x, const void* q_self,
                                      const void* qs, const void* w,
                                      const void* M, void* o, long long D,
                                      int m, int K, int grid_x, int grid_y,
                                      void* stream) {
  if (m < 1 || K < 1 || D < 1 || grid_x < 1 || grid_y < 1 ||
      grid_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = repro::nodes_smem(K);
  if (smem > 48u * 1024u) {
    const cudaError_t e = cudaFuncSetAttribute(
        shard_cmix_nodes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  shard_cmix_nodes_kernel<<<dim3(static_cast<unsigned>(grid_x),
                                 static_cast<unsigned>(grid_y)),
                            repro::kNodesBlock, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(q_self),
      static_cast<const float*>(qs), static_cast<const float*>(w),
      static_cast<const float*>(M), static_cast<float*>(o), m, K, D);
  return static_cast<int>(cudaGetLastError());
}
