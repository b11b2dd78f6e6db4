// Shared pieces of the node-parallel instances of the round kernels
// (mix.cu, cmix.cu, shard_cmix.cu): the instances for node counts that have
// no register instance, the simulators' n = 100 among them.  They spread
// the n x n mix (shard_cmix: the m x K mix over the halo rows) over its
// outputs (i, j), not over the columns alone:
//
// * A block of kNodesBlock threads takes a tile of kNodesCols columns by
//   kNodesRows rows.  Warp w holds columns 4w .. 4w + 3 of the tile and
//   lane l row l, so a thread keeps 4 outputs, each its own chain, and the
//   warps of a block share the latency of one another's chains.
// * The tile's n staged operands (mix: x' = x - gamma g, wire-cast; cmix:
//   the codes) sit in shared memory as [k][j]: a warp reads the 4 values
//   of its columns at one address (a 16-byte broadcast).  The tile's rows
//   of M sit transposed as [k][i] at a pitch of kNodesRows + 1 words: the
//   lanes read consecutive words, and the staging writes (consecutive k)
//   fall in distinct banks.
// * Every output keeps the generic instances' chain, acc = 0, then
//   acc = acc + M_ik v_k for k = 0 .. n - 1 in order, each product and
//   sum rounded on its own (_rn): the bits are the generic instance's.
// * The grid is column tiles x row tiles, both walked in grid-stride
//   loops.  A block stages a column tile's operands once for all of its
//   row tiles, and a row tile's M once for all of its column tiles while
//   it keeps that row tile.  With gridDim.y = 1 a block takes every row
//   of its columns, reading all of them before it writes any: the mix may
//   then write o over x.
//
// The wrapper (kernels/mixing_cuda.py `nodes_plan`) picks the grid.  At
// n = 100, D = 10 (the simulators' round) it launches 1 x 4 blocks: 4 row
// tiles of 32 rows, 10 live columns, 4 chains of 100 terms a lane on 3
// warps a block; at n = 256, D = 10 a grid of 1 x 8.

#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kNodesBlock = 256;
constexpr int kNodesCols = 32;  // 8 warps x 4 columns
constexpr int kNodesRows = 32;  // one a lane
// Words between two k of a row tile's transposed M.
constexpr int kNodesPitch = kNodesRows + 1;

// Dynamic shared memory of a block: the column tile's n x kNodesCols
// operands, then the row tile's M (shard_cmix: n = K, the halo rows).
inline size_t nodes_smem(int n) {
  return 4ull * static_cast<size_t>(n) * (kNodesCols + kNodesPitch);
}

// Rows i0 .. min(i0 + kNodesRows, m) - 1 of the (m, K) factor M (row
// stride K; the round kernels' square M has m = K = n), transposed into
// sM[k * kNodesPitch + i - i0]; reads coalesced along k, unrolled so that
// a thread has several loads in flight.  Rows past m are not staged: the
// lanes that would read them store nothing.
__device__ __forceinline__ void stage_rows(const float* __restrict__ M,
                                           float* sM, int m, int K, int i0) {
  const int rows = m - i0 < kNodesRows ? m - i0 : kNodesRows;
#pragma unroll 8
  for (int q = threadIdx.x; q < rows * K; q += kNodesBlock) {
    const int i = q / K, k = q - i * K;
    sM[k * kNodesPitch + i] = M[(i0 + i) * K + k];
  }
}

// The columns of the tile at j0 that lie before D.  Columns past them are
// not staged: the outputs that would read them are not stored.
__device__ __forceinline__ int live_cols(long long j0, long long D) {
  return D - j0 < kNodesCols ? static_cast<int>(D - j0) : kNodesCols;
}

// acc[c] = sum over k = 0 .. n - 1 of M_{ik} v_{k, c0 + c}, in order, for
// the lane's row i = lane of the tile.
__device__ __forceinline__ void nodes_products(const float* sv,
                                               const float* sM, int n,
                                               int lane, int c0,
                                               float (&acc)[4]) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 t = *reinterpret_cast<const float4*>(sv + k * kNodesCols +
                                                      c0);
    const float v[4] = {t.x, t.y, t.z, t.w};
    const float m = sM[k * kNodesPitch + lane];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(m, v[c]));
  }
}

}  // namespace repro
