// Per-shard mixing round for Hopper (sm_90a): one pass over one node
// shard's (m, D) row-block of the packed parameter matrix.
//
// Replaces the TPU kernel `_shard_mix_kernel` (src/repro/kernels/
// mixing_pallas.py, launched by `shard_mix_block`).  Per column j, with the
// shard's m rows i and the K gathered halo rows k (the self block and the
// neighbour blocks of the round, already wire-cast by the caller):
//
//   o_i  = sum_k M_ik * xs_k + d_i * x_i       (x: the shard's uncast rows)
//   cs   = sum_i o_i                           (optional column sums, the
//                                               shard's partial of x-bar)
//
// What bounds it on the H100: bytes.  At m = 2 and K = 4 each column reads
// 6 floats and writes 3 for about 2mK + 3m flops, under 1 flop per byte,
// far below the ~20 flops per byte where the fp32 units would limit.  So
// every input element is read once and every output written once, one
// thread per column, neighbouring threads on neighbouring columns (each
// warp reads and writes whole 128-byte rows).  The thread keeps the
// column's K halo values in shared memory ([row][thread], conflict-free)
// and sums each output in the fixed order k = 0 .. K-1.
//
// The TPU grid ran in order; here blocks run in any order, and nothing
// carries between them: the column sums are per column, so each thread
// writes its own, and the sum over shards is a fixed-order pass in the
// caller (core/mixing.py `communicate_sharded`), never atomics.  The TPU
// kernel aliased x with o; in one process the shards run one after another
// and a later shard's halo reads the round's input rows, so o is always a
// buffer apart from x and xs (the wrapper checks it).  The ragged edge is
// masked, so no padding copy is made.  Products and sums use the _rn
// intrinsics so nvcc contracts nothing into an FMA.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 1024;

__global__ void shard_mix_kernel(const float* __restrict__ x,
                                 const float* __restrict__ xs,
                                 const float* __restrict__ d,
                                 const float* __restrict__ M,
                                 float* __restrict__ o,
                                 float* __restrict__ cs, int m, int K,
                                 long long D, int with_residual) {
  extern __shared__ float sxs[];
  const int bd = blockDim.x;
  const int t = threadIdx.x;
  const long long j = static_cast<long long>(blockIdx.x) * bd + t;
  if (j >= D) return;  // no barrier below: the ragged edge just stops
  for (int k = 0; k < K; ++k) sxs[k * bd + t] = xs[k * D + j];
  float colsum = 0.f;
  for (int i = 0; i < m; ++i) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(M + i * K + k), sxs[k * bd + t]));
    const float v = __fadd_rn(acc, __fmul_rn(__ldg(d + i), x[i * D + j]));
    o[i * D + j] = v;
    colsum = __fadd_rn(colsum, v);
  }
  if (with_residual) cs[j] = colsum;
}

}  // namespace

// Plain C entry point (bound with ctypes).  `block` must be a power of two
// in [32, 1024]; the shared memory is K * block floats.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int repro_shard_mix(const void* x, const void* xs, const void* d,
                               const void* M, void* o, void* cs,
                               long long D, int m, int K, int with_residual,
                               int block, void* stream) {
  if (m < 1 || K < 1 || D < 1 || block < 32 || block > kMaxBlock ||
      (block & (block - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(K) * block * sizeof(float);
  if (smem > 48u * 1024u) {
    const cudaError_t e = cudaFuncSetAttribute(
        shard_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = (D + block - 1) / block;
  shard_mix_kernel<<<static_cast<unsigned>(grid), block, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(xs),
      static_cast<const float*>(d), static_cast<const float*>(M),
      static_cast<float*>(o), static_cast<float*>(cs), m, K, D,
      with_residual);
  return static_cast<int>(cudaGetLastError());
}
