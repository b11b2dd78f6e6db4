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

#include <cuda_runtime.h>

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
