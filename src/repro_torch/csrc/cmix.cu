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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "quant.cuh"

namespace {

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
