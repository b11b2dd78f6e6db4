// Compressed global / pod-averaging round for Hopper (sm_90a), one pass over
// the packed node-major (n, D) parameter matrix.
//
// Replaces the TPU kernel `_collective_kernel`
// (src/repro/kernels/mixing_pallas.py, launched by `_collective_flat`).  Per
// QBLOCK-column scale block and node row i in pod p (rows p*per .. p*per +
// per - 1):
//
//   y   = x + e                                  (e: error feedback)
//   q1  = Q1(y)                                  stage-1 codes, dequantized
//   m_p = q1[p,0] + (sum_r (q1[p,r] - q1[p,0])) / per   anchored pod mean
//   o_i = x_i + (Q2(m_p) - Q2(q1_i))             stage 2 on both sides
//   e'  = y - q1
//
// with per-(row, block) power-of-two scales from the block absmax's
// exponent bits (quant.cuh `pow2_scale`, the reference's
// `pow2_block_scale`).  One thread block handles one scale block, so the
// tile *is* the scale block: its n row absmax reductions (stage 1), the
// n_pods absmax reductions over m and the n over q1 (stage 2) stay inside
// the block, no accumulator crosses blocks, and the grid order does not
// matter.  q1 lives in shared memory ([row][column]) between the phases;
// the stage-1 and stage-2 codes never reach device memory.
//
// The pod sum runs r = 0 .. per-1 in that order, as the plain twin
// (`collective_flat_plain`) does: the stage-2 decision depends on m's exact
// bits.  Equal rows give equal q1, the anchored mean returns it bitwise and
// Q2(m) == Q2(q1), so a constant state is a bitwise fixed point.
//
// What bounds it on the H100: bytes (x and e read, o and e' written; the
// codec is some 60 flops per element).  The ragged last block is masked
// (columns >= D count as zeros, which quantize to zero at every stage), so
// the wrapper pads nothing.  o may alias x and e' may alias e (the packed
// buffers are private): each element is written only by the thread that
// read it, after it read it.  x is read a second time in the last phase,
// mostly from L2.

#include <cuda_runtime.h>

#include "quant.cuh"

namespace {

enum Kind { kInt8 = 0, kFp8 = 1 };

template <int KIND>
__device__ __forceinline__ float quant(float y, float scale, uint32_t bits) {
  return KIND == kInt8 ? repro::int8_q(y, scale, repro::uniform_of(bits))
                       : repro::fp8_q(y, scale, bits);
}

// Anchored pod mean of column c from the stage-1 tile.
__device__ __forceinline__ float pod_mean(const float* sq, int qblock, int p,
                                          int per, int c) {
  const float anchor = sq[(p * per) * qblock + c];
  float s = 0.f;
  for (int r = 0; r < per; ++r)
    s = __fadd_rn(s, __fsub_rn(sq[(p * per + r) * qblock + c], anchor));
  return __fadd_rn(anchor, __fdiv_rn(s, static_cast<float>(per)));
}

template <int KIND, bool EF>
__global__ void collective_kernel(const float* x, const float* e, float* o,
                                  float* ef, uint32_t s1, uint32_t s2, int n,
                                  int n_pods, long long D, int qblock) {
  extern __shared__ float smem[];
  const int bd = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = bd >> 5;
  const int per = n / n_pods;
  const int shift = KIND == kInt8 ? 7 : 8;
  float* sq = smem;                                 // [n][qblock]
  float* red = sq + static_cast<size_t>(n) * qblock;  // [n_pods + n][nwarps]
  float* scales = red + (n_pods + n) * nwarps;      // stage 1: [n];
                                                    // stage 2: [n_pods + n]
  const long long base = static_cast<long long>(blockIdx.x) * qblock;

  // 1. y into shared memory, per-row absmax -> stage-1 scales
  for (int i = 0; i < n; ++i) {
    float m = 0.f;
    for (int c = t; c < qblock; c += bd) {
      const long long col = base + c;
      float y = 0.f;
      if (col < D) {
        y = x[i * D + col];
        if (EF) y = __fadd_rn(y, e[i * D + col]);
      }
      sq[i * qblock + c] = y;
      m = fmaxf(m, fabsf(y));
    }
    m = repro::warp_max(m);
    if (lane == 0) red[i * nwarps + warp] = m;
  }
  __syncthreads();
  if (t < n) {
    float m = 0.f;
    for (int k = 0; k < nwarps; ++k) m = fmaxf(m, red[t * nwarps + k]);
    scales[t] = repro::pow2_scale(m, shift);
  }
  __syncthreads();

  // 2. stage-1 codes in place; error feedback e' = y - q1.  Each thread
  // touches only its own columns, so no barrier is needed before 3.
  for (int c = t; c < qblock; c += bd) {
    const long long col = base + c;
    const uint32_t bits = repro::column_bits(s1, static_cast<uint32_t>(col));
    for (int i = 0; i < n; ++i) {
      const float y = sq[i * qblock + c];
      const float q = quant<KIND>(y, scales[i], bits);
      if (EF && col < D) ef[i * D + col] = __fsub_rn(y, q);
      sq[i * qblock + c] = q;
    }
  }

  // 3. stage-2 absmax: over m per pod, over q1 per row
  for (int p = 0; p < n_pods; ++p) {
    float m = 0.f;
    for (int c = t; c < qblock; c += bd)
      m = fmaxf(m, fabsf(pod_mean(sq, qblock, p, per, c)));
    m = repro::warp_max(m);
    if (lane == 0) red[p * nwarps + warp] = m;
  }
  for (int i = 0; i < n; ++i) {
    float m = 0.f;
    for (int c = t; c < qblock; c += bd) m = fmaxf(m, fabsf(sq[i * qblock + c]));
    m = repro::warp_max(m);
    if (lane == 0) red[(n_pods + i) * nwarps + warp] = m;
  }
  __syncthreads();  // also: every thread has read the stage-1 scales
  if (t < n_pods + n) {
    float m = 0.f;
    for (int k = 0; k < nwarps; ++k) m = fmaxf(m, red[t * nwarps + k]);
    scales[t] = repro::pow2_scale(m, shift);
  }
  __syncthreads();

  // 4. o = x + (Q2(m)[pod] - Q2(q1))
  for (int c = t; c < qblock; c += bd) {
    const long long col = base + c;
    if (col >= D) continue;
    const uint32_t bits = repro::column_bits(s2, static_cast<uint32_t>(col));
    for (int p = 0; p < n_pods; ++p) {
      const float r = quant<KIND>(pod_mean(sq, qblock, p, per, c), scales[p],
                                  bits);
      for (int k = 0; k < per; ++k) {
        const int i = p * per + k;
        const float rho = quant<KIND>(sq[i * qblock + c], scales[n_pods + i],
                                      bits);
        o[i * D + col] = __fadd_rn(x[i * D + col], __fsub_rn(r, rho));
      }
    }
  }
}

template <int KIND, bool EF>
cudaError_t launch(const float* x, const float* e, float* o, float* ef,
                   uint32_t s1, uint32_t s2, int n, int n_pods, long long D,
                   int qblock, int block, cudaStream_t s) {
  const int nwarps = block / 32;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n) * qblock +
                       static_cast<size_t>(n_pods + n) * nwarps + n_pods + n);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        collective_kernel<KIND, EF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long grid = (D + qblock - 1) / qblock;
  collective_kernel<KIND, EF><<<static_cast<unsigned>(grid), block, smem, s>>>(
      x, e, o, ef, s1, s2, n, n_pods, D, qblock);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  kind: 0 int8, 1 fp8.  `block`
// must be a multiple of 32 that divides `qblock`; n_pods must divide n.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_collective(const void* x, const void* e, void* o,
                                void* ef, unsigned int s1, unsigned int s2,
                                long long D, int n, int n_pods, int qblock,
                                int kind, int with_ef, int block,
                                void* stream) {
  if (n < 1 || D < 1 || n_pods < 1 || n % n_pods != 0 || qblock < 32 ||
      block < 32 || block > 1024 || block % 32 != 0 || qblock % block != 0 ||
      kind < 0 || kind > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* ef_in = static_cast<const float*>(e);
  float* of = static_cast<float*>(o);
  float* ef_out = static_cast<float*>(ef);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kind == kInt8)
    err = with_ef ? launch<kInt8, true>(xf, ef_in, of, ef_out, s1, s2, n,
                                        n_pods, D, qblock, block, s)
                  : launch<kInt8, false>(xf, ef_in, of, ef_out, s1, s2, n,
                                         n_pods, D, qblock, block, s);
  else
    err = with_ef ? launch<kFp8, true>(xf, ef_in, of, ef_out, s1, s2, n,
                                       n_pods, D, qblock, block, s)
                  : launch<kFp8, false>(xf, ef_in, of, ef_out, s1, s2, n,
                                        n_pods, D, qblock, block, s);
  return static_cast<int>(err);
}
