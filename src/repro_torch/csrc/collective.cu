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
// matter.  The stage-1 and stage-2 codes never reach device memory.
//
// The pod sum runs r = 0 .. per-1 in that order, as the plain twin
// (`collective_flat_plain`) does: the stage-2 decision depends on m's exact
// bits.  Equal rows give equal q1, the anchored mean returns it bitwise and
// Q2(m) == Q2(q1), so a constant state is a bitwise fixed point.
//
// Three instances.  The tiled one (TILE) keeps q1 in shared memory
// ([row][column], 4·n·qblock bytes) between the phases; the untiled one
// keeps only the scales and the warp partials there and recomputes q1 from
// x, e and its stage-1 scale wherever a phase reads it, with the same
// operations, so the two agree bitwise.  The wrapper takes the tiled one
// while its tile fits the 227 KB a block may opt into (n <= 56 at a
// 1024-column block) and the untiled one above that.  The narrow one
// (`collective_narrow_kernel`, below) takes a round whose whole width is
// one scale block narrower than the wrapper's rule
// (kernels/mixing_cuda.py `use_narrow_collective`): the simulators' n = 100,
// D = 10 global round, where the other two spend one block of 256 threads
// on 1,024 column slots with 10 live, run the n row reductions one after
// another, and (untiled) recompute every q1 and each pod mean twice.
//
// What bounds it on the H100: bytes (x and e read, o and e' written; the
// codec is some 60 flops per element).  The ragged last block is masked
// (columns >= D count as zeros, which quantize to zero at every stage), so
// the wrapper pads nothing.  o may alias x and e' may alias e (the packed
// buffers are private): each column is read and written only by one
// thread, and each element is written after that thread's last read of
// it (the untiled instance writes e' in the last phase, with o).  x is
// read a second time in the last phase, mostly from L2; the untiled
// instance reads x and e four times.

#include <cuda_runtime.h>

#include "quant.cuh"

namespace {

enum Kind { kInt8 = 0, kFp8 = 1 };

template <int KIND>
__device__ __forceinline__ float quant(float y, float scale, uint32_t bits) {
  return KIND == kInt8 ? repro::int8_q(y, scale, repro::uniform_of(bits))
                       : repro::fp8_q(y, scale, bits);
}

// Anchored pod mean of column c, q1(i, c) giving the stage-1 codes.
template <typename Q1>
__device__ __forceinline__ float pod_mean(const Q1& q1, int p, int per,
                                          int c) {
  const float anchor = q1(p * per, c);
  float s = 0.f;
  for (int r = 0; r < per; ++r)
    s = __fadd_rn(s, __fsub_rn(q1(p * per + r, c), anchor));
  return __fadd_rn(anchor, __fdiv_rn(s, static_cast<float>(per)));
}

template <int KIND, bool EF, bool TILE>
__global__ void collective_kernel(const float* x, const float* e, float* o,
                                  float* ef, uint32_t s1, uint32_t s2, int n,
                                  int n_pods, long long D, int qblock) {
  extern __shared__ float smem[];
  const int bd = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = bd >> 5;
  const int per = n / n_pods;
  const int shift = KIND == kInt8 ? 7 : 8;
  float* sq = smem;                          // TILE: [n][qblock]
  float* red = sq + (TILE ? static_cast<size_t>(n) * qblock : 0);
                                             // [n_pods + n][nwarps]
  float* sc1 = red + (n_pods + n) * nwarps;  // stage 1: [n]
  float* sc2 = sc1 + n;                      // stage 2: [n_pods + n]
  const long long base = static_cast<long long>(blockIdx.x) * qblock;

  auto y_of = [&](int i, long long col) -> float {
    float y = x[i * D + col];
    if (EF) y = __fadd_rn(y, e[i * D + col]);
    return y;
  };
  // the stage-1 code of row i, column c (zero past D)
  auto q1 = [&](int i, int c) -> float {
    if (TILE) return sq[i * qblock + c];
    const long long col = base + c;
    if (col >= D) return 0.f;
    return quant<KIND>(y_of(i, col), sc1[i],
                       repro::column_bits(s1, static_cast<uint32_t>(col)));
  };

  // 1. per-row absmax of y -> stage-1 scales (TILE: y into shared memory)
  for (int i = 0; i < n; ++i) {
    float m = 0.f;
    for (int c = t; c < qblock; c += bd) {
      const long long col = base + c;
      const float y = col < D ? y_of(i, col) : 0.f;
      if (TILE) sq[i * qblock + c] = y;
      m = fmaxf(m, fabsf(y));
    }
    m = repro::warp_max(m);
    if (lane == 0) red[i * nwarps + warp] = m;
  }
  __syncthreads();
  for (int r = t; r < n; r += bd) {  // rows past the block's threads too
    float m = 0.f;
    for (int k = 0; k < nwarps; ++k) m = fmaxf(m, red[r * nwarps + k]);
    sc1[r] = repro::pow2_scale(m, shift);
  }
  __syncthreads();

  // 2. TILE: stage-1 codes in place; error feedback e' = y - q1.  Each
  // thread touches only its own columns, so no barrier is needed before 3.
  if (TILE) {
    for (int c = t; c < qblock; c += bd) {
      const long long col = base + c;
      const uint32_t bits =
          repro::column_bits(s1, static_cast<uint32_t>(col));
      for (int i = 0; i < n; ++i) {
        const float y = sq[i * qblock + c];
        const float q = quant<KIND>(y, sc1[i], bits);
        if (EF && col < D) ef[i * D + col] = __fsub_rn(y, q);
        sq[i * qblock + c] = q;
      }
    }
  }

  // 3. stage-2 absmax: over m per pod, over q1 per row
  for (int p = 0; p < n_pods; ++p) {
    float m = 0.f;
    for (int c = t; c < qblock; c += bd)
      m = fmaxf(m, fabsf(pod_mean(q1, p, per, c)));
    m = repro::warp_max(m);
    if (lane == 0) red[p * nwarps + warp] = m;
  }
  for (int i = 0; i < n; ++i) {
    float m = 0.f;
    for (int c = t; c < qblock; c += bd) m = fmaxf(m, fabsf(q1(i, c)));
    m = repro::warp_max(m);
    if (lane == 0) red[(n_pods + i) * nwarps + warp] = m;
  }
  __syncthreads();
  for (int r = t; r < n_pods + n; r += bd) {
    float m = 0.f;
    for (int k = 0; k < nwarps; ++k) m = fmaxf(m, red[r * nwarps + k]);
    sc2[r] = repro::pow2_scale(m, shift);
  }
  __syncthreads();

  // 4. o = x + (Q2(m)[pod] - Q2(q1)); untiled: e' = y - q1 here, after
  // this thread's last read of the column's x and e
  for (int c = t; c < qblock; c += bd) {
    const long long col = base + c;
    if (col >= D) continue;
    const uint32_t bits = repro::column_bits(s2, static_cast<uint32_t>(col));
    for (int p = 0; p < n_pods; ++p) {
      const float r = quant<KIND>(pod_mean(q1, p, per, c), sc2[p], bits);
      for (int k = 0; k < per; ++k) {
        const int i = p * per + k;
        const float q = q1(i, c);
        const float rho = quant<KIND>(q, sc2[n_pods + i], bits);
        const float xi = x[i * D + col];
        if (!TILE && EF) ef[i * D + col] = __fsub_rn(y_of(i, col), q);
        o[i * D + col] = __fadd_rn(xi, __fsub_rn(r, rho));
      }
    }
  }
}

// The narrow instance: one block over the whole (n, D) round, D at most one
// scale block.  The q1 tile holds the live columns only ([row][column],
// n·D floats) and the pod means one row a pod.  The elementwise phases
// (y, the codes and e', o) give element p = i·D + c to thread p mod
// blockDim in every phase, so the thread that writes an element is the one
// that read it (o may alias x, e' may alias e); the reductions take rows
// over warps and columns over lanes, one warp_max a row; each (pod,
// column) mean is one thread's chain r = 0 .. per - 1, made once and read
// from shared memory by the pod maxima and the output.  Columns past D
// count as zeros in the other instances' maxima and change none of them,
// so the bits are theirs.
template <int KIND, bool EF>
__global__ void collective_narrow_kernel(const float* x, const float* e,
                                         float* o, float* ef, uint32_t s1,
                                         uint32_t s2, int n, int n_pods,
                                         int D) {
  extern __shared__ float smem[];
  const int bd = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = bd >> 5;
  const int per = n / n_pods;
  const int shift = KIND == kInt8 ? 7 : 8;
  const int size = n * D;
  float* sq = smem;              // [n][D]: y, then the stage-1 codes
  float* pm = sq + size;         // [n_pods][D]: the pod means
  float* sc1 = pm + n_pods * D;  // stage 1: [n]
  float* sc2 = sc1 + n;          // stage 2: [n_pods + n]
  auto q1 = [&](int i, int c) -> float { return sq[i * D + c]; };

  // 1. y = x + e into the tile; the rows' absmax -> stage-1 scales
  for (int p = t; p < size; p += bd) {
    float y = x[p];
    if (EF) y = __fadd_rn(y, e[p]);
    sq[p] = y;
  }
  __syncthreads();
  for (int i = warp; i < n; i += nwarps) {
    float m = 0.f;
    for (int c = lane; c < D; c += 32) m = fmaxf(m, fabsf(sq[i * D + c]));
    m = repro::warp_max(m);
    if (lane == 0) sc1[i] = repro::pow2_scale(m, shift);
  }
  __syncthreads();

  // 2. stage-1 codes in place; e' = y - q1
  for (int p = t; p < size; p += bd) {
    const int i = p / D, c = p - i * D;
    const float y = sq[p];
    const float q = quant<KIND>(
        y, sc1[i], repro::column_bits(s1, static_cast<uint32_t>(c)));
    if (EF) ef[p] = __fsub_rn(y, q);
    sq[p] = q;
  }
  __syncthreads();

  // 3. the pod means, once each; stage-2 absmax over q1 per row, then over
  // the means per pod
  for (int q = t; q < n_pods * D; q += bd) {
    const int p = q / D, c = q - p * D;
    pm[q] = pod_mean(q1, p, per, c);
  }
  for (int i = warp; i < n; i += nwarps) {
    float m = 0.f;
    for (int c = lane; c < D; c += 32) m = fmaxf(m, fabsf(sq[i * D + c]));
    m = repro::warp_max(m);
    if (lane == 0) sc2[n_pods + i] = repro::pow2_scale(m, shift);
  }
  __syncthreads();
  for (int p = warp; p < n_pods; p += nwarps) {
    float m = 0.f;
    for (int c = lane; c < D; c += 32) m = fmaxf(m, fabsf(pm[p * D + c]));
    m = repro::warp_max(m);
    if (lane == 0) sc2[p] = repro::pow2_scale(m, shift);
  }
  __syncthreads();

  // 4. o = x + (Q2(m)[pod] - Q2(q1))
  for (int p = t; p < size; p += bd) {
    const int i = p / D, c = p - i * D;
    const int pod = i / per;
    const uint32_t bits = repro::column_bits(s2, static_cast<uint32_t>(c));
    const float r = quant<KIND>(pm[pod * D + c], sc2[pod], bits);
    const float rho = quant<KIND>(sq[p], sc2[n_pods + i], bits);
    o[p] = __fadd_rn(x[p], __fsub_rn(r, rho));
  }
}

template <int KIND, bool EF>
cudaError_t launch_narrow(const float* x, const float* e, float* o,
                          float* ef, uint32_t s1, uint32_t s2, int n,
                          int n_pods, int D, int block, cudaStream_t s) {
  const size_t smem = sizeof(float) *
                      (static_cast<size_t>(n + n_pods) * D + 2 * n + n_pods);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        collective_narrow_kernel<KIND, EF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  collective_narrow_kernel<KIND, EF><<<1, block, smem, s>>>(
      x, e, o, ef, s1, s2, n, n_pods, D);
  return cudaGetLastError();
}

template <int KIND, bool EF, bool TILE>
cudaError_t launch(const float* x, const float* e, float* o, float* ef,
                   uint32_t s1, uint32_t s2, int n, int n_pods, long long D,
                   int qblock, int block, cudaStream_t s) {
  const int nwarps = block / 32;
  const size_t smem =
      sizeof(float) * ((TILE ? static_cast<size_t>(n) * qblock : 0) +
                       static_cast<size_t>(n_pods + n) * nwarps + n_pods +
                       2 * static_cast<size_t>(n));
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        collective_kernel<KIND, EF, TILE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long grid = (D + qblock - 1) / qblock;
  collective_kernel<KIND, EF, TILE>
      <<<static_cast<unsigned>(grid), block, smem, s>>>(x, e, o, ef, s1, s2,
                                                        n, n_pods, D, qblock);
  return cudaGetLastError();
}

template <int KIND, bool EF>
cudaError_t launch_kind(const float* x, const float* e, float* o, float* ef,
                        uint32_t s1, uint32_t s2, int n, int n_pods,
                        long long D, int qblock, int block, int tiled,
                        cudaStream_t s) {
  return tiled ? launch<KIND, EF, true>(x, e, o, ef, s1, s2, n, n_pods, D,
                                        qblock, block, s)
               : launch<KIND, EF, false>(x, e, o, ef, s1, s2, n, n_pods, D,
                                         qblock, block, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  kind: 0 int8, 1 fp8; tiled:
// 1 for the instance with the q1 tile in shared memory, 0 for the one that
// recomputes it.  `block` must be a multiple of 32 that divides `qblock`;
// n_pods must divide n.  Returns cudaGetLastError() after the launch.
extern "C" int repro_collective(const void* x, const void* e, void* o,
                                void* ef, unsigned int s1, unsigned int s2,
                                long long D, int n, int n_pods, int qblock,
                                int kind, int with_ef, int block, int tiled,
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
    err = with_ef ? launch_kind<kInt8, true>(xf, ef_in, of, ef_out, s1, s2, n,
                                             n_pods, D, qblock, block, tiled,
                                             s)
                  : launch_kind<kInt8, false>(xf, ef_in, of, ef_out, s1, s2,
                                              n, n_pods, D, qblock, block,
                                              tiled, s);
  else
    err = with_ef ? launch_kind<kFp8, true>(xf, ef_in, of, ef_out, s1, s2, n,
                                            n_pods, D, qblock, block, tiled,
                                            s)
                  : launch_kind<kFp8, false>(xf, ef_in, of, ef_out, s1, s2,
                                             n, n_pods, D, qblock, block,
                                             tiled, s);
  return static_cast<int>(err);
}

// Plain C entry point of the narrow instance (bound with ctypes): the
// arguments of repro_collective less `qblock` and `tiled`; D at most
// 4,096 (the wrapper's rule takes D up to one scale block), `block` a
// multiple of 32 up to 1024.  Returns cudaGetLastError() after the launch.
extern "C" int repro_collective_narrow(const void* x, const void* e, void* o,
                                       void* ef, unsigned int s1,
                                       unsigned int s2, long long D, int n,
                                       int n_pods, int kind, int with_ef,
                                       int block, void* stream) {
  if (n < 1 || D < 1 || D > 4096 || n_pods < 1 || n % n_pods != 0 ||
      block < 32 || block > 1024 || block % 32 != 0 || kind < 0 || kind > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* ef_in = static_cast<const float*>(e);
  float* of = static_cast<float*>(o);
  float* ef_out = static_cast<float*>(ef);
  const int d = static_cast<int>(D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kind == kInt8)
    err = with_ef ? launch_narrow<kInt8, true>(xf, ef_in, of, ef_out, s1, s2,
                                               n, n_pods, d, block, s)
                  : launch_narrow<kInt8, false>(xf, ef_in, of, ef_out, s1,
                                                s2, n, n_pods, d, block, s);
  else
    err = with_ef ? launch_narrow<kFp8, true>(xf, ef_in, of, ef_out, s1, s2,
                                              n, n_pods, d, block, s)
                  : launch_narrow<kFp8, false>(xf, ef_in, of, ef_out, s1, s2,
                                               n, n_pods, d, block, s);
  return static_cast<int>(err);
}
