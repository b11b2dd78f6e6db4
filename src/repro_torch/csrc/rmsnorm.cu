// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) *
// (offset + w) over the last axis, the sum of squares in fp32.
//
// Replaces the TPU kernel `_rmsnorm_kernel` (src/repro/kernels/rmsnorm.py,
// launched by `rmsnorm`): per row, var = (sum_d x_d^2) / D, then
// (x_d * rsqrt(var + eps)) * (offset + w_d), in that order, rounded once
// to x's type.
//
// What bounds it on the H100: bytes.  Each element is read once and
// written once for about four operations, far below the card's ridge.
// One warp owns one row, and an xor-shuffle tree gives every lane the same
// sum of squares.  Two instances:
//
// * vector (rmsnorm_vec_kernel): a row in one read.  Each lane loads its
//   16-byte pieces of x (8 bf16 or fp16 values, or 4 fp32; lane l takes
//   pieces l, l + 32, ...) into NV registers of 16 bytes, sums their
//   squares, and scales them from the registers, with 16-byte loads of w
//   and 16-byte stores of y.  NV is a template argument (1, 2, 4, 8 or
//   16), so the row's registers have a compile-time count: up to 8192
//   bytes a row (3584 bf16 values take 14 pieces a lane, in NV = 16).
//   Blocks of two rows, so that a finished block frees its registers for
//   the next rows soon.  It takes rows whose bytes and stride are
//   multiples of 16 from 16-byte aligned pointers
//   (rmsnorm_cuda.use_vector).  The registers that hold the rows bound the
//   bytes in flight: at NV = 16 (160 registers a thread) 12 rows of 7 KB
//   a multiprocessor;
// * scalar (rmsnorm_kernel), every other row: the lanes stride the row
//   one element at a time, and read it twice (the second read from L1).
//
// Only the order of the sum of squares differs between the two.  The TPU
// kernel padded the rows to a multiple of its block and masked them; here
// a warp past the last row returns and nothing is padded.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
// the vector instance's blocks: two rows (faster than eight on the H100)
constexpr int kVecThreads = 64;
constexpr int kVecRowsPerBlock = kVecThreads / 32;
constexpr int kMaxVecBytes = 16 * 32 * 16;  // NV = 16 pieces a lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put(__half* p, float x) {
  *p = __float2half_rn(x);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
    long long n_rows, int D, long long row_stride, float eps, float offset) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const T* xr = x + row * row_stride;
  float ss = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = to_f32(xr[d]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  T* yr = y + row * D;
  for (int d = lane; d < D; d += 32)
    put(yr + d, (to_f32(xr[d]) * r) * (offset + to_f32(w[d])));
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i)
    f[i] = to_f32(e[i]);
}

template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kVecThreads) rmsnorm_vec_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
    long long n_rows, int D, long long row_stride, float eps, float offset) {
  constexpr int kPer = 16 / sizeof(T);       // values of x in 16 bytes
  constexpr int kW = kPer * sizeof(W) / 16;  // 16-byte pieces of w for them
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kVecRowsPerBlock +
                        (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int pieces = D / kPer;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * row_stride);
  uint4 xv[NV];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < pieces) {
      xv[i] = xr[lane + 32 * i];
      float f[kPer];
      unpack<T>(xv[i], f);
#pragma unroll
      for (int e = 0; e < kPer; ++e) ss = fmaf(f[e], f[e], ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* yr = reinterpret_cast<uint4*>(y + row * D);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int u = lane + 32 * i;
    if (u < pieces) {
      float f[kPer], g[kPer];
      unpack<T>(xv[i], f);
#pragma unroll
      for (int j = 0; j < kW; ++j)
        unpack<W>(wv[u * kW + j], g + j * (kPer / kW));
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        put(oe + e, (f[e] * r) * (offset + g[e]));
      yr[u] = out;
    }
  }
}

template <typename T, typename W, int NV>
int launch_vec(const void* x, const void* w, void* y, long long n_rows, int D,
               long long row_stride, float eps, float offset,
               cudaStream_t stream) {
  const long long blocks =
      (n_rows + kVecRowsPerBlock - 1) / kVecRowsPerBlock;
  rmsnorm_vec_kernel<T, W, NV><<<static_cast<unsigned>(blocks), kVecThreads,
                                 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      n_rows, D, row_stride, eps, offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* y, long long n_rows, int D,
           long long row_stride, float eps, float offset, int vector,
           cudaStream_t stream) {
  if (vector) {
    // the smallest instance whose NV pieces a lane cover the row
    const int per_lane = (D * static_cast<int>(sizeof(T)) / 16 + 31) / 32;
    if (per_lane <= 1)
      return launch_vec<T, W, 1>(x, w, y, n_rows, D, row_stride, eps,
                                 offset, stream);
    if (per_lane <= 2)
      return launch_vec<T, W, 2>(x, w, y, n_rows, D, row_stride, eps,
                                 offset, stream);
    if (per_lane <= 4)
      return launch_vec<T, W, 4>(x, w, y, n_rows, D, row_stride, eps,
                                 offset, stream);
    if (per_lane <= 8)
      return launch_vec<T, W, 8>(x, w, y, n_rows, D, row_stride, eps,
                                 offset, stream);
    return launch_vec<T, W, 16>(x, w, y, n_rows, D, row_stride, eps, offset,
                                stream);
  }
  const long long blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T, W><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      n_rows, D, row_stride, eps, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  x (n_rows, D) with unit stride
// along D and `row_stride` elements between rows, float32 (dtype = 0),
// bfloat16 (1) or float16 (2); w (D,) float32, or x's type when
// w_like_x != 0.  Writes y (n_rows, D) contiguous in x's type.  vector != 0
// takes the vector instance, which needs D and row_stride times the item
// size multiples of 16, at most kMaxVecBytes a row, and 16-byte aligned x,
// w and y.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y,
                             long long n_rows, int D, long long row_stride,
                             float eps, float offset, int dtype, int w_like_x,
                             int vector, void* stream) {
  if (n_rows < 1 || D < 1 || dtype < 0 || dtype > 2 ||
      (n_rows + kVecRowsPerBlock - 1) / kVecRowsPerBlock > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vector) {
    const long long size = dtype == 0 ? 4 : 2;
    const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                            reinterpret_cast<uintptr_t>(w) |
                            reinterpret_cast<uintptr_t>(y);
    if (D * size % 16 || row_stride * size % 16 || D * size > kMaxVecBytes ||
        align % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(x, w, y, n_rows, D, row_stride, eps, offset,
                                vector, cs);
  if (dtype == 1)
    return w_like_x ? launch<__nv_bfloat16, __nv_bfloat16>(
                          x, w, y, n_rows, D, row_stride, eps, offset, vector,
                          cs)
                    : launch<__nv_bfloat16, float>(x, w, y, n_rows, D,
                                                   row_stride, eps, offset,
                                                   vector, cs);
  return w_like_x ? launch<__half, __half>(x, w, y, n_rows, D, row_stride,
                                           eps, offset, vector, cs)
                  : launch<__half, float>(x, w, y, n_rows, D, row_stride, eps,
                                          offset, vector, cs);
}
