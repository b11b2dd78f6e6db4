// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) *
// (offset + w) over the last axis, the sum of squares in fp32.
//
// Replaces the TPU kernel `_rmsnorm_kernel` (src/repro/kernels/rmsnorm.py,
// launched by `rmsnorm`): per row, var = (sum_d x_d^2) / D, then
// (x_d * rsqrt(var + eps)) * (offset + w_d), in that order, rounded once
// to x's type.
//
// What bounds it on the H100: bytes.  Each element is read twice (the
// second read of a row comes from L1) and written once for about four
// operations, far below the card's ridge.  One warp owns one row: the
// lanes stride the row (neighbouring lanes on neighbouring elements), sum
// their squares, and an xor-shuffle tree gives every lane the same total.
// The TPU kernel padded the rows to a multiple of its block and masked
// them; here a warp past the last row returns and nothing is padded.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

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

template <typename T, typename W>
int launch(const void* x, const void* w, void* y, long long n_rows, int D,
           long long row_stride, float eps, float offset,
           cudaStream_t stream) {
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
// w_like_x != 0.  Writes y (n_rows, D) contiguous in x's type.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y,
                             long long n_rows, int D, long long row_stride,
                             float eps, float offset, int dtype, int w_like_x,
                             void* stream) {
  if (n_rows < 1 || D < 1 || dtype < 0 || dtype > 2 ||
      (n_rows + kRowsPerBlock - 1) / kRowsPerBlock > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(x, w, y, n_rows, D, row_stride, eps, offset,
                                cs);
  if (dtype == 1)
    return w_like_x ? launch<__nv_bfloat16, __nv_bfloat16>(
                          x, w, y, n_rows, D, row_stride, eps, offset, cs)
                    : launch<__nv_bfloat16, float>(x, w, y, n_rows, D,
                                                   row_stride, eps, offset,
                                                   cs);
  return w_like_x ? launch<__half, __half>(x, w, y, n_rows, D, row_stride,
                                           eps, offset, cs)
                  : launch<__half, float>(x, w, y, n_rows, D, row_stride, eps,
                                          offset, cs);
}
