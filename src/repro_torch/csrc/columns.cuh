// Shared pieces of the register instances of the round kernels (mix.cu,
// cmix.cu): a thread holds VEC adjacent columns of every node row in
// registers, moves them with one 16-byte (8-, 4-byte) access a row, and
// walks the column groups in a grid-stride loop over a grid of as many
// blocks as the card holds at once.

#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kVecBlock = 256;

// Columns a thread holds at n nodes: 16 bytes a row at n <= 8, fewer as n
// grows, so an instance stays under about 128 registers without spilling.
__host__ __device__ constexpr int vec_width(int n) {
  return n <= 8 ? 4 : (n <= 16 ? 2 : 1);
}

// The node counts that have a register instance.
inline bool vector_nodes(int n) {
  return n == 4 || n == 8 || n == 16 || n == 32;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// 0, from an instruction the compiler cannot look through.  Indexing the
// block's shared copy of the weights with it keeps their loads inside the
// loop over column groups: hoisted out of it, the n^2 values took n^2
// registers and spilled from n = 16 on.
__device__ __forceinline__ int opaque_zero() {
  int z;
  asm volatile("mov.b32 %0, 0;" : "=r"(z));
  return z;
}

// The N weights of row i of a block's shared (N, N) matrix, by 16-byte
// loads (N a multiple of 4, the matrix 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_row(const float* sM, int i,
                                         float (&m)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 t = *reinterpret_cast<const float4*>(sM + i * N + k);
    m[k] = t.x; m[k + 1] = t.y; m[k + 2] = t.z; m[k + 3] = t.w;
  }
}

// Blocks of kVecBlock threads for `groups` column groups: one group a
// thread, at most as many blocks as the card holds at once.
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, long long groups, long long* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kVecBlock, 0);
  if (e != cudaSuccess) return e;
  const long long need = (groups + kVecBlock - 1) / kVecBlock;
  const long long resident = static_cast<long long>(sms) * per_sm;
  *grid = need < resident ? need : resident;
  return cudaSuccess;
}

}  // namespace repro
