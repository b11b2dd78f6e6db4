// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (flash_attention_wgmma.cu, mlstm_wgmma.cu): mbarriers whose waits trap
// after 10 s, 4-D TMA copies, wgmma shared-memory descriptors with the
// 128-byte swizzle, the wgmma instructions at the shapes the kernels use,
// and the host-side encoding of a 4-D tensor map over a (B, S, heads, D)
// view.  Everything is in an anonymous namespace: each kernel's library
// gets its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits for the phase of the given parity to complete.  A wait that
// outlasts 10 s of the global timer traps (a launch error) rather than
// hold the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) t0 = now;
    if (now - t0 > 10000000000ull) asm volatile("trap;\n");
  }
}

// One TMA box {64 columns, rows, 1, 1} at (d0, s0, head, batch) into dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int s0,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0),
      "r"(s0), "r"(head), "r"(batch)
      : "memory");
}

// 2^x by the MUFU (relative error at most 2^-22; results below 2^-126 are
// 0, which only ever drops a p that l >= 1 outweighs by far).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets.  K-major
// operands: LBO unused (16), SBO 1024 (8 rows of 128 bytes).  MN-major
// operands: LBO the stride between 64-element atoms along M or N, SBO 1024
// (8 rows of the K axis).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma wrappers: "{%0, ...}" accumulator lists and their operands.
#define HP_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define HP_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63}"
#define HP_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define HP_OPS8(d, i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HP_OPS32(d) \
  HP_OPS8(d, 0), HP_OPS8(d, 8), HP_OPS8(d, 16), HP_OPS8(d, 24)
#define HP_OPS64(d) \
  HP_OPS32(d), HP_OPS8(d, 32), HP_OPS8(d, 40), HP_OPS8(d, 48), HP_OPS8(d, 56)
#define HP_OPS128(d)                                                         \
  HP_OPS64(d), HP_OPS8(d, 64), HP_OPS8(d, 72), HP_OPS8(d, 80),             \
      HP_OPS8(d, 88), HP_OPS8(d, 96), HP_OPS8(d, 104), HP_OPS8(d, 112),      \
      HP_OPS8(d, 120)

// d (+)= A B with A and B from shared memory; d is overwritten when
// accumulate == 0.  DA, DB, P: the operand numbers of the two descriptors
// and the flag; TR: the transpose immediates of A and B ("0, 0": both
// K-major; "1, 1": both MN-major).
#define HP_SS(N, DLIST, OPS, DA, DB, P, TY, TR)                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " " DLIST ", " DA ", " DB ", p, 1, 1, " TR ";\n}\n"         \
               : OPS(d)                                                    \
               : "l"(da), "l"(db), "r"(accumulate))

// d += A B with A from registers (four 32-bit registers of 16-bit pairs)
// and B from shared memory, MN-major (the transpose bit set).  A, DB, P:
// the operand numbers of the fragment, the descriptor and the flag (1).
#define HP_RS(N, DLIST, OPS, A, DB, P, TY)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " " DLIST ", " A ", " DB ", p, 1, 1, 1;\n}\n"               \
               : OPS(d)                                                    \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(1))

// A and B both K-major (the contraction runs over their contiguous axis).
template <bool kBf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (kBf16)
    HP_SS(64, HP_D32, HP_OPS32, "%32", "%33", "%34", "bf16", "0, 0");
  else
    HP_SS(64, HP_D32, HP_OPS32, "%32", "%33", "%34", "f16", "0, 0");
}

template <bool kBf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (kBf16)
    HP_SS(128, HP_D64, HP_OPS64, "%64", "%65", "%66", "bf16", "0, 0");
  else
    HP_SS(128, HP_D64, HP_OPS64, "%64", "%65", "%66", "f16", "0, 0");
}

// bf16, A and B both MN-major (the contraction runs over their rows).
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  HP_SS(64, HP_D32, HP_OPS32, "%32", "%33", "%34", "bf16", "1, 1");
}
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  HP_SS(128, HP_D64, HP_OPS64, "%64", "%65", "%66", "bf16", "1, 1");
}
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[128], uint64_t da,
                                            uint64_t db, int accumulate) {
  HP_SS(256, HP_D128, HP_OPS128, "%128", "%129", "%130", "bf16", "1, 1");
}

template <bool kBf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kBf16)
    HP_RS(64, HP_D32, HP_OPS32, "{%32, %33, %34, %35}", "%36", "%37",
          "bf16");
  else
    HP_RS(64, HP_D32, HP_OPS32, "{%32, %33, %34, %35}", "%36", "%37",
          "f16");
}

template <bool kBf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kBf16)
    HP_RS(128, HP_D64, HP_OPS64, "{%64, %65, %66, %67}", "%68", "%69",
          "bf16");
  else
    HP_RS(128, HP_D64, HP_OPS64, "{%64, %65, %66, %67}", "%68", "%69",
          "f16");
}

template <bool kBf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kBf16)
    HP_RS(256, HP_D128, HP_OPS128, "{%128, %129, %130, %131}", "%132",
          "%133", "bf16");
  else
    HP_RS(256, HP_D128, HP_OPS128, "{%128, %129, %130, %131}", "%132",
          "%133", "f16");
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The 4-D map {D, S, heads, B} over a (B, S, heads, D) view with element
// strides st = (B, S, heads) and a unit stride on D; boxes of 64 columns x
// rows, 128-byte swizzle, zeros out of bounds.  Returns the CUresult.
int encode(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int B,
           int S, int heads, int D, const long long* st, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return static_cast<int>(
      fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace
