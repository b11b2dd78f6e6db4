// Flash attention forward on Hopper's tensor cores (sm_90a): the same
// function as csrc/flash_attention.cu, for bf16 and fp16 q, k, v, with
// both products on `wgmma` and the tiles brought in by TMA.
//
// Replaces the TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py, launched by `flash_attention`).
// For one query row i and the keys j the mask lets through (positions from
// 0 for q and k alike; j <= i if causal; j > i - window if windowed):
//
//   s_j   = softcap * tanh((q_i . k_j) * scale / softcap)   (or without cap)
//   m'    = max(m, max_j s_j)            masked s_j = -1e30, never -inf
//   p_j   = exp(s_j - m')                masked p_j = 0
//   acc   = acc * exp(m - m') + sum_j bf16(p_j) v_j
//   l     = l * exp(m - m') + sum_j p_j
//
// and o_i = acc / l (IEEE division), or 0 for a row with no valid key.
// q . k is exact in the fp32 accumulator (16-bit inputs); the one rounding
// the fp32 twin does not have is p to q's type before p . v, as wgmma's A
// operand: at most 2^-9 max|v| per output element in bf16, 2^-11 in fp16.
// The exps are MUFU ex2 on scores in log2 units, tanh is 1 - 2 / (1 +
// e^2y): both a few 1e-7 from expf and tanhf, far under that rounding.
//
// What bounds it on the H100: operations (4 D per unmasked pair and head)
// on the tensor cores at gemma2-9b's shapes; bytes (q, k, v, o once) at
// pga-lm-100m's short rows, where the softmax weighs as much as the
// products.  The design moves both products to `wgmma` (bf16/fp16 in,
// fp32 accumulate), keeps S, P and O in registers, and feeds the tiles by
// TMA ahead of use:
//
// * Block: 256 threads, two warpgroups, each owning 64 of the block's 128
//   query rows (wgmma's M = 64) of one (batch, query head); grid (B * H,
//   ceil(Sq / 128)), the query tiles with the most keys launched first.
//   GQA: query head h reads kv head h / (H / KH).
// * Tiles: the head dim is padded to D_pad = 64, 128 or 256 in shared
//   memory only, as 64-column atoms of 128 bytes with the 128-byte swizzle
//   that TMA writes and wgmma's descriptors read; the pad columns and the
//   rows past Sq or Sk are TMA's out-of-bounds zeros (keys >= Sk are
//   masked as well).  kv tiles of BK = 128 rows at D_pad = 128 and 64
//   otherwise; Q 128 x D_pad once, K and V through a ring of four stages
//   at D_pad = 64 (a tile's products there take less time than its load;
//   two blocks a multiprocessor) and two above (192 KB at D_pad = 256).
// * Copies: one 4-D tensor map per operand over its (B, S, H, D) view,
//   byte strides from the tensor's (so packed projection views load as
//   they are), encoded on the host with cuTensorMapEncodeTiled (through
//   cudaGetDriverEntryPoint: no -lcuda) and passed as __grid_constant__.
//   These helpers, the mbarriers and the wgmma wrappers are in hopper.cuh.
//   Thread 0 issues the loads: Q and the first kv tiles up front, then
//   tile i + stages into the stage tile i leaves, once both warpgroups
//   have released it (one `empty` mbarrier per stage, one `full` per K and
//   V tile): the next tiles' copies run under the current tile's products.
//   A warpgroup skips the products of a tile wholly outside its own rows'
//   keys (past the diagonal, before the window, rows past Sq), which is
//   exact; it still waits for the tile and releases it, so it never runs
//   ahead of the ring.
// * S = Q K^T: wgmma m64 n(BK) k16, A and B from shared memory, both
//   K-major (the contraction runs over D, the contiguous axis).
// * Softmax on the fp32 accumulator in registers: warp w, lane l of a
//   warpgroup hold rows 16 w + l / 4 and 16 w + l / 4 + 8, columns
//   8 j + 2 (l % 4) + {0, 1}; the row max is an xor shuffle over lanes 1
//   and 2, and each thread keeps its part of l, summed once at the end.
//   The masks are evaluated only on the tiles that cross an edge.
// * O += P V: P rounded to q's type in registers is wgmma's A operand (the
//   accumulator layout of S pairs up into the A fragment), B is the V tile
//   (MN-major, the transpose bit set); O, 64 x D_pad fp32 per warpgroup,
//   stays in registers and is rescaled by each row's alpha before.
// * Epilogue: __fdiv_rn(acc, l), or 0 where l == 0, rounded once to q's
//   type, written into the warpgroup's rows of the Q tile in the swizzled
//   layout (conflict-free), then stored by one TMA copy per 64 columns
//   (the out-of-bounds rows >= Sq and columns >= D are not written): whole
//   128-byte rows, where a thread's own 4-byte stores took a fifth of the
//   time.  No atomics: the result does not depend on scheduling.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBlockQ = 128;   // query rows per block, 64 per warpgroup
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;

__host__ __device__ constexpr int block_k(int dpad) {
  return dpad == 128 ? 128 : 64;
}

// kv tiles in flight: four of the short tiles at D_pad = 64, whose
// products take less time than a load, two above (all shared memory
// allows at D_pad = 256)
__host__ __device__ constexpr int stages(int dpad) {
  return dpad == 64 ? 4 : 2;
}

// Q, the K and V rings, 1024 bytes to align the swizzled tiles and 128 for
// the mbarriers (flash_attention_cuda.wgmma_smem_bytes mirrors it).
__host__ __device__ constexpr size_t smem_bytes(int dpad) {
  return 1024 + 2 * static_cast<size_t>(dpad) *
                    (kBlockQ + 2 * stages(dpad) * block_k(dpad)) +
         128;
}

static_assert(smem_bytes(64) * 2 <= kMaxSmem && smem_bytes(128) <= kMaxSmem &&
                  smem_bytes(256) <= kMaxSmem,
              "each instance fits its blocks a multiprocessor");

struct Params {
  int Sq, Sk, H, KH, D;
  float scale, cap;
  int has_cap, causal, has_window, window;
};

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads, DPAD == 64 ? 2 : 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, Params p) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BK = block_k(DPAD);
  constexpr int NA = DPAD / 64;  // 64-column atoms of the head dim
  constexpr int SN = BK / 2;     // S accumulator floats per thread
  constexpr int ON = DPAD / 2;   // O accumulator floats per thread
  constexpr int kStages = stages(DPAD);
  constexpr uint32_t kQBytes = kBlockQ * DPAD * 2;
  constexpr uint32_t kTileBytes = BK * DPAD * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = base;                              // [NA][kBlockQ][64]
  uint8_t* ks = qs + kQBytes;                      // [kStages][NA][BK][64]
  uint8_t* vs = ks + kStages * kTileBytes;         // [kStages][NA][BK][64]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(vs + kStages * kTileBytes);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;
  uint64_t* q_full = empty + kStages;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int b = blockIdx.x / p.H, h = blockIdx.x - b * p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int nq = min(kBlockQ, p.Sq - q0);
  // keys that may be unmasked for queries q0 .. q0 + nq - 1
  int k_lo = 0, k_hi = p.Sk;
  if (p.has_window) k_lo = max(0, q0 - p.window + 1);
  if (p.causal) k_hi = min(k_hi, q0 + nq);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  const CUtensorMap *mq = &tq, *mk = &tk, *mv = &tv;
  auto load_kv = [&](int i) {
    const int s = i % kStages, k0 = k_lo + i * BK;
    mbar_expect_tx(&full_k[s], kTileBytes);
#pragma unroll
    for (int a = 0; a < NA; ++a)
      tma_load(ks + s * kTileBytes + a * BK * 128, mk, &full_k[s], 64 * a,
               k0, kvh, b);
    mbar_expect_tx(&full_v[s], kTileBytes);
#pragma unroll
    for (int a = 0; a < NA; ++a)
      tma_load(vs + s * kTileBytes + a * BK * 128, mv, &full_v[s], 64 * a,
               k0, kvh, b);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kThreads / 32);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(q_full, kQBytes);
#pragma unroll
    for (int a = 0; a < NA; ++a)
      tma_load(qs + a * kBlockQ * 128, mq, q_full, 64 * a, q0, h, b);
    for (int i = 0; i < min(kStages, n_tiles); ++i) load_kv(i);
  }

  // this thread's rows (r = 0, 1) of the fragment, and its column offset
  const int wrow0 = q0 + wg * 64;                    // the warpgroup's first
  const int row0 = wrow0 + warp * 16 + (lane >> 2);  // and row0 + 8
  const int col0 = 2 * (lane & 3);
  float o[ON], s_acc[SN];
#pragma unroll
  for (int i = 0; i < ON; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < SN; ++i) s_acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
  const float scale_log2 = p.scale * kLog2e;
  const float cap_log2 = p.cap * kLog2e, cap_k = 2.f * scale_log2 / p.cap;

  // the keys this warpgroup's rows may see (none for rows past Sq)
  int wk_lo = 0, wk_hi = p.Sk;
  if (p.has_window) wk_lo = max(0, wrow0 - p.window + 1);
  if (p.causal) wk_hi = min(wk_hi, wrow0 + 64);
  if (wrow0 >= p.Sq) wk_hi = 0;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = k_lo + i * BK;

    // a tile wholly outside this warpgroup's keys leaves its (m, l, O)
    // as they are: it is only released, once it has arrived (so that the
    // warpgroup never runs ahead of the ring)
    if (k0 >= wk_hi || k0 + BK <= wk_lo) {
      mbar_wait(&full_k[s], parity);
      mbar_wait(&full_v[s], parity);
    } else {
      // S = Q K^T over the NA atoms of D, four k16 steps each
      mbar_wait(&full_k[s], parity);
      __syncwarp();
      const uint32_t k_addr = smem_u32(ks + s * kTileBytes);
      pin(s_acc);
      wg_fence();
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<kBf16>(s_acc,
                          desc(q_addr + a * kBlockQ * 128 + kk * 32, 16, 1024),
                          desc(k_addr + a * BK * 128 + kk * 32, 16, 1024),
                          (a | kk) != 0);
      wg_commit();
      wg_wait();
      pin(s_acc);

      // scores in log2 units, -1e30 where masked: the masks only on the
      // tiles that cross an edge
      const bool inner =
          k0 + BK <= p.Sk && (!p.causal || k0 + BK - 1 <= wrow0) &&
          (!p.has_window || k0 > wrow0 + 63 - p.window);
      auto valid = [&](int idx) {
        const int row = row0 + 8 * ((idx >> 1) & 1);
        const int col = k0 + 8 * (idx >> 2) + col0 + (idx & 1);
        return col < p.Sk && (!p.causal || col <= row) &&
               (!p.has_window || col > row - p.window);
      };
      auto score = [&](float x) {
        if (!p.has_cap) return x * scale_log2;
        // cap tanh(y) log2 e, y = x scale / cap, as cap log2 e (1 - 2 /
        // (1 + e^2y)): one ex2 and one reciprocal (absolute error ~1e-7
        // of tanh, a few 1e-6 of the score at cap = 50)
        return cap_log2 - __fdividef(2.f * cap_log2, 1.f + ex2(x * cap_k));
      };
      float mx[2] = {kNegInf, kNegInf};
      if (inner) {
#pragma unroll
        for (int idx = 0; idx < SN; ++idx) {
          s_acc[idx] = score(s_acc[idx]);
          mx[(idx >> 1) & 1] = fmaxf(mx[(idx >> 1) & 1], s_acc[idx]);
        }
      } else {
#pragma unroll
        for (int idx = 0; idx < SN; ++idx) {
          s_acc[idx] = valid(idx) ? score(s_acc[idx]) : kNegInf;
          mx[(idx >> 1) & 1] = fmaxf(mx[(idx >> 1) & 1], s_acc[idx]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      if (inner) {
#pragma unroll
        for (int idx = 0; idx < SN; ++idx) {
          s_acc[idx] = ex2(s_acc[idx] - m[(idx >> 1) & 1]);
          l[(idx >> 1) & 1] += s_acc[idx];
        }
      } else {
#pragma unroll
        for (int idx = 0; idx < SN; ++idx) {
          s_acc[idx] =
              valid(idx) ? ex2(s_acc[idx] - m[(idx >> 1) & 1]) : 0.f;
          l[(idx >> 1) & 1] += s_acc[idx];
        }
      }
      // P as wgmma's A fragments, one per k16 slice of the tile's keys
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] =
              pack2<T>(s_acc[8 * kk + 2 * e], s_acc[8 * kk + 2 * e + 1]);
#pragma unroll
      for (int idx = 0; idx < ON; ++idx) o[idx] *= alpha[(idx >> 1) & 1];

      // O += P V, BK / 16 k16 steps over the V tile's rows
      mbar_wait(&full_v[s], parity);
      __syncwarp();
      const uint32_t v_addr = smem_u32(vs + s * kTileBytes);
      pin(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<kBf16>(o, pa[kk],
                        desc(v_addr + kk * 16 * 128, BK * 128, 1024));
      wg_commit();
      wg_wait();
      pin(o);
    }

    // release the stage; thread 0 refills it with tile i + kStages
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (tid == 0 && i + kStages < n_tiles) {
      mbar_wait(&empty[s], parity);
      load_kv(i + kStages);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // O / l into this warpgroup's rows of the Q tile (no longer read), in
  // the swizzled layout TMA reads; one thread stores the 64 x D_pad tile
  if (wrow0 >= p.Sq) return;
  uint8_t* oq = qs + wg * 64 * 128;
#pragma unroll
  for (int idx = 0; idx < ON; idx += 2) {
    const int r = (idx >> 1) & 1, j = idx >> 2;
    const int rl = warp * 16 + (lane >> 2) + 8 * r;  // row in the tile
    const bool has_key = l[r] > 0.f;
    *reinterpret_cast<uint32_t*>(
        oq + (j / 8) * kBlockQ * 128 + rl * 128 + (((j % 8) ^ (rl & 7)) * 16) +
        (lane & 3) * 4) =
        pack2<T>(has_key ? __fdiv_rn(o[idx], l[r]) : 0.f,
                 has_key ? __fdiv_rn(o[idx + 1], l[r]) : 0.f);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (wg == 0)  // named barriers 1 and 2: each warpgroup's 128 threads
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  if ((tid & 127) == 0) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
      asm volatile(
          "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
          " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
              reinterpret_cast<uint64_t>(&to)),
          "r"(smem_u32(oq + a * kBlockQ * 128)), "r"(64 * a), "r"(wrow0),
          "r"(h), "r"(b)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <typename T, int DPAD>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, const Params& p, int B, cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap tq, tk, tv, to;
  const long long so[3] = {static_cast<long long>(p.Sq) * p.H * p.D,
                           static_cast<long long>(p.H) * p.D, p.D};
  int r = encode(&tq, q, type, B, p.Sq, p.H, p.D, st, kBlockQ);
  if (r == 0) r = encode(&tk, k, type, B, p.Sk, p.KH, p.D, st + 3,
                         block_k(DPAD));
  if (r == 0) r = encode(&tv, v, type, B, p.Sk, p.KH, p.D, st + 6,
                         block_k(DPAD));
  if (r == 0) r = encode(&to, o, type, B, p.Sq, p.H, p.D, so, 64);
  if (r != 0) return 1000 + r;
  const size_t smem = smem_bytes(DPAD);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<T, DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(B) * p.H,
                  (p.Sq + kBlockQ - 1) / kBlockQ);
  flash_wgmma_kernel<T, DPAD><<<grid, kThreads, smem, stream>>>(tq, tk, tv,
                                                                to, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dpad(const void* q, const void* k, const void* v, void* o,
                const long long* st, const Params& p, int B,
                cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64>(q, k, v, o, st, p, B, stream);
  if (p.D <= 128) return launch<T, 128>(q, k, v, o, st, p, B, stream);
  return launch<T, 256>(q, k, v, o, st, p, B, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes), with the arguments of
// repro_flash_attention: q (B, Sq, H, D), k and v (B, Sk, KH, D), bfloat16
// (dtype = 1) or float16 (2); `strides` holds the 9 element strides of the
// (B, S, H) axes of q, k, v, each a positive multiple of 8, with a unit
// stride on D, D % 8 == 0, D <= 256 and 16-byte aligned pointers.  Writes o
// (B, Sq, H, D) contiguous.  Returns cudaGetLastError() after the launch
// (0 = success), or 1000 + the CUresult of a tensor map that
// cuTensorMapEncodeTiled refused.
extern "C" int repro_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* o,
    const void* strides, int B, int Sq, int Sk, int H, int KH, int D,
    float scale, int has_cap, float cap, int causal, int has_window,
    int window, int dtype, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  bool ok = B >= 1 && Sq >= 1 && Sk >= 1 && H >= 1 && KH >= 1 && H % KH == 0 &&
            D >= 8 && D <= 256 && D % 8 == 0 && (dtype == 1 || dtype == 2) &&
            (Sq + kBlockQ - 1) / kBlockQ <= 65535;
  for (int i = 0; i < 9; ++i) ok = ok && st[i] > 0 && st[i] % 8 == 0;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* ptr : ptrs)
    ok = ok && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KH = KH;
  p.D = D;
  p.scale = scale;
  p.cap = cap;
  p.has_cap = has_cap;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_dpad<__nv_bfloat16>(q, k, v, o, st, p, B, cs)
                    : launch_dpad<__half>(q, k, v, o, st, p, B, cs);
}
