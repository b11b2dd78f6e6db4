// Chunkwise mLSTM forward on Hopper's tensor cores (sm_90a): the function of
// csrc/mlstm.cu for bf16 q, k, v, with its four products on `wgmma` and the
// chunk tiles brought in by TMA.
//
// Replaces the TPU kernel `_mlstm_kernel` (src/repro/kernels/mlstm_chunk.py,
// launched by `mlstm_chunk`), as mlstm.cu does; see mlstm.cu for the
// recurrence.  Per (batch b, head h) and chunk of L = 64 positions, with F
// the inclusive cumulative sum of log f inside the chunk, w[t][u] = F_t -
// F_u + li_u (u <= t) and the stabilizers m_t, m_end:
//
//   S     = Q K^T                          (wgmma 1, fp32 accumulate)
//   P     = S * exp(w - m_t)               (fp32, causal mask)
//   H     = ((Q C) sgate + P V) / den      (wgmma 2 and 3)
//   C^T  <- C^T decay + V^T (k kg)         (wgmma 4), n and m as mlstm.cu
//
// What bounds it on the H100: bytes.  At the serving shape (B = 8, S = 2048,
// nh = 8, dk = 96, dv = 192) the function reads q, k, v (bf16) and the two
// gates once and writes h and the final state once: 156.8 MB, 0.0468 ms at
// 3.35 TB/s, against 12.1 GFLOP, 0.0123 ms at the bf16 tensor cores' 989
// TFLOP/s.  mlstm.cu, with every product an fp32 FMA on shared-memory
// operands and one thread for F, m_end and kg, ran at 1.3% of that bound.
// This design:
//
// * Block: one warpgroup (128 threads) per (b, h) and 64 columns of dv
//   (wgmma's M); grid (B * nh, ceil(dv / 64)).  It walks the chunks in
//   order with C^T (64 dv rows x dk_pad) in fp32 registers, as the TPU's
//   "arbitrary" grid axis carried it in VMEM.  The blocks of one (b, h)
//   recompute the chunk's scores and gates, as mlstm.cu's do; in exchange
//   the grid has three times the blocks, which B = 1 (the batched server's
//   admissions) needs.  Two blocks fit a multiprocessor at dk_pad = 128
//   (wgmma_smem_bytes in mlstm_cuda.py mirrors smem_bytes).
// * Tiles: Q, K (64 x dk_pad) and V (64 x 64) of a chunk by TMA from 4-D
//   tensor maps over the (B, S, nh, d) views, byte strides from the
//   tensors (the model's einsum outputs load as they are), in 64-column
//   atoms of 128 bytes with the 128-byte swizzle that TMA writes and the
//   wgmma descriptors read.  dk is padded to dk_pad = 64, 128 or 256 and
//   the ragged last chunk to 64 rows by TMA's out-of-bounds zeros (dk = 96
//   pads to 128; the zero columns are skipped in the dk contractions).  A
//   ring of two stages: chunk c + 1 loads while chunk c computes; every
//   mbarrier wait traps after 10 s.  The gates are plain loads, prefetched
//   one chunk ahead.
// * Products, bf16 in, fp32 accumulated:
//   - S = Q K^T, m64 n64 k16, both K-major;
//   - O = Q C, m64 n64 k16: C^T staged in shared memory as bf16 each chunk
//     (K-major, one rounding of C), in the same wgmma group as S;
//   - O = O sgate + P V: P rounded to bf16 in registers is the A operand
//     (the accumulator layout of S pairs up into the A fragment), V
//     MN-major;
//   - C^T = C^T decay + V^T (k kg): A = the V tile (MN-major), B = k kg in
//     fp32 split as bf16 hi + mid + lo (three wgmmas, |k kg - hi - mid -
//     lo| <= 2^-27 |k kg|), written over the K tile (hi), the Q tile (mid)
//     and the C^T tile (lo) once S, q C and q . n are done; m64 n(dk_pad)
//     k16.  With a hi + lo pair (2^-18 of each term) the emulated state
//     came within a small factor of its 1e-5 gate; the third term costs
//     4 k-steps.
// * Gates on all threads: F by a warp scan in double (exact for the
//   chunk's 64 fp32 terms as in mlstm.cu, so the same F as the twin's
//   double cumsum and the same m bit for bit); w - m_t and the causal mask
//   on the S accumulator's registers (row maxima by xor shuffles over the
//   four lanes of a row); m_end, kg and decay by every warp at once; n and
//   q . n in fp32 on the CUDA cores (a column per thread; four lanes per
//   row).  exp is expf and the divisions IEEE; no fast-math flag.
// * h: divided and rounded once to bf16 in registers, written into an h
//   tile in the swizzled layout and stored by one TMA copy per chunk (rows
//   past S and columns past dv are not written).  The tile is its own, not
//   the V tile's: then the refill of a stage never waits for a store (a
//   wait that held up the warpgroup's products every chunk), and the store
//   of chunk c has all of chunk c + 1's products to read it.
// * No atomics: the result does not depend on scheduling.
//
// Precision against the fp32 twin (mlstm_cuda.mlstm_chunk_plain): q . k is
// exact in the fp32 accumulator up to the order of the sum; P and C are
// each rounded once to bf16, which adds at most 2^-9 (sum_u |p||v| +
// sum_i |q||C| sgate) / den to an element of h, within 2^-9 of the twin's
// error scale each: u = 2^-8 in the gate |h - ex| <= 8e-3 |ex| + (u + 1e-5)
// (|ex| + scale) (mlstm_cuda.WGMMA_UNIT).  The carried state keeps mlstm.cu's
// gate, 1e-5 max|ref|, through the three-term split.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;      // one warpgroup
constexpr int kL = 64;             // chunk rows, wgmma's M
constexpr int kTileV = 64;         // dv columns per block
constexpr uint32_t kAtom = 8192;   // 64 rows x 128 bytes
constexpr float kNegBig = -1e9f;

// Element strides of the (B, S, nh) axes of the gates.
struct Gates {
  long long li[3], lf[3];
};

// The two stages (Q, K, V tiles), the C^T tile, the h tile, n, each
// warp's F, li and kg, the two mbarriers, and 1024 bytes to align the
// swizzled tiles (mlstm_cuda.wgmma_smem_bytes mirrors it).
__host__ __device__ constexpr size_t smem_bytes(int dkpad) {
  return 1024 + 2 * (2 * static_cast<size_t>(dkpad) * 128 + kAtom) +
         static_cast<size_t>(dkpad) * 128 + kAtom + 4 * dkpad +
         4 * 3 * kL * 4 + 16;
}

static_assert(2 * (smem_bytes(128) + 1024) <= 233472,
              "two blocks a multiprocessor at dk_pad = 128");
static_assert(smem_bytes(256) <= 232448, "dk_pad = 256 fits a block");

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float bf16_at(const uint8_t* tile, int row,
                                         int col) {
  // element (row, col) of a tile of 64-column atoms, 128-byte swizzle
  const int a = col >> 6, c = col & 63;
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
      tile + a * kAtom + row * 128 + ((((c >> 3) ^ (row & 7))) << 4) +
      (c & 7) * 2));
}

template <int DKPAD>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap th,
                       const float* __restrict__ li,
                       const float* __restrict__ lf, Gates g,
                       float* __restrict__ C_out, float* __restrict__ n_out,
                       float* __restrict__ m_out, int S, int nh, int dk,
                       int dv) {
  constexpr int NA = DKPAD / 64;          // 64-column atoms of dk
  constexpr int CN = DKPAD / 2;           // C^T accumulator floats a thread
  constexpr uint32_t kQK = NA * kAtom;    // bytes of a Q or K tile
  constexpr uint32_t kStage = 2 * kQK + kAtom;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* cs = base + 2 * kStage;        // [NA][64 dv rows][64 dk], bf16
  uint8_t* hs = cs + kQK;                 // [64 rows][64 dv], bf16
  float* nsm = reinterpret_cast<float*>(hs + kAtom);    // n, DKPAD
  float* wsm = nsm + DKPAD;               // [4 warps][F, li, kg][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + 4 * 3 * kL);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / nh, hd = bh - b * nh;
  const int v0 = blockIdx.y * kTileV;
  const int nc = (S + kL - 1) / kL;
  float* Fw = wsm + warp * 3 * kL;        // this warp's copy of F
  float* Lw = Fw + kL;                    // li
  float* Gw = Lw + kL;                    // kg
  const CUtensorMap *mq = &tq, *mk = &tk, *mv = &tv;

  auto load = [&](int c) {  // chunk c's tiles into stage c & 1 (thread 0)
    const int s = c & 1;
    uint8_t* st = base + s * kStage;
    mbar_expect_tx(&full[s], kStage);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      tma_load(st + a * kAtom, mq, &full[s], 64 * a, c * kL, hd, b);
      tma_load(st + kQK + a * kAtom, mk, &full[s], 64 * a, c * kL, hd, b);
    }
    tma_load(st + 2 * kQK, mv, &full[s], v0, c * kL, hd, b);
  };

  const float* lib = li + b * g.li[0] + hd * g.li[2];
  const float* lfb = lf + b * g.lf[0] + hd * g.lf[2];
  // the gates of rows lane and lane + 32 of chunk c (padding past S)
  auto gates = [&](int c, float (&gi)[2], float (&gf)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long s = static_cast<long long>(c) * kL + lane + 32 * r;
      gi[r] = s < S ? lib[s * g.li[1]] : kNegBig;
      gf[r] = s < S ? lfb[s * g.lf[1]] : 0.f;
    }
  };

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < static_cast<int>(kQK / 16); e += kThreads)
    reinterpret_cast<uint4*>(cs)[e] = make_uint4(0, 0, 0, 0);
  for (int d = tid; d < DKPAD; d += kThreads) nsm[d] = 0.f;
  fence_async();
  __syncthreads();
  if (tid == 0) {
    load(0);
    if (nc > 1) load(1);
  }

  // this thread's rows r0, r0 + 8 of a 64-row fragment, and column offset
  const int r0 = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  float c_acc[CN], s_acc[32], o[32];
#pragma unroll
  for (int i = 0; i < CN; ++i) c_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s_acc[i] = o[i] = 0.f;
  float m_prev = kNegBig;
  float gi[2], gf[2];
  gates(0, gi, gf);
  const uint32_t c_addr = smem_u32(cs);

  for (int c = 0; c < nc; ++c) {
    const int s = c & 1;
    uint8_t* qs = base + s * kStage;
    uint8_t* ks = qs + kQK;
    uint8_t* vs = ks + kQK;
    const uint32_t q_addr = smem_u32(qs), k_addr = smem_u32(ks),
                   v_addr = smem_u32(vs);
    // the other stage, which chunk c - 1 left, takes chunk c + 1
    if (tid == 0 && c >= 1 && c + 1 < nc) load(c + 1);
    const float li_r[2] = {gi[0], gi[1]}, lf_r[2] = {gf[0], gf[1]};
    if (c + 1 < nc) gates(c + 1, gi, gf);
    mbar_wait(&full[s], (c >> 1) & 1);

    // S = Q K^T and O = Q C over the 16-column steps of dk that hold data
    pin(s_acc);
    pin(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DKPAD / 16; ++kk) {
      if (kk * 16 < dk) {
        const uint32_t off = (kk >> 2) * kAtom + (kk & 3) * 32;
        const uint64_t da = desc(q_addr + off, 16, 1024);
        wgmma_ss<true>(s_acc, da, desc(k_addr + off, 16, 1024), kk != 0);
        wgmma_ss<true>(o, da, desc(c_addr + off, 16, 1024), kk != 0);
      }
    }
    wg_commit();

    // under the products: F, m_end, kg and decay, in every warp
    double x[2] = {lf_r[0], lf_r[1]};
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const double y = __shfl_up_sync(0xffffffffu, x[r], off);
        if (lane >= off) x[r] += y;
      }
    }
    x[1] += __shfl_sync(0xffffffffu, x[0], 31);
    const float F[2] = {static_cast<float>(x[0]), static_cast<float>(x[1])};
    const float FL = __shfl_sync(0xffffffffu, F[1], 31);
    float we[2], wmax = -INFINITY;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      Fw[lane + 32 * r] = F[r];
      Lw[lane + 32 * r] = li_r[r];
      we[r] = (FL - F[r]) + li_r[r];
      wmax = fmaxf(wmax, we[r]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
    const float m_fl = m_prev + FL;
    const float m_end = fmaxf(wmax, m_fl);
    const float decay = expf(m_fl - m_end);
#pragma unroll
    for (int r = 0; r < 2; ++r) Gw[lane + 32 * r] = expf(we[r] - m_end);
    __syncwarp();

    wg_wait();
    pin(s_acc);
    pin(o);

    // P on the accumulator: element idx is row r0 + 8 ((idx >> 1) & 1),
    // column 8 (idx >> 2) + col0 + (idx & 1)
    const float Ft[2] = {Fw[r0], Fw[r0 + 8]};
    float mt[2], sg[2], psum[2] = {0.f, 0.f}, den[2], qn[2] = {0.f, 0.f};
    {
      float wm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const int r = (idx >> 1) & 1, u = 8 * (idx >> 2) + col0 + (idx & 1);
        if (u <= r0 + 8 * r) wm[r] = fmaxf(wm[r], (Ft[r] - Fw[u]) + Lw[u]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wm[r] = fmaxf(wm[r], __shfl_xor_sync(0xffffffffu, wm[r], 1));
        wm[r] = fmaxf(wm[r], __shfl_xor_sync(0xffffffffu, wm[r], 2));
        const float m_in = m_prev + Ft[r];
        mt[r] = fmaxf(wm[r], m_in);
        sg[r] = expf(m_in - mt[r]);
      }
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const int r = (idx >> 1) & 1, u = 8 * (idx >> 2) + col0 + (idx & 1);
        const float p =
            u <= r0 + 8 * r
                ? s_acc[idx] * expf(((Ft[r] - Fw[u]) + Lw[u]) - mt[r])
                : 0.f;
        s_acc[idx] = p;
        psum[r] += p;
      }
    }
    // q_t . n: the four lanes of a row take every fourth 8-column chunk
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r0 + 8 * r;
      for (int ch = lane & 3; ch * 8 < dk; ch += 4) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            qs + (ch >> 3) * kAtom + t * 128 + (((ch & 7) ^ (t & 7)) << 4));
        const __nv_bfloat162* q2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(q2[e]);
          qn[r] = fmaf(f.x, nsm[8 * ch + 2 * e], qn[r]);
          qn[r] = fmaf(f.y, nsm[8 * ch + 2 * e + 1], qn[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], 1);
      qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], 2);
      den[r] = fmaxf(fabsf(psum[r] + __fmul_rn(qn[r], sg[r])),
                     expf(-mt[r]));
    }
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) o[idx] *= sg[(idx >> 1) & 1];
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack2<__nv_bfloat16>(s_acc[8 * kk + 2 * e],
                                         s_acc[8 * kk + 2 * e + 1]);

    // n <- n decay + sum_u k_u kg_u: a column a thread, four partial sums
    constexpr int kNCols = (DKPAD + kThreads - 1) / kThreads;
    float n_new[kNCols];
#pragma unroll
    for (int i = 0; i < kNCols; ++i) {
      const int d = tid + kThreads * i;
      n_new[i] = 0.f;
      if (d < dk) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < kL; u += 4)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] = __fadd_rn(acc[j],
                               __fmul_rn(bf16_at(ks, u + j, d), Gw[u + j]));
        n_new[i] = __fadd_rn(__fmul_rn(nsm[d], decay),
                             __fadd_rn(__fadd_rn(acc[0], acc[1]),
                                       __fadd_rn(acc[2], acc[3])));
      }
    }
    __syncthreads();  // q . n and the reads of K are done
#pragma unroll
    for (int i = 0; i < kNCols; ++i)
      if (tid + kThreads * i < dk) nsm[tid + kThreads * i] = n_new[i];
    // k kg as bf16 hi (over the K tile) + mid (over the Q tile) + lo (over
    // the C^T tile), 16 bytes at a time: the layout of K is the MN-major B
    // operand's.  Each remainder is exact in fp32.
    for (int e = tid; e < NA * 512; e += kThreads) {
      const float kg = Gw[(e >> 3) & 63];
      uint4 part[3];
      part[0] = reinterpret_cast<const uint4*>(ks)[e];
      float w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 kv = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(&part[0])[i]);
        w[2 * i] = __fmul_rn(kv.x, kg);
        w[2 * i + 1] = __fmul_rn(kv.y, kg);
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        __nv_bfloat162* b2 = reinterpret_cast<__nv_bfloat162*>(&part[p]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          b2[i] = __floats2bfloat162_rn(w[2 * i], w[2 * i + 1]);
          const float2 r = __bfloat1622float2(b2[i]);
          w[2 * i] = __fsub_rn(w[2 * i], r.x);
          w[2 * i + 1] = __fsub_rn(w[2 * i + 1], r.y);
        }
      }
      reinterpret_cast<uint4*>(ks)[e] = part[0];
      reinterpret_cast<uint4*>(qs)[e] = part[1];
      reinterpret_cast<uint4*>(cs)[e] = part[2];
    }
    // the h tile is written below: the store of chunk c - 1 has read it
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    fence_async();
    __syncthreads();

    // O += P V; C^T = C^T decay + V^T hi + V^T mid + V^T lo
#pragma unroll
    for (int i = 0; i < CN; ++i) c_acc[i] *= decay;
    pin(o);
    pin(c_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<true>(o, pa[kk], desc(v_addr + kk * 2048, kAtom, 1024));
    const uint32_t parts[3] = {k_addr, q_addr, c_addr};
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_mn(c_acc, desc(v_addr + kk * 2048, kAtom, 1024),
                    desc(parts[p] + kk * 2048, kAtom, 1024), 1);
    wg_commit();
    wg_wait();
    pin(o);
    pin(c_acc);

    // h = O / den into the h tile, C as bf16 C^T into the C tile, both in
    // the swizzled layout; one TMA store of h
#pragma unroll
    for (int idx = 0; idx < 32; idx += 2) {
      const int r = (idx >> 1) & 1, j = idx >> 2, t = r0 + 8 * r;
      *reinterpret_cast<uint32_t*>(hs + t * 128 + ((j ^ (t & 7)) << 4) +
                                   (lane & 3) * 4) =
          pack2<__nv_bfloat16>(__fdiv_rn(o[idx], den[r]),
                               __fdiv_rn(o[idx + 1], den[r]));
    }
#pragma unroll
    for (int idx = 0; idx < CN; idx += 2) {
      const int r = (idx >> 1) & 1, j = idx >> 2, t = r0 + 8 * r;
      *reinterpret_cast<uint32_t*>(cs + (j >> 3) * kAtom + t * 128 +
                                   (((j & 7) ^ (t & 7)) << 4) +
                                   (lane & 3) * 4) =
          pack2<__nv_bfloat16>(c_acc[idx], c_acc[idx + 1]);
    }
    fence_async();
    __syncthreads();
    if (tid == 0) {
      asm volatile(
          "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
          " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
              reinterpret_cast<uint64_t>(&th)),
          "r"(smem_u32(hs)), "r"(v0), "r"(c * kL), "r"(hd), "r"(b)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    m_prev = m_end;
  }

  // the final state: C (B, nh, dk, dv) from C^T, n and m from the first
  // column tile
#pragma unroll
  for (int idx = 0; idx < CN; ++idx) {
    const int col = v0 + r0 + 8 * ((idx >> 1) & 1);
    const int d = 8 * (idx >> 2) + col0 + (idx & 1);
    if (d < dk && col < dv)
      C_out[(static_cast<long long>(bh) * dk + d) * dv + col] = c_acc[idx];
  }
  if (blockIdx.y == 0) {
    for (int d = tid; d < dk; d += kThreads)
      n_out[static_cast<long long>(bh) * dk + d] = nsm[d];
    if (tid == 0) m_out[bh] = m_prev;
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int DKPAD>
int launch(const void* q, const void* k, const void* v, const void* li,
           const void* lf, void* h, void* C, void* n, void* m,
           const long long* st, int B, int S, int nh, int dk, int dv,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, th;
  const long long sh[3] = {static_cast<long long>(S) * nh * dv,
                           static_cast<long long>(nh) * dv, dv};
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int r = encode(&tq, q, bf, B, S, nh, dk, st, kL);
  if (r == 0) r = encode(&tk, k, bf, B, S, nh, dk, st + 3, kL);
  if (r == 0) r = encode(&tv, v, bf, B, S, nh, dv, st + 6, kL);
  if (r == 0) r = encode(&th, h, bf, B, S, nh, dv, sh, kL);
  if (r != 0) return 1000 + r;
  Gates g;
  for (int i = 0; i < 3; ++i) {
    g.li[i] = st[9 + i];
    g.lf[i] = st[12 + i];
  }
  const size_t smem = smem_bytes(DKPAD);
  const cudaError_t e = cudaFuncSetAttribute(
      mlstm_wgmma_kernel<DKPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(B) * nh, (dv + kTileV - 1) / kTileV);
  mlstm_wgmma_kernel<DKPAD><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, th, static_cast<const float*>(li),
      static_cast<const float*>(lf), g, static_cast<float*>(C),
      static_cast<float*>(n), static_cast<float*>(m), S, nh, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes), with repro_mlstm's arguments
// less L and the dtype: q, k (B, S, nh, dk) and v (B, S, nh, dv) bfloat16
// with a unit stride on the last axis, dk and dv multiples of 8 in [8,
// 256], 16-byte aligned pointers; log_i, log_f (B, S, nh) float32;
// `strides` holds the 15 element strides of the (B, S, nh) axes of q, k,
// v, log_i, log_f in that order, those of q, k, v positive multiples of 8.
// Writes h (B, S, nh, dv) bfloat16 contiguous and the final C (B, nh, dk,
// dv), n (B, nh, dk), m (B, nh) float32.  The chunk length is 64: the
// caller takes this kernel for L = 64 or a single chunk (S <= 64, padded).
// Returns cudaGetLastError() after the launch (0 = success), or 1000 + the
// CUresult of a tensor map that cuTensorMapEncodeTiled refused.
extern "C" int repro_mlstm_wgmma(const void* q, const void* k, const void* v,
                                 const void* li, const void* lf, void* h,
                                 void* C, void* n, void* m,
                                 const void* strides, int B, int S, int nh,
                                 int dk, int dv, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  bool ok = B >= 1 && S >= 1 && nh >= 1 && dk >= 8 && dk <= 256 &&
            dk % 8 == 0 && dv >= 8 && dv <= 256 && dv % 8 == 0;
  for (int i = 0; i < 9; ++i) ok = ok && st[i] > 0 && st[i] % 8 == 0;
  const void* ptrs[4] = {q, k, v, h};
  for (const void* ptr : ptrs)
    ok = ok && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dk <= 64)
    return launch<64>(q, k, v, li, lf, h, C, n, m, st, B, S, nh, dk, dv, cs);
  if (dk <= 128)
    return launch<128>(q, k, v, li, lf, h, C, n, m, st, B, S, nh, dk, dv, cs);
  return launch<256>(q, k, v, li, lf, h, C, n, m, st, B, S, nh, dk, dv, cs);
}
