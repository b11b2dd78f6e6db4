// Chunkwise mLSTM forward for Hopper (sm_90a): the xLSTM matrix-memory
// recurrence over a whole prompt, with the (C, n, m) state carried on chip
// from chunk to chunk, every product an fp32 FMA on the CUDA cores.
//
// Replaces the TPU kernel `_mlstm_kernel` (src/repro/kernels/mlstm_chunk.py,
// launched by `mlstm_chunk`).  Per (batch b, head h) and chunk of L positions,
// with F the inclusive cumulative sum of log f inside the chunk:
//
//   w[t][u]  = F_t - F_u + li_u                  (u <= t)
//   m_t      = max(max_u w[t][u], m_prev + F_t)
//   p[t][u]  = (q_t . k_u) exp(w[t][u] - m_t)
//   sgate_t  = exp(m_prev + F_t - m_t)
//   den_t    = max(|sum_u p[t][u] + (q_t . n) sgate_t|, exp(-m_t))
//   h_t      = (sum_u p[t][u] v_u + (q_t C) sgate_t) / den_t
//
// and at the chunk's end, with w_end_u = F_L - F_u + li_u,
// m_end = max(max_u w_end_u, m_prev + F_L), kg_u = exp(w_end_u - m_end),
// decay = exp(m_prev + F_L - m_end):
//
//   C <- C decay + sum_u (k_u kg_u) v_u^T,  n <- n decay + sum_u k_u kg_u,
//   m <- m_end.
//
// Positions past S get li = -1e9 and lf = 0 and zero q, k, v, as the TPU
// kernel's padding gives them; their rows of h are not written.  Unlike the
// TPU kernel this one also writes the final (C, n, m): the model's decode
// hand-off needs it, and the reference recovers it with a second scan.
// This is the float32 route (and the bf16 calls mlstm_wgmma.cu does not
// take, cast to fp32 on load): its gates, 1e-5 against the float64 twin,
// exclude TF32 and bf16 products.
//
// What bounds it on the H100: operations.  Per chunk a (b, h) pair does
// L(L+1)/2 (dk + dv) + 2 L dk dv multiply-adds against 2 L (dk + dv) inputs
// read, some 30 multiply-adds per byte at full width (L = 64, dk = 96,
// dv = 192), above the fp32 ridge of the card (67 TFLOP/s over 3.35 TB/s,
// 20 per byte): 0.181 ms at B = 8, S = 2048, nh = 8.  The first version kept
// every operand in shared memory and made two shared loads for each FMA,
// did F, m_end and kg on one thread, and had every v tile's block recompute
// the scores: 3.661 ms, 4.9% of the bound.  This design:
//
// * Products from registers.  Each thread owns a micro-tile of outputs and
//   reads its operands as 16-byte vectors, one wavefront a load: 4 x 4 of
//   h (q C, then P V into the same accumulators, so h = (acc sgate + P V) /
//   den is divided and written once from registers), 4 x 2 of the C update
//   and 2 x 2 of a score tile; 8, 4 and 4 FMAs a shared load.  A warp's
//   loads of 4 rows of q, k or P at a time are rows in a row and the row
//   strides are 4 floats past a multiple of 32, so the rows sit in
//   distinct bank groups; the v, C and kg v rows a warp reads are 128
//   contiguous bytes, broadcast to its row groups.  q C loads its next
//   step's operands before it multiplies this one's.
// * q and k in pieces of kPiece = 32 columns of dk.  Each piece's scores,
//   q C and q . n accumulate, and the C and n rows it holds are updated
//   (from k and kg v, kg folded into v once a chunk), under two barriers;
//   so shared memory holds 2 L x 36 floats of q and k, not 2 L dk, and
//   three blocks fit a multiprocessor at full width (67,200 bytes each).
//   Global loads go through registers a whole batch at once; the next
//   piece's are in flight under this one's C update.
// * Scalar work spread over warps.  F is a warp scan in double: each lane
//   sums its ceil(L / 32) positions in order, the lanes' totals are
//   scanned by shuffles; the sums of up to 128 fp32 log f are exact in
//   double unless their exponents span more than 29 bits, so the kernel's
//   F rounds to the same fp32 values as the twin's double cumsum in any
//   order (mlstm_cuda.scan_cumsum mirrors this order).  Every warp holds F
//   and log i in registers and finds m_end and kg (max by xor shuffles);
//   m_t and sgate take a thread a row, den two lanes a row in the warp
//   that owns the row of h, the n update every fourth u in each warp.
//   exp is expf and the division IEEE; the build has no fast-math flag.
// * Scores shared in a cluster.  The ceil(dv / 32) blocks of a (b, h)
//   form thread block clusters of equal size (at most max_cluster; 8 when
//   the grid has at most one block a multiprocessor, 2 on a fuller card,
//   mlstm_cuda.simt_max_cluster).  The chunk's causal 8 x 16 score tiles
//   are dealt round-robin over a cluster's warps; after a cluster barrier
//   each block copies the others' tiles from their shared memory
//   (distributed shared memory), and a split barrier, waited on before
//   the next chunk writes its own tiles, releases the copy: one blocking
//   cluster barrier a chunk.  A cluster's blocks must share a GPC, and at
//   three blocks an SM the H100 seats every pair of the serving grid at
//   once but not every cluster of 6 or 3, whose last blocks would run as
//   a second wave: so on a full card pairs, and each (b, h) scores its
//   chunk three times.
// * Filling the card.  One block owns one (b, h) and kTileV = 32 columns
//   of v: grid (B * nh, clusters x cluster size).  At B = 8, nh = 8, dv =
//   192: 384 blocks in 192 pairs, three a multiprocessor, 97% of the
//   card's 396 slots in one wave (64-column tiles gave 192 blocks at two
//   an SM, 73%).  At B = 1, serving's one-request prefill, the 48 blocks
//   in clusters of 6 take 48 of the 132 multiprocessors, one each.
//
// What holds it under half its bound (chip_smoke.py, NVIDIA H100 80GB
// HBM3, 700.00 W: 1.029 ms at B = 8, 17.6% of the bound, against 3.660
// before; 0.560 ms at B = 1):
// latency, not the FMA or shared-memory rate.  A chunk runs ~10 barriers
// and short dependent sequences (shared load, then the FMAs that use it)
// on 3 warps a scheduler; the 168 registers a thread has at three blocks
// an SM leave no room to keep more loads in flight, and the pairs score
// each chunk three times.
//
// The TPU grid walked the chunks in order with the state in VMEM scratch.
// Here each block walks every chunk in order itself, its C[:, tile] and n
// in shared memory; each block of a (b, h) carries the same n, m and
// gates.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileV = 32;                 // v columns a block
constexpr int kPiece = 32;                 // dk columns of q, k at a time
constexpr int kPieceStride = kPiece + 4;   // row stride of the q, k pieces
constexpr int kBand = 16;                  // rows of h a warp
constexpr int kMaxChunk = 128;
constexpr int kBatch = 16;   // rows of q, k or v a warp loads at once
constexpr int kGather = 6;   // score tiles a warp copies at once
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegBig = -1e9f;

// Element strides of the (B, S, nh) axes of each input; the last axis of
// q, k and v is contiguous.
struct Strides {
  long long q[3], k[3], v[3], li[3], lf[3];
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* li;
  const float* lf;
  void* h;
  float* C;
  float* n;
  float* m;
  Strides st;
  int S, nh, dk, dv, L, cs;
};

// Shared memory, in floats: C[:, tile] and n (dk padded to kPiece), the q
// and k pieces, the v tile and kg v, P (rows padded to kBand, stride
// Lr + 4), F, log i, m_t, sgate, den, kg, q . n per row, and each warp's
// share of a piece's n update.
struct Layout {
  int Lr, Ps, dkp, pieces, tiles;
  int C, n, q, k, v, vg, p, F, li, mt, sg, den, kg, qn, nw, floats;
};

__host__ __device__ inline Layout layout(int dk, int L) {
  Layout o;
  o.Lr = (L + kBand - 1) / kBand * kBand;
  o.Ps = o.Lr + 4;
  o.dkp = (dk + kPiece - 1) / kPiece * kPiece;
  o.pieces = o.dkp / kPiece;
  const int pairs = o.Lr / 16;   // pairs of 8-row score bands
  o.tiles = pairs * (pairs + 1);
  int at = 0;
  o.C = at;
  at += o.dkp * kTileV;
  o.n = at;
  at += o.dkp;
  o.q = at;
  at += o.Lr * kPieceStride;
  o.k = at;
  at += o.Lr * kPieceStride;
  o.v = at;
  at += o.Lr * kTileV;
  o.vg = at;
  at += o.Lr * kTileV;
  o.p = at;
  at += o.Lr * o.Ps;
  o.F = at;
  o.li = o.F + o.Lr;
  o.mt = o.li + o.Lr;
  o.sg = o.mt + o.Lr;
  o.den = o.sg + o.Lr;
  o.kg = o.den + o.Lr;
  o.qn = o.kg + o.Lr;
  o.nw = o.qn + o.Lr;
  o.floats = o.nw + kWarps * kPiece;
  return o;
}

// Causal score tile i (8 rows x 16 columns of P, u <= t somewhere in it):
// the row bands 2a and 2a + 1 each have a + 1 of them.
__device__ __forceinline__ void tile_of(int i, int& rb, int& cb) {
  int a = 0;
  while ((a + 1) * (a + 2) <= i) ++a;
  const int j = i - a * (a + 1);
  rb = 2 * a + j / (a + 1);
  cb = j % (a + 1);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at4(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
// The split cluster barrier: arrive releases this thread's shared-memory
// accesses, wait acquires those of every thread of the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// kPasses: bands of 16 rows of h a warp, 1 for L <= 64, 2 up to 128.
template <typename T, int kPasses>
__global__ void __launch_bounds__(kThreads, 3) mlstm_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / p.nh, hd = bh - b * p.nh;
  const int L = p.L, dk = p.dk, cs = p.cs;
  const Layout lo = layout(dk, L);
  const int Lr = lo.Lr, Ps = lo.Ps;
  float* Cs = sm + lo.C;
  float* ns = sm + lo.n;
  float* qs = sm + lo.q;
  float* ks = sm + lo.k;
  float* vs = sm + lo.v;
  float* vgs = sm + lo.vg;
  float* ps = sm + lo.p;
  float* Fs = sm + lo.F;
  float* lis = sm + lo.li;
  float* mts = sm + lo.mt;
  float* sgs = sm + lo.sg;
  float* dens = sm + lo.den;
  float* kgs = sm + lo.kg;
  float* qns = sm + lo.qn;
  float* nws = sm + lo.nw;
  const int rank = cs > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                          : 0;
  const int v0 = blockIdx.y * kTileV;
  const int tw = max(0, min(kTileV, p.dv - v0));
  const bool has_v = tw > 0;   // a cluster's spare block only scores
  const Strides& st = p.st;

  const T* qb = static_cast<const T*>(p.q) + b * st.q[0] + hd * st.q[2];
  const T* kb = static_cast<const T*>(p.k) + b * st.k[0] + hd * st.k[2];
  const T* vb = static_cast<const T*>(p.v) + b * st.v[0] + hd * st.v[2] + v0;
  const float* lib = p.li + b * st.li[0] + hd * st.li[2];
  const float* lfb = p.lf + b * st.lf[0] + hd * st.lf[2];
  T* hb = static_cast<T*>(p.h) +
          (static_cast<long long>(b) * p.S * p.nh + hd) * p.dv + v0;
  const long long h_row = static_cast<long long>(p.nh) * p.dv;

  // lane coordinates of the micro-tiles
  const int hr = lane >> 3;              // h and scores: row in a group of 4
  const int hc = (lane & 7) * 4;         // h: columns hc .. hc + 3
  const int ur = (lane & 7) * 4;         // C update: piece rows ur .. ur + 3
  const int uc = ((lane >> 3) + 4 * warp) * 2;   // C update: columns uc, +1
  const int nbands = Lr / kBand;
  const int per = (L + 31) >> 5;         // positions of F a lane

  for (int e = tid; e < lo.dkp * (kTileV + 1); e += kThreads) Cs[e] = 0.f;
  for (int e = tid; e < Lr * Ps; e += kThreads) ps[e] = 0.f;
  float m_prev = kNegBig;
  if (cs > 1) {   // every block of the cluster is running
    cluster_arrive();
    cluster_wait();
  }

  // Global loads go through registers, kBatch rows of a warp at once
  // (lane = column), so that their latencies overlap; the next piece's q
  // and k are in flight under a piece's C update.  (Fetching the next
  // chunk's loads under this one's h as well held more registers than
  // the three blocks an SM have, and ran slower.)  Rows r0 + warp + 4 i
  // of the chunk at c0.
  auto fetch = [&](int c0, int pc, int r0, float (&qv)[kBatch],
                   float (&kv)[kBatch]) {
    const int nv = min(L, p.S - c0), gd = pc * kPiece + lane;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int r = r0 + warp + kWarps * i;
      const bool ok = r < nv && gd < dk;
      const long long s = c0 + r;
      qv[i] = ok ? to_f32(qb[s * st.q[1] + gd]) : 0.f;
      kv[i] = ok ? to_f32(kb[s * st.k[1] + gd]) : 0.f;
    }
  };
  auto stash = [&](int r0, const float (&qv)[kBatch],
                   const float (&kv)[kBatch]) {
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int r = r0 + warp + kWarps * i;
      if (r < Lr) {
        qs[r * kPieceStride + lane] = qv[i];
        ks[r * kPieceStride + lane] = kv[i];
      }
    }
  };
  auto fetch_v = [&](int c0, int r0, float (&vv)[kBatch]) {
    const int nv = min(L, p.S - c0);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int r = r0 + warp + kWarps * i;
      vv[i] = r < nv && lane < tw
                  ? to_f32(vb[static_cast<long long>(c0 + r) * st.v[1] + lane])
                  : 0.f;
    }
  };
  auto stash_v = [&](int r0, const float (&vv)[kBatch]) {
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int r = r0 + warp + kWarps * i;
      if (r < Lr) vs[r * kTileV + lane] = vv[i];
    }
  };
  float pq[kBatch], pk[kBatch], pv[kBatch];   // rows in flight

  for (int c0 = 0; c0 < p.S; c0 += L) {
    const int nv = min(L, p.S - c0);   // valid rows of this chunk
    fetch(c0, 0, 0, pq, pk);   // stored once F and the chunk's end are done
    if (has_v) fetch_v(c0, 0, pv);

    // F, the row stabilizers and the chunk's end, in every warp from
    // registers: lane l holds positions l * per .. l * per + per - 1
    float Fv[4], liv[4];
    float m_end, decay;
    {
      double s[4], run = 0.0;
      const int base = lane * per;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = base + j;
        const bool mine = j < per && pos < L;
        const bool in = mine && pos < nv;
        const long long sp = c0 + pos;
        const float lfv = in ? lfb[sp * st.lf[1]] : 0.f;
        liv[j] = in ? lib[sp * st.li[1]] : kNegBig;
        if (mine) run = j == 0 ? static_cast<double>(lfv)
                               : run + static_cast<double>(lfv);
        s[j] = run;
      }
      double incl = base < L ? run : 0.0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const double y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      const double excl = __shfl_up_sync(kFull, incl, 1);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Fv[j] = static_cast<float>(lane > 0 ? excl + s[j] : s[j]);
    }
    {
      const int last = (L - 1) / per;   // the lane holding position L - 1
      const int slot = L - 1 - last * per;
      const float FL = __shfl_sync(kFull,
                                   slot == 0   ? Fv[0]
                                   : slot == 1 ? Fv[1]
                                   : slot == 2 ? Fv[2]
                                               : Fv[3],
                                   last);
      float wend[4], wmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wend[j] = (FL - Fv[j]) + liv[j];
        if (j < per && lane * per + j < L) wmax = fmaxf(wmax, wend[j]);
      }
      wmax = warp_max(wmax);
      const float m_fl = m_prev + FL;
      m_end = fmaxf(wmax, m_fl);
      decay = expf(m_fl - m_end);
      if (warp == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pos = lane * per + j;
          if (j < per && pos < L) {
            kgs[pos] = expf(wend[j] - m_end);
            Fs[pos] = Fv[j];
            lis[pos] = liv[j];
          }
        }
        for (int pos = L + lane; pos < Lr; pos += 32) {
          kgs[pos] = 0.f;
          Fs[pos] = FL;
          lis[pos] = kNegBig;
        }
      }
    }
    stash(0, pq, pk);
    if (has_v) stash_v(0, pv);
    if (kPasses > 1) {
      fetch(c0, 0, kBatch * kWarps, pq, pk);
      if (has_v) fetch_v(c0, kBatch * kWarps, pv);
      stash(kBatch * kWarps, pq, pk);
      if (has_v) stash_v(kBatch * kWarps, pv);
    }
    if (cs > 1 && c0 > 0) cluster_wait();   // the others copied my last P
    __syncthreads();
    // m_t and sgate, a thread a row (every warp reads the same u at once)
    for (int t = tid; t < L; t += kThreads) {
      const float Ft = Fs[t];
      float w0 = -INFINITY, w1 = -INFINITY;
      int u = 0;
#pragma unroll 4
      for (; u + 1 <= t; u += 2) {
        w0 = fmaxf(w0, (Ft - Fs[u]) + lis[u]);
        w1 = fmaxf(w1, (Ft - Fs[u + 1]) + lis[u + 1]);
      }
      if (u == t) w0 = fmaxf(w0, (Ft - Fs[u]) + lis[u]);
      const float m_in = m_prev + Ft;
      const float mt = fmaxf(fmaxf(w0, w1), m_in);
      mts[t] = mt;
      sgs[t] = expf(m_in - mt);
    }
    if (has_v)
      for (int e = tid; e < Lr * kTileV; e += kThreads)
        vgs[e] = vs[e] * kgs[e >> 5];

    float acc[kPasses][4][4];
#pragma unroll
    for (int x = 0; x < kPasses; ++x)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[x][j][c] = 0.f;

    for (int pc = 0; pc < lo.pieces; ++pc) {
      __syncthreads();   // the piece, kg v (and C, n of the last piece)
      const bool first = pc == 0, last = pc == lo.pieces - 1;
      // this warp's score tiles: s (+)= q k^T over the piece, 2 x 2 a
      // lane (rows t0, t0 + 4, columns u0, u0 + 8); gated last
      for (int i = rank * kWarps + warp; i < lo.tiles; i += cs * kWarps) {
        int rb, cb;
        tile_of(i, rb, cb);
        const int t0 = 8 * rb + hr, u0 = 16 * cb + (lane & 7);
        float sv[2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            sv[a][c] = first ? 0.f : ps[(t0 + 4 * a) * Ps + u0 + 8 * c];
#pragma unroll
        for (int d = 0; d < kPiece; d += 4) {
          const float4 x0 = ld4(qs + t0 * kPieceStride + d);
          const float4 x1 = ld4(qs + (t0 + 4) * kPieceStride + d);
          const float4 y0 = ld4(ks + u0 * kPieceStride + d);
          const float4 y1 = ld4(ks + (u0 + 8) * kPieceStride + d);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sv[0][0] = fmaf(at4(x0, e), at4(y0, e), sv[0][0]);
            sv[0][1] = fmaf(at4(x0, e), at4(y1, e), sv[0][1]);
            sv[1][0] = fmaf(at4(x1, e), at4(y0, e), sv[1][0]);
            sv[1][1] = fmaf(at4(x1, e), at4(y1, e), sv[1][1]);
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int t = t0 + 4 * a, u = u0 + 8 * c;
            float xv = sv[a][c];
            if (last)
              xv = u <= t && t < L
                       ? xv * expf(((Fs[t] - Fs[u]) + lis[u]) - mts[t])
                       : 0.f;
            ps[t * Ps + u] = xv;
          }
      }
      float cu[4][2];
      float nacc = 0.f;
      if (has_v) {
        // h's q C over the piece, 4 rows x 4 columns a thread
        const float* crow = Cs + pc * kPiece * kTileV + hc;
#pragma unroll
        for (int x = 0; x < kPasses; ++x) {
          const int band = x == 0 ? warp : 2 * kWarps - 1 - warp;
          if (band < nbands) {
            const float* qrow = qs + (kBand * band + hr) * kPieceStride;
            float4 a[4], c4[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              a[j] = ld4(qrow + 4 * j * kPieceStride);
              c4[j] = ld4(crow + j * kTileV);
            }
#pragma unroll
            for (int d = 0; d < kPiece; d += 4) {
              float4 na[4], nc[4];
              if (d + 4 < kPiece)   // the next step's operands in flight
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  na[j] = ld4(qrow + 4 * j * kPieceStride + d + 4);
                  nc[j] = ld4(crow + (d + 4 + j) * kTileV);
                }
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                  for (int c = 0; c < 4; ++c)
                    acc[x][j][c] =
                        fmaf(at4(a[j], e), at4(c4[e], c), acc[x][j][c]);
              if (d + 4 < kPiece)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  a[j] = na[j];
                  c4[j] = nc[j];
                }
            }
          }
        }
        // q . n over the piece: two lanes a row
        for (int tb = 0; tb < Lr; tb += kThreads / 2) {
          const int t = tb + (tid >> 1), half = tid & 1;
          float x = 0.f;
          if (t < Lr) {
            const float* qr = qs + t * kPieceStride + 16 * half;
            const float* nr = ns + pc * kPiece + 16 * half;
#pragma unroll
            for (int d = 0; d < 16; d += 4) {
              const float4 a = ld4(qr + d), nn = ld4(nr + d);
              x = fmaf(a.x, nn.x, x);
              x = fmaf(a.y, nn.y, x);
              x = fmaf(a.z, nn.z, x);
              x = fmaf(a.w, nn.w, x);
            }
          }
          x += __shfl_xor_sync(kFull, x, 1);
          if (half == 0 && t < Lr) qns[t] = first ? x : qns[t] + x;
        }
        // the next piece's rows in flight under the C update
        if (!last) fetch(c0, pc + 1, 0, pq, pk);

        // the C update of the piece's rows, 4 rows x 2 columns a thread:
        // sum_u k[u][d] (kg_u v[u][c])
#pragma unroll
        for (int i = 0; i < 4; ++i) cu[i][0] = cu[i][1] = 0.f;
        const float* kcol = ks + ur;
        const float* gcol = vgs + uc;
#pragma unroll 4
        for (int u = 0; u < L; ++u) {
          const float4 a = ld4(kcol + u * kPieceStride);
          const float2 g = *reinterpret_cast<const float2*>(gcol + u * kTileV);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            cu[i][0] = fmaf(at4(a, i), g.x, cu[i][0]);
            cu[i][1] = fmaf(at4(a, i), g.y, cu[i][1]);
          }
        }
        // the n update of the piece's rows: warp w sums every fourth u
        for (int u = warp; u < L; u += kWarps)
          nacc = fmaf(ks[u * kPieceStride + lane], kgs[u], nacc);
        nws[warp * kPiece + lane] = nacc;
      }
      __syncthreads();   // every read of the piece and of its C, n rows
      if (has_v) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float* cp = Cs + (pc * kPiece + ur + i) * kTileV + uc + c;
            *cp = *cp * decay + cu[i][c];
          }
        if (warp == 0) {
          float* np = ns + pc * kPiece + lane;
          *np = *np * decay + ((nws[lane] + nws[kPiece + lane]) +
                               (nws[2 * kPiece + lane] + nws[3 * kPiece + lane]));
        }
      }
      if (!last) {
        if (!has_v) fetch(c0, pc + 1, 0, pq, pk);
        stash(0, pq, pk);
        if (kPasses > 1) {
          fetch(c0, pc + 1, kBatch * kWarps, pq, pk);
          stash(kBatch * kWarps, pq, pk);
        }
      }
    }

    if (cs > 1) {   // every tile of P written: copy the others' tiles
      cluster_arrive();
      cluster_wait();
      // a warp takes every fourth tile, a lane a float4 of it; the remote
      // loads of kGather tiles are in flight at once
      cg::cluster_group cluster = cg::this_cluster();
      for (int i0 = warp; i0 < lo.tiles; i0 += kWarps * kGather) {
        float4 buf[kGather];
        int off[kGather];
#pragma unroll
        for (int g = 0; g < kGather; ++g) {
          const int i = i0 + kWarps * g;
          const int owner = (i % (cs * kWarps)) / kWarps;
          off[g] = -1;
          if (i < lo.tiles && owner != rank) {
            int rb, cb;
            tile_of(i, rb, cb);
            off[g] = (8 * rb + (lane >> 2)) * Ps + 16 * cb + 4 * (lane & 3);
            buf[g] = ld4(cluster.map_shared_rank(ps, owner) + off[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < kGather; ++g)
          if (off[g] >= 0) *reinterpret_cast<float4*>(ps + off[g]) = buf[g];
      }
      cluster_arrive();
    }
    __syncthreads();

    if (has_v) {
#pragma unroll
      for (int x = 0; x < kPasses; ++x) {
        const int band = x == 0 ? warp : 2 * kWarps - 1 - warp;
        if (band >= nbands) continue;
        const int ub = kBand * (band + 1);   // the band's causal columns
        // den of the band's rows, by its warp: two lanes a row (P is 0
        // past the diagonal)
        {
          const int t = kBand * band + (lane >> 1), half = lane & 1;
          float sum = 0.f;
          for (int j = 4 * half; j < ub; j += 8) {
            const float4 a = ld4(ps + t * Ps + j);
            sum += (a.x + a.y) + (a.z + a.w);
          }
          sum += __shfl_xor_sync(kFull, sum, 1);
          if (half == 0 && t < L)
            dens[t] = fmaxf(fabsf(sum + qns[t] * sgs[t]), expf(-mts[t]));
        }
        __syncwarp();
        // h = (acc sgate + P V) / den over the causal columns of the band
        const int t0 = kBand * band + hr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + 4 * j;
          const float sg = t < L ? sgs[t] : 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[x][j][c] *= sg;
        }
        const float* prow = ps + t0 * Ps;
        const float* vcol = vs + hc;
#pragma unroll 2
        for (int u = 0; u < ub; u += 4) {
          float4 a[4], v4[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[j] = ld4(prow + 4 * j * Ps + u);
            v4[j] = ld4(vcol + (u + j) * kTileV);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[x][j][c] = fmaf(at4(a[j], e), at4(v4[e], c), acc[x][j][c]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + 4 * j;
          if (t >= nv) continue;
          const float dn = dens[t];
          T* hp = hb + (c0 + t) * h_row + hc;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (hc + c < tw) put(hp + c, acc[x][j][c] / dn);
        }
      }
    }
    m_prev = m_end;
    __syncthreads();   // the chunk's reads done before the next one's loads
  }
  if (cs > 1) cluster_wait();   // no block leaves while its P is read

  if (has_v)
    for (int e = tid; e < dk * kTileV; e += kThreads) {
      const int d = e >> 5, c = e & 31;
      if (c < tw)
        p.C[(static_cast<long long>(bh) * dk + d) * p.dv + v0 + c] =
            Cs[d * kTileV + c];
    }
  if (blockIdx.y == 0) {
    for (int d = tid; d < dk; d += kThreads)
      p.n[static_cast<long long>(bh) * dk + d] = ns[d];
    if (tid == 0) p.m[bh] = m_prev;
  }
}

size_t smem_bytes(int dk, int L) {
  return static_cast<size_t>(layout(dk, L).floats) * sizeof(float);
}

// v tiles of 32 columns; up to max_cluster of them a cluster, clusters of
// equal size (mlstm_cuda.simt_grid mirrors this).
void cluster_shape(int dv, int max_cluster, int* cs, int* grid_y) {
  const int tiles = (dv + kTileV - 1) / kTileV;
  const int clusters = (tiles + max_cluster - 1) / max_cluster;
  *cs = (tiles + clusters - 1) / clusters;
  *grid_y = clusters * *cs;
}

template <typename T, int kPasses>
int launch_passes(Params prm, int B, int max_cluster, cudaStream_t stream) {
  const size_t smem = smem_bytes(prm.dk, prm.L);
  if (smem > 48u * 1024u) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlstm_kernel<T, kPasses>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int cs, gy;
  cluster_shape(prm.dv, max_cluster, &cs, &gy);
  prm.cs = cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * prm.nh, gy, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, mlstm_kernel<T, kPasses>, prm);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(Params prm, int B, int max_cluster, cudaStream_t stream) {
  return layout(prm.dk, prm.L).Lr > kBand * kWarps
             ? launch_passes<T, 2>(prm, B, max_cluster, stream)
             : launch_passes<T, 1>(prm, B, max_cluster, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  q, k (B, S, nh, dk) and v
// (B, S, nh, dv) are float32 (bf16 = 0) or bfloat16 (bf16 = 1) with a
// contiguous last axis; log_i, log_f (B, S, nh) float32; `strides` holds 15
// element strides, the (B, S, nh) strides of q, k, v, log_i, log_f in that
// order.  Writes h (B, S, nh, dv) contiguous in q's type and the final
// C (B, nh, dk, dv), n (B, nh, dk), m (B, nh) in float32.  L is the chunk
// length, 8 <= L <= 128; max_cluster, 1 <= max_cluster <= 8, the most
// v tiles that share their scores (1: each block computes its own).
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int repro_mlstm(const void* q, const void* k, const void* v,
                           const void* li, const void* lf, void* h, void* C,
                           void* n, void* m, const void* strides, int B,
                           int S, int nh, int dk, int dv, int L, int bf16,
                           int max_cluster, void* stream) {
  if (B < 1 || S < 1 || nh < 1 || dk < 1 || dv < 1 || L < 8 ||
      L > kMaxChunk || smem_bytes(dk, L) > static_cast<size_t>(kMaxSmem) ||
      max_cluster < 1 || max_cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.q = q;
  prm.k = k;
  prm.v = v;
  prm.li = static_cast<const float*>(li);
  prm.lf = static_cast<const float*>(lf);
  prm.h = h;
  prm.C = static_cast<float*>(C);
  prm.n = static_cast<float*>(n);
  prm.m = static_cast<float*>(m);
  const long long* s = static_cast<const long long*>(strides);
  for (int i = 0; i < 3; ++i) {
    prm.st.q[i] = s[i];
    prm.st.k[i] = s[3 + i];
    prm.st.v[i] = s[6 + i];
    prm.st.li[i] = s[9 + i];
    prm.st.lf[i] = s[12 + i];
  }
  prm.S = S;
  prm.nh = nh;
  prm.dk = dk;
  prm.dv = dv;
  prm.L = L;
  prm.cs = 1;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(prm, B, max_cluster, cs)
              : launch<float>(prm, B, max_cluster, cs);
}
