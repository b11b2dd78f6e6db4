// Flash attention forward for Hopper (sm_90a): online-softmax attention
// with causal masking, a sliding window, the Gemma-2 logit softcap and
// grouped-query heads, read straight from the (B, S, H, D) layout.
//
// Replaces the TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py, launched by `flash_attention`).
// For one query row i and the keys j the mask lets through (positions from
// 0 for q and k alike, top-left aligned; j <= i if causal; j > i - window
// if windowed), tile by tile:
//
//   s_j   = softcap * tanh((q_i . k_j) * scale / softcap)   (or without cap)
//   m'    = max(m, max_j s_j)            masked s_j = -1e30, never -inf
//   p_j   = exp(s_j - m')                masked p_j = 0
//   acc   = acc * exp(m - m') + sum_j p_j v_j
//   l     = l * exp(m - m') + sum_j p_j
//
// and o_i = acc / l, or 0 for a row with no valid key (l == 0).  q, k and v
// are widened to fp32 on load and every product is an fp32 FMA, as the TPU
// kernel casts them to fp32 before both products; tanhf and the IEEE
// division are used (the build has no fast-math flag), and the exponential
// is the MUFU's 2^x of the scores times log2(e), within 2^-22 of e^x.
// This is the float32 route (and the bf16/fp16 operands the tensor-core
// kernel, flash_attention_wgmma.cu, does not take): held to the
// reference's 2e-5, which a TF32 product cannot meet.
//
// What bounds it on the H100: operations.  Per head and unmasked (q, k)
// pair it does 2 D multiply-adds for 4 D bytes of q, k, v and o shared by
// a whole row or column, far above the ridge of the fp32 rate (67 TFLOP/s
// on the CUDA cores).  So the design spends its issue slots on FMAs:
//
// * Registers hold the work.  One block owns one (batch, head) and one
//   tile of kBlockQ = 64 query rows.  A warp is 4 row groups of 8 lanes;
//   a row group owns RM rows, and each of its lanes BK / 8 adjacent keys
//   of a kv tile and D_pad / 8 output columns.  A lane keeps its RM x
//   BK / 8 scores, the rows' running (m, l) and its RM x D_pad / 8 slice
//   of the output accumulator in registers for the whole kv loop; nothing
//   of acc goes through shared memory.  The row max is an xor shuffle
//   among the 8 lanes of a row group each tile; each lane keeps its own
//   share of the row sum l, added across the row once, at the end.
// * 16-byte shared loads, one wavefront each.  q, k and v lie in shared
//   memory as fp32 rows; each product step reads 4 consecutive d (or j) of
//   a row with one float4 load and feeds 4 FMAs per value it loaded.  The
//   8 lanes of a row group read the same q (and p) address, a broadcast,
//   so a warp reads 4 rows at once; the 8 keys a warp reads at once are
//   broadcast to its 4 row groups.  Each tile's rows are skewed by one
//   16-byte chunk for every group of rows read together (RM rows of q and
//   p, BK / 8 keys of k), so the rows of one load sit in distinct bank
//   groups while each row's chunks stay at constant offsets from its
//   start; v is read along its rows, conflict-free as it lands.
// * Loads under compute.  When q, k and v are fp32 rows at 16-byte strides
//   and D % 4 == 0, `cp.async` copies the tiles (rows past Sk and columns
//   past D zero-filled by the copy itself): the next tile's k while this
//   one is in its softmax and p.v, its v while its own q.k runs, each
//   buffer once in shared memory, so three blocks fit an SM at D_pad = 64
//   and hide each other's barriers (a two-stage ring of both tiles holds
//   two, and ran slower).  Other operands (bf16, fp16, misaligned views)
//   are widened through registers into the same buffers, synchronously.
// * p makes one trip through shared memory, each row group's own rows:
//   the product p.v needs a row's p for all BK keys in every lane of the
//   row group.
// * Tiles by head dim: D is padded (in shared memory only, with zeros) to
//   D_pad = 64, 128 or 256, each with its own tiles (struct Tile).  D > 256
//   is refused.
//
// The TPU grid walked the kv blocks in order (its third axis "arbitrary"),
// the running (m, l, acc) in VMEM scratch.  Here each block walks its kv
// tiles itself: grid (B * H, ceil(Sq / kBlockQ)), the query tiles with the
// most keys first (grouping a head's query tiles instead, for L2 reuse of
// its k and v, balanced the card worse and ran slower).  kv tiles wholly
// outside the causal or window band are skipped, which is exact: a fully
// masked tile leaves (m, l, acc) as they were; tiles wholly inside it skip
// the per-element mask.  GQA: query head h reads kv head h / (H / KH).
// The ragged Sq and Sk edges are masked; rows past them are zero in shared
// memory and never written.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kRowLanes = 8;   // the lanes of a query row group
constexpr int kWarpRows = 4;   // row groups a warp
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[3], sk[3], sv[3];  // element strides of the (B, S, H) axes
  int Sq, Sk, H, KH, D;
  float scale, cap;
  int has_cap, causal, has_window, window;
};

// The tiles at a padded head dim DP: BK kv rows a tile, NT threads, RM
// query rows a thread, MB blocks an SM (the launch bound).  A warp is 4
// row groups of 8 lanes; a row group owns RM rows, a lane of it BK / 8
// keys and DP / 8 output columns.
template <int DP>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int BK = 64, NT = 128, RM = 4, MB = 3;
};
template <>
struct Tile<128> {
  static constexpr int BK = 64, NT = 128, RM = 4, MB = 1;
};
template <>
struct Tile<256> {
  static constexpr int BK = 32, NT = 256, RM = 2, MB = 1;
};

__host__ __device__ constexpr int head_dim_pad(int D) {
  return D <= 64 ? 64 : (D <= 128 ? 128 : 256);
}

int block_k(int D) {
  const int dp = head_dim_pad(D);
  return dp == 64 ? Tile<64>::BK : (dp == 128 ? Tile<128>::BK
                                              : Tile<256>::BK);
}

// Floats of a tile of `rows` rows, `width` wide, skewed by 4 floats for
// every group of `group` rows (chunk_at).
__host__ __device__ constexpr int tile_floats(int rows, int width,
                                              int group) {
  return rows * width + (group > 0 ? 4 * (rows / group) : 0);
}

// q (kBlockQ x D_pad), k and v (BK x D_pad), p (kBlockQ x BK), all
// fp32, with their skews.
template <int DP>
__host__ __device__ constexpr int smem_floats() {
  using t = Tile<DP>;
  return tile_floats(kBlockQ, DP, t::RM) +
         tile_floats(t::BK, DP, t::BK / kRowLanes) +
         tile_floats(t::BK, DP, 0) + tile_floats(kBlockQ, t::BK, t::RM);
}

size_t smem_bytes(int D) {
  const int dp = head_dim_pad(D);
  return sizeof(float) * (dp == 64 ? smem_floats<64>()
                                   : (dp == 128 ? smem_floats<128>()
                                                : smem_floats<256>()));
}

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

// 16 bytes from global to shared memory, asynchronously; zeros when
// !full (the source is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 2^x by the MUFU (relative error at most 2^-22; results below 2^-126
// are 0, which only ever drops a p that l >= 1 outweighs by far).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Float offset of chunk c (4 floats) of shared row r in a W-wide tile
// whose groups of G rows are each skewed by one more chunk (G > 0): the 4
// or 8 rows a warp reads at once, one from each of 8 consecutive groups,
// then lie in distinct bank groups (W / 4 is a multiple of 8), and a
// row's chunks stay at constant offsets from its start.
template <int W, int G>
__device__ __forceinline__ int row_chunk(int r) {
  const unsigned u = r;
  return static_cast<int>(u * (W / 4) + (G > 0 ? u / (G > 0 ? G : 1) : 0));
}
template <int W, int G>
__device__ __forceinline__ int chunk_at(int r, int c) {
  return 4 * (row_chunk<W, G>(r) + c);
}

// ROWS rows of a (rows, D) operand from `src` (row stride `ld` elements)
// into a D_pad-wide fp32 tile swizzled by row groups of G; rows >= nrows
// and columns >= D are zero.  ASYNC: cp.async of 16-byte chunks (float
// rows at 16-byte strides, D % 4 == 0); else widened through registers.
template <typename T, int DP, int ROWS, int NT, bool ASYNC, int G>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld, int nrows, int D) {
  if constexpr (ASYNC) {
    const float* f = reinterpret_cast<const float*>(src);
    for (int e = threadIdx.x; e < ROWS * (DP / 4); e += NT) {
      const int r = e / (DP / 4), c = e % (DP / 4);
      const bool full = r < nrows && 4 * c < D;
      cp_async16(dst + chunk_at<DP, G>(r, c), full ? f + r * ld + 4 * c : f,
                 full);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += NT) {
      const int r = e / DP, d = e % DP;
      dst[chunk_at<DP, G>(r, d / 4) + (d & 3)] =
          r < nrows && d < D ? to_f32(src[r * ld + d]) : 0.f;
    }
  }
}

// max and sum of N (a power of two) values as a tree: log2 N dependent
// steps, not N.
template <int N>
__device__ __forceinline__ float tree_max(const float (&v)[N]) {
  float t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = v[i];
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) t[i] = fmaxf(t[i], t[i + w]);
  return t[0];
}
template <int N>
__device__ __forceinline__ float tree_sum(const float (&v)[N]) {
  float t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = v[i];
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) t[i] += t[i + w];
  return t[0];
}

__device__ __forceinline__ float lane_of(const float4& a, int e) {
  return e == 0 ? a.x : (e == 1 ? a.y : (e == 2 ? a.z : a.w));
}

template <typename T, int DP, bool ASYNC>
__global__ void __launch_bounds__(Tile<DP>::NT, Tile<DP>::MB)
    flash_kernel(Params p) {
  constexpr int BK = Tile<DP>::BK, NT = Tile<DP>::NT, RM = Tile<DP>::RM;
  constexpr int SC = BK / kRowLanes;  // keys a lane, contiguous
  constexpr int OW = DP / 32;         // output chunks of 4 columns a lane
  constexpr int DC = DP / 4;          // chunks a row
  static_assert(NT / 32 * kWarpRows * RM == kBlockQ, "64 query rows");
  static_assert(SC % 4 == 0, "p is written 4 keys at a time");
  constexpr int QF = tile_floats(kBlockQ, DP, RM);  // skewed by RM rows
  constexpr int KF = tile_floats(BK, DP, SC);       // skewed by SC rows
  constexpr int VF = tile_floats(BK, DP, 0);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;        // kBlockQ x DP
  float* ks = qs + QF;     // BK x DP
  float* vs = ks + KF;     // BK x DP
  float* ps = vs + VF;     // kBlockQ x BK, skewed by RM rows

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int kg = lane % kRowLanes;   // this lane's keys and columns
  const int row0 = (warp * kWarpRows + lane / kRowLanes) * RM;
  // chunk offsets of this lane's first row of q and p and first key of k:
  // its other rows (keys) are in the same group, DC (BK / 4) chunks on
  const int qo = row_chunk<DP, RM>(row0), po = row_chunk<BK, RM>(row0);
  const int ko = row_chunk<DP, SC>(kg * SC);
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int nq = min(kBlockQ, p.Sq - q0);
  const T* qb = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2] +
                q0 * p.sq[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.sk[0] + kvh * p.sk[2];
  const T* vb = static_cast<const T*>(p.v) + b * p.sv[0] + kvh * p.sv[2];

  // keys that may be unmasked for queries q0 .. q0 + nq - 1
  int k_lo = 0, k_hi = p.Sk;
  if (p.has_window) k_lo = max(0, q0 - p.window + 1);
  if (p.causal) k_hi = min(k_hi, q0 + nq);
  const int tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  // k of a tile is copied in while the tile before it is in its softmax
  // and p.v, v while its own q.k runs: each a group of its own
  auto load_k = [&](int k0) {
    load_tile<T, DP, BK, NT, ASYNC, SC>(ks, kb + k0 * p.sk[1], p.sk[1],
                                        min(BK, p.Sk - k0), p.D);
    cp_async_commit();
  };
  auto load_v = [&](int k0) {
    load_tile<T, DP, BK, NT, ASYNC, 0>(vs, vb + k0 * p.sv[1], p.sv[1],
                                       min(BK, p.Sk - k0), p.D);
    cp_async_commit();
  };
  load_tile<T, DP, kBlockQ, NT, ASYNC, RM>(qs, qb, p.sq[1], nq, p.D);
  if (tiles > 0) {
    load_k(k_lo);  // with q
    load_v(k_lo);
  } else {
    cp_async_commit();  // q: no key to attend to, but the copy must land
    cp_async_wait<0>();
  }

  float acc[RM][4 * OW], m[RM], l[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * OW; ++c) acc[r][c] = 0.f;
  }

  const float4* q4 = reinterpret_cast<const float4*>(qs);
  const float4* k4 = reinterpret_cast<const float4*>(ks);
  const float4* v4 = reinterpret_cast<const float4*>(vs) + kg;
  float4* p4 = reinterpret_cast<float4*>(ps) + po;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = k_lo + it * BK;
    const bool next = it + 1 < tiles;
    cp_async_wait<1>();  // k of this tile (and q) landed; v may be pending
    __syncthreads();     // ... for every thread

    // s = q k^T over this lane's RM rows and keys kg * SC + u
    float s[RM][SC];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int u = 0; u < SC; ++u) s[r][u] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DC; ++c) {
      float4 a[RM], kv[SC];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = q4[qo + r * DC + c];
#pragma unroll
      for (int u = 0; u < SC; ++u) kv[u] = k4[ko + u * DC + c];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int u = 0; u < SC; ++u) {
          float x = fmaf(a[r].x, kv[u].x, s[r][u]);
          x = fmaf(a[r].y, kv[u].y, x);
          x = fmaf(a[r].z, kv[u].z, x);
          s[r][u] = fmaf(a[r].w, kv[u].w, x);
        }
    }

    __syncthreads();  // every warp is done with k
    if (next) load_k(k0 + BK);

    // the online softmax, row by row; p into this row group's rows of ps.
    // Key kbase + u is unmasked for query qi iff lo <= u <= hi (rows past
    // Sq are never written, so only keys past Sk bound them).
    const bool inside = k0 + BK <= p.Sk &&
                        (!p.causal || k0 + BK - 1 <= q0) &&
                        (!p.has_window || k0 > q0 + kBlockQ - 1 - p.window);
    const int kbase = k0 + kg * SC;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int qi = q0 + row0 + r;
      const int hi = (p.causal ? min(qi, p.Sk - 1) : p.Sk - 1) - kbase;
      const int lo = p.has_window ? qi - p.window + 1 - kbase : 0;
      bool ok[SC];
#pragma unroll
      for (int u = 0; u < SC; ++u) {
        float x = s[r][u] * p.scale;
        if (p.has_cap) x = p.cap * tanhf(x / p.cap);
        x *= kLog2e;
        ok[u] = inside || (u >= lo && u <= hi);
        s[r][u] = ok[u] ? x : kNegInf;
      }
      float mx = tree_max(s[r]);
#pragma unroll
      for (int off = kRowLanes / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
#pragma unroll
      for (int u = 0; u < SC; ++u)
        s[r][u] = ok[u] ? ex2(s[r][u] - m_new) : 0.f;
#pragma unroll
      for (int i = 0; i < SC / 4; ++i)
        p4[r * (BK / 4) + kg * (SC / 4) + i] =
            make_float4(s[r][4 * i], s[r][4 * i + 1], s[r][4 * i + 2],
                        s[r][4 * i + 3]);
      // l stays this lane's share of the row's sum (every lane of the row
      // rescales by the same alpha); the shares are added once, at the end
      const float alpha = ex2(m[r] - m_new);
      l[r] = alpha * l[r] + tree_sum(s[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * OW; ++c) acc[r][c] *= alpha;
    }
    if (next) {
      cp_async_wait<1>();  // v of this tile landed; the next k may not have
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... for every thread, and p is written

    // acc += p v over this lane's rows and columns 4 (kg + 8 w) + (0..3)
#pragma unroll 2
    for (int jc = 0; jc < BK / 4; ++jc) {
      float4 a[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = p4[r * (BK / 4) + jc];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 vv[OW];
#pragma unroll
        for (int w = 0; w < OW; ++w)
          vv[w] = v4[(4 * jc + e) * DC + kRowLanes * w];
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float pe = lane_of(a[r], e);
#pragma unroll
          for (int w = 0; w < OW; ++w) {
            acc[r][4 * w] = fmaf(pe, vv[w].x, acc[r][4 * w]);
            acc[r][4 * w + 1] = fmaf(pe, vv[w].y, acc[r][4 * w + 1]);
            acc[r][4 * w + 2] = fmaf(pe, vv[w].z, acc[r][4 * w + 2]);
            acc[r][4 * w + 3] = fmaf(pe, vv[w].w, acc[r][4 * w + 3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with v and p
    if (next) load_v(k0 + BK);
  }

#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int off = kRowLanes / 2; off > 0; off >>= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
  T* ob = static_cast<T*>(p.o);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (row0 + r >= nq) continue;
    T* orow = ob + ((static_cast<long long>(b) * p.Sq + q0 + row0 + r) *
                        p.H + h) * static_cast<long long>(p.D);
#pragma unroll
    for (int w = 0; w < OW; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * (kRowLanes * w + kg) + e;
        if (c < p.D) put(orow + c, l[r] > 0.f ? acc[r][4 * w + e] / l[r]
                                              : 0.f);
      }
  }
}

template <typename T, int DP, bool ASYNC>
int launch_tile(const Params& p, int B, cudaStream_t stream) {
  const auto kernel = flash_kernel<T, DP, ASYNC>;
  const size_t smem = smem_bytes(p.D);
  if (smem > 48u * 1024u) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(B) * p.H,
                  (p.Sq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, Tile<DP>::NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ASYNC>
int launch(const Params& p, int B, cudaStream_t stream) {
  switch (head_dim_pad(p.D)) {
    case 64:
      return launch_tile<T, 64, ASYNC>(p, B, stream);
    case 128:
      return launch_tile<T, 128, ASYNC>(p, B, stream);
    default:
      return launch_tile<T, 256, ASYNC>(p, B, stream);
  }
}

// fp32 rows cp.async can copy: D % 4 == 0, 16-byte aligned pointers and
// (B, S, H) strides that are multiples of 4 elements.
bool async_rows(const Params& p) {
  const auto al = [](const void* ptr) {
    return reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
  };
  bool ok = p.D % 4 == 0 && al(p.q) && al(p.k) && al(p.v);
  for (int i = 0; i < 3; ++i)
    ok = ok && p.sq[i] % 4 == 0 && p.sk[i] % 4 == 0 && p.sv[i] % 4 == 0;
  return ok;
}

}  // namespace

// Plain C entry point (bound with ctypes).  q (B, Sq, H, D), k and v
// (B, Sk, KH, D), all of one type: float32 (dtype = 0), bfloat16 (1) or
// float16 (2), with a contiguous last axis and D <= 256; `strides` holds 9
// element strides, the (B, S, H) strides of q, k, v in that order.  Writes
// o (B, Sq, H, D) contiguous in that type.  The softcap applies when
// has_cap != 0, the window when has_window != 0.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const void* strides, int B, int Sq,
                                     int Sk, int H, int KH, int D,
                                     float scale, int has_cap, float cap,
                                     int causal, int has_window, int window,
                                     int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || KH < 1 || D < 1 || H % KH ||
      dtype < 0 || dtype > 2 || D > kMaxHeadDim ||
      smem_bytes(D) > kMaxSmem || (Sq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  const long long* s = static_cast<const long long*>(strides);
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = s[i];
    p.sk[i] = s[3 + i];
    p.sv[i] = s[6 + i];
  }
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
  switch (dtype) {
    case 0:
      return async_rows(p) ? launch<float, true>(p, B, cs)
                           : launch<float, false>(p, B, cs);
    case 1:
      return launch<__nv_bfloat16, false>(p, B, cs);
    default:
      return launch<__half, false>(p, B, cs);
  }
}
