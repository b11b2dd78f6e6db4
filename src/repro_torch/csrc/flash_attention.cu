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
// kernel casts them to fp32 before both products; expf, tanhf and the IEEE
// division are used (the build has no fast-math flag).
//
// What bounds it on the H100: operations.  Per head and unmasked (q, k)
// pair it does 2 D multiply-adds for 4 D bytes of q, k, v and o shared by
// a whole row or column, far above the ridge of either rate.  This first
// version does the products with fp32 FMAs on the CUDA cores (67 TFLOP/s),
// not the tensor cores (989 TFLOP/s in bf16): its ceiling is the fp32 one.
//
// The TPU grid walked the kv blocks in order (its third axis "arbitrary"),
// the running (m, l, acc) in VMEM scratch.  Here one block owns one
// (batch, head) and one tile of kBlockQ query rows, and walks the kv tiles
// itself with (m, l) in registers and acc in shared memory: grid
// (B * H, ceil(Sq / kBlockQ)), the tiles with the most keys first.  kv
// tiles wholly outside the causal or window band are skipped, which is
// exact: a fully masked tile leaves (m, l, acc) as they were.  GQA: query
// head h reads kv head h / (H / KH).  The ragged Sq and Sk edges are
// masked; rows past them are zero in shared memory and never written.
//
// Threads: 256, thread (ty, tx) = (t / 16, t % 16) owns query rows
// ty + 16 a (a < 4) of the tile, the scores of columns tx + 16 c and the
// output columns tx + 16 c'.  The 16 threads of a row share one warp half,
// so the row max and sum are xor shuffles within it (every lane ends with
// the same bits).  Shared rows are padded to D + 1 floats (scores to
// BK + 1, acc to a stride of 16 mod 32 banks) so a warp reading a column
// touches distinct banks.  Tiles: kBlockQ = 64 rows of q, BK = 64 rows of
// k and v for D <= 128 and 32 above, all in fp32: 209,664 bytes of shared
// memory at D = 256, opted into above 48 KB.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr float kNegInf = -1e30f;
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

__host__ __device__ __forceinline__ int acc_ld(int D) {
  return (D + 31) / 32 * 32 + 16;
}

__host__ __device__ __forceinline__ int block_k(int D) {
  return D <= 128 ? 64 : 32;
}

size_t smem_bytes(int D) {
  const size_t bk = block_k(D);
  const size_t floats = kBlockQ * (D + 1) + 2 * bk * (D + 1) +
                        kBlockQ * (bk + 1) +
                        static_cast<size_t>(kBlockQ) * acc_ld(D);
  return floats * sizeof(float);
}

template <typename T, int BK>
__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  constexpr int NC = BK / 16;  // score columns per thread
  extern __shared__ float smem[];
  const int D = p.D;
  const int ldq = D + 1, ldp = BK + 1, lda = acc_ld(D);
  float* qs = smem;                  // kBlockQ x ldq
  float* ks = qs + kBlockQ * ldq;    // BK x ldq
  float* vs = ks + BK * ldq;         // BK x ldq
  float* ps = vs + BK * ldq;         // kBlockQ x ldp, this tile's p
  float* acc = ps + kBlockQ * ldp;   // kBlockQ x lda

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int nq = min(kBlockQ, p.Sq - q0);
  const T* qb = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const T* kb = static_cast<const T*>(p.k) + b * p.sk[0] + kvh * p.sk[2];
  const T* vb = static_cast<const T*>(p.v) + b * p.sv[0] + kvh * p.sv[2];

  for (int e = t; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qs[r * ldq + d] =
        r < nq ? to_f32(qb[static_cast<long long>(q0 + r) * p.sq[1] + d])
               : 0.f;
    acc[r * lda + d] = 0.f;
  }
  float m[4], l[4], alpha[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
  }

  // keys that may be unmasked for queries q0 .. q0 + nq - 1
  int k_lo = 0, k_hi = p.Sk;
  if (p.has_window) k_lo = max(0, q0 - p.window + 1);
  if (p.causal) k_hi = min(k_hi, q0 + nq);

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    const int nk = min(BK, p.Sk - k0);
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int e = t; e < BK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      float kv = 0.f, vv = 0.f;
      if (r < nk) {
        const long long s = k0 + r;
        kv = to_f32(kb[s * p.sk[1] + d]);
        vv = to_f32(vb[s * p.sv[1] + d]);
      }
      ks[r * ldq + d] = kv;
      vs[r * ldq + d] = vv;
    }
    __syncthreads();

    float s[4][NC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c) s[a][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qs[(ty + 16 * a) * ldq + d];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = ks[(tx + 16 * c) * ldq + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = q0 + ty + 16 * a;
      bool ok[NC];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int kj = k0 + tx + 16 * c;
        float x = s[a][c] * p.scale;
        if (p.has_cap) x = p.cap * tanhf(x / p.cap);
        ok[c] = qi < p.Sq && kj < p.Sk && (!p.causal || kj <= qi) &&
                (!p.has_window || kj > qi - p.window);
        s[a][c] = ok[c] ? x : kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float pv = ok[c] ? expf(s[a][c] - m_new) : 0.f;
        ps[(ty + 16 * a) * ldp + tx + 16 * c] = pv;
        rs += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      alpha[a] = expf(m[a] - m_new);
      l[a] = alpha[a] * l[a] + rs;
      m[a] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + p v over this thread's rows and columns
    for (int c0 = tx; c0 < D; c0 += 64) {
      bool in[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) in[u] = c0 + 16 * u < D;
      float o[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int u = 0; u < 4; ++u) o[a][u] = 0.f;
      for (int j = 0; j < nk; ++j) {
        float pv[4], vv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) pv[a] = ps[(ty + 16 * a) * ldp + j];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vv[u] = in[u] ? vs[j * ldq + c0 + 16 * u] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int u = 0; u < 4; ++u) o[a][u] = fmaf(pv[a], vv[u], o[a][u]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (in[u]) {
            float* ap = acc + (ty + 16 * a) * lda + c0 + 16 * u;
            *ap = *ap * alpha[a] + o[a][u];
          }
    }
  }
  __syncthreads();

  T* ob = static_cast<T*>(p.o);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (r >= nq) continue;
    T* orow = ob + ((static_cast<long long>(b) * p.Sq + q0 + r) * p.H + h) *
                       static_cast<long long>(D);
    for (int c = tx; c < D; c += 16)
      put(orow + c, l[a] > 0.f ? acc[r * lda + c] / l[a] : 0.f);
  }
}

template <typename T, int BK>
int launch_bk(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  if (smem > 48u * 1024u) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(B) * p.H,
                  (p.Sq + kBlockQ - 1) / kBlockQ);
  flash_kernel<T, BK><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  return block_k(p.D) == 64 ? launch_bk<T, 64>(p, B, stream)
                            : launch_bk<T, 32>(p, B, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  q (B, Sq, H, D), k and v
// (B, Sk, KH, D), all of one type: float32 (dtype = 0), bfloat16 (1) or
// float16 (2), with a contiguous last axis; `strides` holds 9 element
// strides, the (B, S, H) strides of q, k, v in that order.  Writes o
// (B, Sq, H, D) contiguous in that type.  The softcap applies when
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
      dtype < 0 || dtype > 2 || smem_bytes(D) > kMaxSmem ||
      (Sq + kBlockQ - 1) / kBlockQ > 65535)
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
      return launch<float>(p, B, cs);
    case 1:
      return launch<__nv_bfloat16>(p, B, cs);
    default:
      return launch<__half>(p, B, cs);
  }
}
