// Chunkwise mLSTM forward for Hopper (sm_90a): the xLSTM matrix-memory
// recurrence over a whole prompt, with the (C, n, m) state carried on chip
// from chunk to chunk.
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
//
// What bounds it on the H100: operations.  Per chunk a (b, h) pair does
// L^2 (dk + dv) + 2 L dk dv multiply-adds against 2 L (dk + dv) inputs read,
// some 30 multiply-adds per byte at full width (L = 64, dk = 96, dv = 192),
// above the fp32 ridge of the card (67 TFLOP/s over 3.35 TB/s, 20 per byte).
// This first version keeps every operand in shared memory and does the
// products with fp32 FMAs on the CUDA cores, not the tensor cores, so fp32
// inputs give fp32 results as the TPU kernel's f32 accumulation does.
//
// The TPU grid walked the chunks in order with the state in VMEM scratch.
// Here one block owns one (b, h) and one tile of kTileV columns of v and
// walks every chunk in order itself, the state tile C[:, tile] in shared
// memory: grid (B * nh, ceil(dv / kTileV)).  Every block of a (b, h)
// recomputes the chunk's scores, gates, n and den (the same in each tile);
// splitting dv gives three times more blocks, which matters at B = 1 (the
// one-request prefill of the batched server has only nh = 8 (b, h) pairs).
// Rows of q and k in shared memory are padded to dk + 1 floats and the
// probabilities to L + 1, so a warp walking a column touches 32 banks.
//
// F is summed by one thread in double precision, left to right: the sums of
// up to 128 fp32 values are exact in double unless their exponents span more
// than 29 bits, so the plain version's double cumsum gives the same F.  exp
// is expf and the division IEEE; the build uses no fast-math flag.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileV = 64;
constexpr int kMaxChunk = 128;
constexpr float kNegBig = -1e9f;

// Element strides of the (B, S, nh) axes of each input; the last axis of
// q, k and v is contiguous.
struct Strides {
  long long q[3], k[3], v[3], li[3], lf[3];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ li, const float* __restrict__ lf,
    T* __restrict__ h, float* __restrict__ C_out, float* __restrict__ n_out,
    float* __restrict__ m_out, Strides st, int S, int nh, int dk, int dv,
    int L) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / nh, hd = bh - b * nh;
  const int v0 = blockIdx.y * kTileV;
  const int tw = min(kTileV, dv - v0);
  const int dkp = dk + 1, Lp = L + 1;
  float* Cs = smem;               // dk x kTileV, this block's columns of C
  float* ns = Cs + dk * kTileV;   // dk
  float* qs = ns + dk;            // L x dkp
  float* ks = qs + L * dkp;       // L x dkp
  float* vs = ks + L * dkp;       // L x kTileV
  float* ps = vs + L * kTileV;    // L x Lp, p[t][u]
  float* Fs = ps + L * Lp;        // L
  float* lis = Fs + L;            // L
  float* mts = lis + L;           // L, m_t
  float* sgs = mts + L;           // L, sgate_t
  float* dens = sgs + L;          // L, den_t
  float* kgs = dens + L;          // L, kg_u
  float* sc = kgs + L;            // m_end, decay

  const T* qb = q + b * st.q[0] + hd * st.q[2];
  const T* kb = k + b * st.k[0] + hd * st.k[2];
  const T* vb = v + b * st.v[0] + hd * st.v[2] + v0;
  const float* lib = li + b * st.li[0] + hd * st.li[2];
  const float* lfb = lf + b * st.lf[0] + hd * st.lf[2];
  T* hb = h + (static_cast<long long>(b) * S * nh + hd) * dv + v0;
  const long long h_row = static_cast<long long>(nh) * dv;

  for (int e = t; e < dk * kTileV; e += kThreads) Cs[e] = 0.f;
  for (int e = t; e < dk; e += kThreads) ns[e] = 0.f;
  float m_prev = kNegBig;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int nv = min(L, S - c0);  // valid rows of this chunk
    for (int e = t; e < L * dk; e += kThreads) {
      const int r = e / dk, d = e - r * dk;
      float qv = 0.f, kv = 0.f;
      if (r < nv) {
        const long long s = c0 + r;
        qv = to_f32(qb[s * st.q[1] + d]);
        kv = to_f32(kb[s * st.k[1] + d]);
      }
      qs[r * dkp + d] = qv;
      ks[r * dkp + d] = kv;
    }
    for (int e = t; e < L * tw; e += kThreads) {
      const int r = e / tw, c = e - r * tw;
      vs[r * kTileV + c] =
          r < nv ? to_f32(vb[(c0 + r) * st.v[1] + c]) : 0.f;
    }
    for (int r = t; r < L; r += kThreads) {
      const long long s = c0 + r;
      lis[r] = r < nv ? lib[s * st.li[1]] : kNegBig;
      Fs[r] = r < nv ? lfb[s * st.lf[1]] : 0.f;  // log f until the cumsum
    }
    __syncthreads();
    if (t == 0) {
      double acc = 0.0;
      for (int r = 0; r < L; ++r) {
        acc += static_cast<double>(Fs[r]);
        Fs[r] = static_cast<float>(acc);
      }
    }
    __syncthreads();

    // row stabilizers; the last thread does the end-of-chunk ones
    for (int r = t; r < L; r += kThreads) {
      const float Ft = Fs[r];
      float wmax = -INFINITY;
      for (int u = 0; u <= r; ++u) wmax = fmaxf(wmax, (Ft - Fs[u]) + lis[u]);
      const float m_in = m_prev + Ft;
      const float mt = fmaxf(wmax, m_in);
      mts[r] = mt;
      sgs[r] = expf(m_in - mt);
    }
    if (t == kThreads - 1) {
      const float FL = Fs[L - 1];
      float wmax = -INFINITY;
      for (int u = 0; u < L; ++u) wmax = fmaxf(wmax, (FL - Fs[u]) + lis[u]);
      const float m_fl = m_prev + FL;
      const float m_end = fmaxf(wmax, m_fl);
      for (int u = 0; u < L; ++u)
        kgs[u] = expf(((FL - Fs[u]) + lis[u]) - m_end);
      sc[0] = m_end;
      sc[1] = expf(m_fl - m_end);
    }
    __syncthreads();

    // p[t][u]: a warp takes 32 consecutive u of one row
    for (int e = t; e < L * L; e += kThreads) {
      const int r = e / L, u = e - r * L;
      float p = 0.f;
      if (u <= r) {
        float s = 0.f;
        for (int d = 0; d < dk; ++d)
          s = fmaf(qs[r * dkp + d], ks[u * dkp + d], s);
        p = s * expf(((Fs[r] - Fs[u]) + lis[u]) - mts[r]);
      }
      ps[r * Lp + u] = p;
    }
    __syncthreads();

    for (int r = t; r < L; r += kThreads) {
      float di = 0.f;
      for (int u = 0; u <= r; ++u) di += ps[r * Lp + u];
      float qn = 0.f;
      for (int d = 0; d < dk; ++d) qn = fmaf(qs[r * dkp + d], ns[d], qn);
      dens[r] = fmaxf(fabsf(di + qn * sgs[r]), expf(-mts[r]));
    }
    __syncthreads();

    // h of the valid rows: a warp takes 32 consecutive columns of one row
    for (int e = t; e < L * tw; e += kThreads) {
      const int r = e / tw, c = e - r * tw;
      if (r >= nv) continue;
      float a = 0.f;
      for (int u = 0; u <= r; ++u)
        a = fmaf(ps[r * Lp + u], vs[u * kTileV + c], a);
      float qc = 0.f;
      for (int d = 0; d < dk; ++d)
        qc = fmaf(qs[r * dkp + d], Cs[d * kTileV + c], qc);
      put(hb + (c0 + r) * h_row + c, (a + qc * sgs[r]) / dens[r]);
    }
    __syncthreads();

    // state to the chunk's end
    const float decay = sc[1];
    for (int e = t; e < dk * tw; e += kThreads) {
      const int kk = e / tw, c = e - kk * tw;
      float acc = 0.f;
      for (int u = 0; u < L; ++u)
        acc = fmaf(ks[u * dkp + kk] * kgs[u], vs[u * kTileV + c], acc);
      Cs[kk * kTileV + c] = Cs[kk * kTileV + c] * decay + acc;
    }
    for (int kk = t; kk < dk; kk += kThreads) {
      float acc = 0.f;
      for (int u = 0; u < L; ++u) acc += ks[u * dkp + kk] * kgs[u];
      ns[kk] = ns[kk] * decay + acc;
    }
    m_prev = sc[0];
    __syncthreads();
  }

  for (int e = t; e < dk * tw; e += kThreads) {
    const int kk = e / tw, c = e - kk * tw;
    C_out[(static_cast<long long>(bh) * dk + kk) * dv + v0 + c] =
        Cs[kk * kTileV + c];
  }
  if (blockIdx.y == 0) {
    for (int kk = t; kk < dk; kk += kThreads)
      n_out[static_cast<long long>(bh) * dk + kk] = ns[kk];
    if (t == 0) m_out[bh] = m_prev;
  }
}

size_t smem_bytes(int dk, int L) {
  const size_t floats = static_cast<size_t>(dk) * kTileV + dk +
                        2ull * L * (dk + 1) + static_cast<size_t>(L) * kTileV +
                        static_cast<size_t>(L) * (L + 1) + 6ull * L + 2;
  return floats * sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* li,
           const void* lf, void* h, void* C, void* n, void* m,
           const Strides& st, int B, int S, int nh, int dk, int dv, int L,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(dk, L);
  if (smem > 48u * 1024u) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlstm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(B) * nh, (dv + kTileV - 1) / kTileV);
  mlstm_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(li),
      static_cast<const float*>(lf), static_cast<T*>(h),
      static_cast<float*>(C), static_cast<float*>(n), static_cast<float*>(m),
      st, S, nh, dk, dv, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  q, k (B, S, nh, dk) and v
// (B, S, nh, dv) are float32 (bf16 = 0) or bfloat16 (bf16 = 1) with a
// contiguous last axis; log_i, log_f (B, S, nh) float32; `strides` holds 15
// element strides, the (B, S, nh) strides of q, k, v, log_i, log_f in that
// order.  Writes h (B, S, nh, dv) contiguous in q's type and the final
// C (B, nh, dk, dv), n (B, nh, dk), m (B, nh) in float32.  L is the chunk
// length, 8 <= L <= 128.  Returns cudaGetLastError() after the launch
// (0 = success).
extern "C" int repro_mlstm(const void* q, const void* k, const void* v,
                           const void* li, const void* lf, void* h, void* C,
                           void* n, void* m, const void* strides, int B,
                           int S, int nh, int dk, int dv, int L, int bf16,
                           void* stream) {
  if (B < 1 || S < 1 || nh < 1 || dk < 1 || dv < 1 || L < 8 ||
      L > kMaxChunk || smem_bytes(dk, L) > 232448u)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  const long long* s = static_cast<const long long*>(strides);
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.li[i] = s[9 + i];
    st.lf[i] = s[12 + i];
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, li, lf, h, C, n, m, st, B, S,
                                      nh, dk, dv, L, cs)
              : launch<float>(q, k, v, li, lf, h, C, n, m, st, B, S, nh, dk,
                              dv, L, cs);
}
