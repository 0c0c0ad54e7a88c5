// Chunkwise stabilised mLSTM (xLSTM's matrix-memory mixer) for Hopper
// (sm_90a): the prefill of every mLSTM layer of xlstm-1.3b.
//
// Replaces the TPU kernel `mlstm_chunkwise` (src/repro/kernels/
// mlstm_chunk.py, body `_kernel`).  Layouts are the JAX package's, heads
// flattened: q, k, v (BH,S,dh) in fp32 or bf16 (one type), k pre-scaled by
// 1/sqrt(dh); i_pre, f_pre (BH,S) fp32; h (BH,S,dh) in q's type.  Beyond
// the Pallas kernel it takes any S (the last chunk is masked) and writes
// the final state C (BH,dh,dh), n (BH,dh), m (BH) in fp32, which the
// prefill hands to the decode cache; it may start from a given state.
//
// Math per head and chunk of Lc <= L valid tokens (mlstm_chunk.py:10-17):
//   b_j = sum_{s<=j} logsigmoid(f_s),  g = b_{Lc-1}
//   m_j = max(b_j + m_prev, max_{s<=j} (b_j - b_s + i_s))
//   w_js = (q_j . k_s) exp(b_j - b_s + i_s - m_j)                (s <= j)
//   h_j = [e^{b_j+m_prev-m_j} q_j C + sum_s w_js v_s]
//         / max(|e^{b_j+m_prev-m_j} q_j . n + sum_s w_js|, e^{-m_j})
//   m' = max(g + m_prev, max_s (g - b_s + i_s)),  a_s = e^{g-b_s+i_s-m'}
//   C' = e^{g+m_prev-m'} C + sum_s a_s k_s v_s^T   (n' likewise with v = 1)
//
// What bounds it on the H100: operations.  The two dh x dh products per
// token (q C and the k v^T update) are 4 S dh^2 FLOPs per head: at the
// serving prefill (H 4, S 1024, dh 1024) 17 GFLOP against ~50 MB of
// operands and state.
//
// Design.  C of one head is dh x dh fp32, 4 MiB at dh 1024: far above a
// CTA's 227 KB of shared memory.  Each CTA therefore owns one head's
// column tile C[:, e0:e0+kTV] (128 KB at dh 1024, dynamic shared memory)
// and walks the chunks in order; q and k stream through shared memory in
// kDK-row tiles, the next tile's global loads in flight while the current
// one is used.  What does not depend on the column tile is shared or
// cheap: the q k^T products of a chunk (L x L x dh) are computed once per
// (head, chunk) by a first kernel, fully parallel, into an fp32 scratch
// that every column CTA of the head reads; the gates, the m trajectory
// and the weights w are O(L^2) per chunk and each CTA recomputes them;
// n is carried by every CTA as one more column (O(L dh) a chunk, 1/kTV of
// the main work).  Products run on CUDA cores in fp32: wgmma/TMA and a
// bf16 C are later work.
#include "common.cuh"

namespace {

constexpr int kL = 64;             // chunk length
constexpr int kTV = 32;            // value columns (of C and h) per CTA
constexpr int kDK = 64;            // q / k columns per streamed tile
constexpr int kPad = kDK + 1;      // padded shared row of a q / k tile
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;     // finite "minus infinity" of m

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// A kL x kDK tile of a row-major (rows, dh) matrix of T, moved as 16-byte
// vectors: `load` issues the global reads into registers (rows at or past
// `rows` read as zero), `store` writes them to shared memory as fp32 with
// the padded row stride kPad, each row times scale[row] when given.
template <typename T>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kPerRow = kDK / kVec;
  static constexpr int kN = kL * kPerRow / kThreads;
  uint4 r[kN];

  __device__ __forceinline__ void load(const T* base, int dh, int rows,
                                       int c0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int x = threadIdx.x + i * kThreads;
      const int row = x / kPerRow, cv = x % kPerRow;
      r[i] = row < rows
                 ? *reinterpret_cast<const uint4*>(
                       base + (long long)row * dh + c0 + cv * kVec)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(float* s, const float* scale) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int x = threadIdx.x + i * kThreads;
      const int row = x / kPerRow, cv = x % kPerRow;
      float f[kVec];
      unpack(r[i], f, T());
      const float sc = scale ? scale[row] : 1.f;
#pragma unroll
      for (int u = 0; u < kVec; ++u) s[row * kPad + cv * kVec + u] = f[u] * sc;
    }
  }
};

// q k^T of every chunk: scores[bh][c][j][s] = q_{t0+j} . k_{t0+s} over the
// full head dim (rows past S are zero).  One CTA per (chunk, head); each
// thread owns a 4 x 4 block of the kL x kL tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    float* __restrict__ scores, int S, int dh) {
  __shared__ float qs[kL * kPad];
  __shared__ float ks[kL * kPad];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int t0 = c * kL;
  const int rows = min(kL, S - t0);
  const T* qb = q + ((long long)bh * S + t0) * dh;
  const T* kb = k + ((long long)bh * S + t0) * dh;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[4][4] = {};
  Tile<T> tq, tk;
  tq.load(qb, dh, rows, 0);
  tk.load(kb, dh, rows, 0);
  for (int d0 = 0; d0 < dh; d0 += kDK) {
    __syncthreads();
    tq.store(qs, nullptr);
    tk.store(ks, nullptr);
    __syncthreads();
    if (d0 + kDK < dh) {
      tq.load(qb, dh, rows, d0 + kDK);
      tk.load(kb, dh, rows, d0 + kDK);
    }
#pragma unroll 8
    for (int d = 0; d < kDK; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(tr + 16 * i) * kPad + d];
        b[i] = ks[(tc + 16 * i) * kPad + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  float* out = scores + ((long long)bh * gridDim.x + c) * kL * kL;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(tr + 16 * i) * kL + tc + 16 * j] = acc[i][j];
}

__host__ __device__ constexpr size_t smem_floats(int dh) {
  // C tile, n, q/k tile, v tile, w, eight per-token gate vectors, m'
  return (size_t)dh * kTV + dh + kL * kPad + kL * kTV + kL * (kL + 1) +
         8 * kL + 4;
}

// One CTA per (column tile e0, head): the recurrence over every chunk.
// Thread t owns rows j = t/8 and t/8 + 32 of a chunk and columns
// e0 + 4 (t%8) .. +3 of h; in the state update, rows d0 + t/8 and
// d0 + t/8 + 32 of C with the same columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_chunkwise_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ i_pre,
                       const float* __restrict__ f_pre,
                       const float* __restrict__ scores,
                       const float* __restrict__ C0,
                       const float* __restrict__ n0,
                       const float* __restrict__ m0, T* __restrict__ h,
                       float* __restrict__ C_out, float* __restrict__ n_out,
                       float* __restrict__ m_out, int S, int dh) {
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);   // dh x kTV
  float* ns = Cs + dh * kTV;                     // dh
  float* tile = ns + dh;                         // kL x kPad
  float* vs = tile + kL * kPad;                  // kL x kTV
  float* ws = vs + kL * kTV;                     // kL x (kL + 1)
  float* lf = ws + kL * (kL + 1);                // log f
  float* ii = lf + kL;                           // i
  float* bb = ii + kL;                           // b (cumulative log f)
  float* mj = bb + kL;                           // m_j
  float* inter = mj + kL;                        // e^{b_j + m_prev - m_j}
  float* sg = inter + kL;                        // g - b_s + i_s
  float* kvw = sg + kL;                          // a_s
  float* rs = kvw + kL;                          // sum_s w_js
  float* mnew = rs + kL;                         // m'

  const int e0 = blockIdx.x * kTV;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / 8, cg = tid % 8;
  const long long head = (long long)bh * S;
  const int nc = (S + kL - 1) / kL;

  for (int x = tid; x < dh * kTV; x += kThreads) {
    const int d = x / kTV, e = x % kTV;
    Cs[x] = C0 ? C0[((long long)bh * dh + d) * dh + e0 + e] : 0.f;
  }
  for (int d = tid; d < dh; d += kThreads)
    ns[d] = n0 ? n0[(long long)bh * dh + d] : 0.f;
  float m_prev = m0 ? m0[bh] : kNeg;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kL;
    const int Lc = min(kL, S - t0);
    __syncthreads();                      // the last chunk is done with all
    if (tid < kL) {
      const bool in = tid < Lc;
      lf[tid] = in ? log_sigmoid(f_pre[head + t0 + tid]) : 0.f;
      ii[tid] = in ? i_pre[head + t0 + tid] : 0.f;
    }
    {  // the chunk's value rows for this column tile (rows >= Lc zero)
      constexpr int kVec = 16 / sizeof(T);
      constexpr int kPerRow = kTV / kVec;
      const T* vb = v + (head + t0) * dh + e0;
      for (int x = tid; x < kL * kPerRow; x += kThreads) {
        const int row = x / kPerRow, cv = x % kPerRow;
        float f[kVec];
        const uint4 u = row < Lc ? *reinterpret_cast<const uint4*>(
                                       vb + (long long)row * dh + cv * kVec)
                                 : make_uint4(0u, 0u, 0u, 0u);
        unpack(u, f, T());
#pragma unroll
        for (int w = 0; w < kVec; ++w) vs[row * kTV + cv * kVec + w] = f[w];
      }
    }
    __syncthreads();
    if (tid < kL) {                       // inclusive cumsum, in order
      float s = 0.f;
      for (int u = 0; u <= tid; ++u) s += lf[u];
      bb[tid] = s;
    }
    __syncthreads();
    const float g = bb[Lc - 1];           // b at the last VALID token
    if (tid < kL) {
      const int j = tid;
      if (j < Lc) {
        const float bj = bb[j];
        float mi = kNeg;
        for (int s = 0; s <= j; ++s) mi = fmaxf(mi, bj - bb[s] + ii[s]);
        const float mm = fmaxf(mi, bj + m_prev);
        mj[j] = mm;
        inter[j] = expf(bj + m_prev - mm);
        sg[j] = g - bj + ii[j];
      } else {
        mj[j] = 0.f;
        inter[j] = 0.f;
        sg[j] = kNeg;
      }
    }
    __syncthreads();
    const float* sc = scores + ((long long)bh * nc + c) * kL * kL;
    for (int x = tid; x < kL * kL; x += kThreads) {
      const int j = x / kL, s = x % kL;
      float w = 0.f;
      if (s <= j && j < Lc) w = sc[x] * expf(bb[j] - bb[s] + ii[s] - mj[j]);
      ws[j * (kL + 1) + s] = w;
    }
    if (tid < 32) {
      const float mx = warp_max(fmaxf(sg[tid], sg[tid + 32]));
      if (tid == 0) mnew[0] = fmaxf(g + m_prev, mx);
    }
    __syncthreads();
    const float m_new = mnew[0];
    const float carry = expf(g + m_prev - m_new);
    if (tid < kL) {
      kvw[tid] = tid < Lc ? expf(sg[tid] - m_new) : 0.f;
      float s = 0.f;
      for (int u = 0; u < kL; ++u) s += ws[tid * (kL + 1) + u];
      rs[tid] = s;
    }

    // ---- q C and q . n over streamed q tiles (C, n still the old state)
    float acc[2][4] = {};
    float qn0 = 0.f, qn1 = 0.f;
    const T* qb = q + (head + t0) * dh;
    Tile<T> tl;
    tl.load(qb, dh, Lc, 0);
    for (int d0 = 0; d0 < dh; d0 += kDK) {
      __syncthreads();
      tl.store(tile, nullptr);
      __syncthreads();
      if (d0 + kDK < dh) tl.load(qb, dh, Lc, d0 + kDK);
      const float* Crow = Cs + d0 * kTV + 4 * cg;
#pragma unroll 8
      for (int d = 0; d < kDK; ++d) {
        const float a0 = tile[r * kPad + d], a1 = tile[(r + 32) * kPad + d];
        const float4 cv = *reinterpret_cast<const float4*>(Crow + d * kTV);
        acc[0][0] = fmaf(a0, cv.x, acc[0][0]);
        acc[0][1] = fmaf(a0, cv.y, acc[0][1]);
        acc[0][2] = fmaf(a0, cv.z, acc[0][2]);
        acc[0][3] = fmaf(a0, cv.w, acc[0][3]);
        acc[1][0] = fmaf(a1, cv.x, acc[1][0]);
        acc[1][1] = fmaf(a1, cv.y, acc[1][1]);
        acc[1][2] = fmaf(a1, cv.z, acc[1][2]);
        acc[1][3] = fmaf(a1, cv.w, acc[1][3]);
      }
      for (int d = cg; d < kDK; d += 8) {
        qn0 = fmaf(tile[r * kPad + d], ns[d0 + d], qn0);
        qn1 = fmaf(tile[(r + 32) * kPad + d], ns[d0 + d], qn1);
      }
    }
    for (int o = 1; o < 8; o <<= 1) {     // the 8 lanes of one row pair
      qn0 += __shfl_xor_sync(0xffffffffu, qn0, o);
      qn1 += __shfl_xor_sync(0xffffffffu, qn1, o);
    }

    // ---- intra-chunk term, normaliser, h
    float wv[2][4] = {};
    for (int s = 0; s < Lc; ++s) {
      const float w0 = ws[r * (kL + 1) + s], w1 = ws[(r + 32) * (kL + 1) + s];
      const float4 vv = *reinterpret_cast<const float4*>(vs + s * kTV + 4 * cg);
      wv[0][0] = fmaf(w0, vv.x, wv[0][0]);
      wv[0][1] = fmaf(w0, vv.y, wv[0][1]);
      wv[0][2] = fmaf(w0, vv.z, wv[0][2]);
      wv[0][3] = fmaf(w0, vv.w, wv[0][3]);
      wv[1][0] = fmaf(w1, vv.x, wv[1][0]);
      wv[1][1] = fmaf(w1, vv.y, wv[1][1]);
      wv[1][2] = fmaf(w1, vv.z, wv[1][2]);
      wv[1][3] = fmaf(w1, vv.w, wv[1][3]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int j = r + 32 * a;
      if (j < Lc) {
        const float it = inter[j];
        const float den = it * (a ? qn1 : qn0) + rs[j];
        const float dn = fmaxf(fabsf(den), expf(-mj[j]));
        T* hr = h + (head + t0 + j) * dh + e0 + 4 * cg;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          hr[u] = from_f<T>((it * acc[a][u] + wv[a][u]) / dn);
      }
    }

    // ---- state update over streamed k tiles, each row scaled by a_s
    const T* kb = k + (head + t0) * dh;
    tl.load(kb, dh, Lc, 0);
    for (int d0 = 0; d0 < dh; d0 += kDK) {
      __syncthreads();
      tl.store(tile, kvw);
      __syncthreads();
      if (d0 + kDK < dh) tl.load(kb, dh, Lc, d0 + kDK);
      float u0[4] = {}, u1[4] = {};
      for (int s = 0; s < Lc; ++s) {
        const float k0 = tile[s * kPad + r], k1 = tile[s * kPad + r + 32];
        const float4 vv = *reinterpret_cast<const float4*>(vs + s * kTV + 4 * cg);
        u0[0] = fmaf(k0, vv.x, u0[0]);
        u0[1] = fmaf(k0, vv.y, u0[1]);
        u0[2] = fmaf(k0, vv.z, u0[2]);
        u0[3] = fmaf(k0, vv.w, u0[3]);
        u1[0] = fmaf(k1, vv.x, u1[0]);
        u1[1] = fmaf(k1, vv.y, u1[1]);
        u1[2] = fmaf(k1, vv.z, u1[2]);
        u1[3] = fmaf(k1, vv.w, u1[3]);
      }
      float nk0 = 0.f, nk1 = 0.f;
      for (int s = cg; s < Lc; s += 8) {
        nk0 += tile[s * kPad + r];
        nk1 += tile[s * kPad + r + 32];
      }
      for (int o = 1; o < 8; o <<= 1) {
        nk0 += __shfl_xor_sync(0xffffffffu, nk0, o);
        nk1 += __shfl_xor_sync(0xffffffffu, nk1, o);
      }
      float4* c0 = reinterpret_cast<float4*>(Cs + (d0 + r) * kTV + 4 * cg);
      float4* c1 = reinterpret_cast<float4*>(Cs + (d0 + r + 32) * kTV + 4 * cg);
      float4 x0 = *c0, x1 = *c1;
      x0.x = fmaf(carry, x0.x, u0[0]);
      x0.y = fmaf(carry, x0.y, u0[1]);
      x0.z = fmaf(carry, x0.z, u0[2]);
      x0.w = fmaf(carry, x0.w, u0[3]);
      x1.x = fmaf(carry, x1.x, u1[0]);
      x1.y = fmaf(carry, x1.y, u1[1]);
      x1.z = fmaf(carry, x1.z, u1[2]);
      x1.w = fmaf(carry, x1.w, u1[3]);
      *c0 = x0;
      *c1 = x1;
      if (cg == 0) {
        ns[d0 + r] = fmaf(carry, ns[d0 + r], nk0);
        ns[d0 + r + 32] = fmaf(carry, ns[d0 + r + 32], nk1);
      }
    }
    m_prev = m_new;
  }

  __syncthreads();
  for (int x = tid; x < dh * kTV; x += kThreads) {
    const int d = x / kTV, e = x % kTV;
    C_out[((long long)bh * dh + d) * dh + e0 + e] = Cs[x];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < dh; d += kThreads) n_out[(long long)bh * dh + d] = ns[d];
    if (tid == 0) m_out[bh] = m_prev;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* i_pre,
           const float* f_pre, float* scores, const float* C0,
           const float* n0, const float* m0, void* h, float* C, float* n,
           float* m, int BH, int S, int dh, cudaStream_t stream) {
  const int nc = (S + kL - 1) / kL;
  mlstm_scores_kernel<T><<<dim3(nc, BH), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), scores, S, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(dh) * sizeof(float);
  err = cudaFuncSetAttribute(mlstm_chunkwise_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_chunkwise_kernel<T><<<dim3(dh / kTV, BH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), i_pre, f_pre, scores, C0, n0, m0,
      static_cast<T*>(h), C, n, m, S, dh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of q, k, v and h): 0 = float32, 1 = bfloat16.  `chunk` must be
// the kernel's chunk length (the wrapper sizes `scores`, (BH, ceil(S /
// chunk), chunk, chunk) fp32, from it); dh a multiple of kDK up to 1024.
// C0, n0, m0 may be null together: a fresh state (zeros, m = -1e30).  The
// outputs must not alias the inputs.  Returns the cudaError_t of the
// launches (0 = launched).
extern "C" int mlstm_chunkwise_launch(
    const void* q, const void* k, const void* v, const void* i_pre,
    const void* f_pre, void* scores, const void* C0, const void* n0,
    const void* m0, void* h, void* C, void* n, void* m, int BH, int S,
    int dh, int chunk, int dtype, void* stream) {
  if (chunk != kL || BH <= 0 || S <= 0 || dh <= 0 || dh % kDK != 0 ||
      dh > 1024)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, f(i_pre), f(f_pre), w(scores), f(C0),
                         f(n0), f(m0), h, w(C), w(n), w(m), BH, S, dh, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, f(i_pre), f(f_pre), w(scores),
                                 f(C0), f(n0), f(m0), h, w(C), w(n), w(m), BH,
                                 S, dh, s);
  return (int)cudaErrorInvalidValue;
}
