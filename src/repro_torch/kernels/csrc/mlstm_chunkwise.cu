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
// Two paths, chosen by the storage type (a fixed dispatch, not a
// fallback).  Both keep C of one head, dh x dh fp32 (4 MiB at dh 1024, far
// above a CTA's 227 KB of shared memory), split by value columns over CTAs
// that walk the chunks in order, and both compute the q k^T products of a
// chunk (L x L x dh) once per (head, chunk) in a first kernel, fully
// parallel, into an fp32 scratch that every column CTA of the head reads.
// The gates, the m trajectory and the weights w are O(L^2) per chunk and
// each CTA recomputes them on the CUDA cores (chunk_gates), as it does w v
// and the n column (O(L dh) a chunk).
//
// fp32 (`mlstm_scores_kernel`, `mlstm_chunkwise_kernel`), on the CUDA
// cores, because a tensor-core product in fp32 is TF32, which cannot meet
// the 2e-4 state tolerance: each CTA owns the column tile C[:, e0:e0+kTV]
// (128 KB at dh 1024) in shared memory; q and k stream through shared
// memory in kDK-row tiles, the next tile's global loads in flight while
// the current one is used.
//
// bf16 (`mlstm_scores_mma`, `mlstm_chunkwise_mma`), on mma.sync.m16n8k16
// with fp32 accumulators: the column tile C^T[e0:e0+kMTV, :] lives in the
// accumulator fragments of the CTA's 16 warps, so the state never leaves
// registers between chunks; q and k stream through a cp.async ring in
// kDB-column blocks.  q, k and v are exact bf16 operands; the fp32
// operand of each state product (C for q C, a_s v_s for the update) is
// split into bf16 hi + lo and multiplied twice into the same fp32
// accumulator, which keeps ~16 bits of it: one bf16 rounding (2^-9
// relative a term) would miss the 2e-4 state tolerance.
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

// The chunk's per-token gate vectors, kL floats each, then m'.
struct Gates {
  float* lf;       // log f
  float* ii;       // i
  float* bb;       // b (cumulative log f)
  float* mj;       // m_j
  float* inter;    // e^{b_j + m_prev - m_j}
  float* sg;       // g - b_s + i_s
  float* kvw;      // a_s
  float* rs;       // sum_s w_js
  float* mnew;     // m'
  __device__ __forceinline__ explicit Gates(float* p)
      : lf(p), ii(p + kL), bb(p + 2 * kL), mj(p + 3 * kL), inter(p + 4 * kL),
        sg(p + 5 * kL), kvw(p + 6 * kL), rs(p + 7 * kL), mnew(p + 8 * kL) {}
};
constexpr int kGateFloats = 8 * kL + 4;

// The gate math of the chunk at t0 (Lc valid tokens) and its weights w_js
// into ws (kL x (kL + 1)) from the chunk's q k^T scores sc, by at least
// kL threads; starts and ends with barriers, except that a_s (kvw) and the
// row sums rs are written after the last one.  Returns (m', e^{g + m_prev
// - m'}).  Keeps the cumulative log f and the m trajectory as the header
// states them.
__device__ __forceinline__ float2 chunk_gates(const Gates& G, float* ws,
                                              const float* i_pre,
                                              const float* f_pre,
                                              const float* sc,
                                              long long head, int t0, int Lc,
                                              float m_prev) {
  const int tid = threadIdx.x;
  if (tid < kL) {
    const bool in = tid < Lc;
    G.lf[tid] = in ? log_sigmoid(f_pre[head + t0 + tid]) : 0.f;
    G.ii[tid] = in ? i_pre[head + t0 + tid] : 0.f;
  }
  __syncthreads();
  if (tid < kL) {                       // inclusive cumsum, in order
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kL; ++u)
      if (u <= tid) s += G.lf[u];
    G.bb[tid] = s;
  }
  __syncthreads();
  const float g = G.bb[Lc - 1];         // b at the last VALID token
  if (tid < kL) {
    const int j = tid;
    if (j < Lc) {
      const float bj = G.bb[j];
      float mi = kNeg;
#pragma unroll
      for (int s = 0; s < kL; ++s)
        if (s <= j) mi = fmaxf(mi, bj - G.bb[s] + G.ii[s]);
      const float mm = fmaxf(mi, bj + m_prev);
      G.mj[j] = mm;
      G.inter[j] = expf(bj + m_prev - mm);
      G.sg[j] = g - bj + G.ii[j];
    } else {
      G.mj[j] = 0.f;
      G.inter[j] = 0.f;
      G.sg[j] = kNeg;
    }
  }
  __syncthreads();
  for (int x = tid; x < kL * kL; x += blockDim.x) {
    const int j = x / kL, s = x % kL;
    float w = 0.f;
    if (s <= j && j < Lc)
      w = sc[x] * expf(G.bb[j] - G.bb[s] + G.ii[s] - G.mj[j]);
    ws[j * (kL + 1) + s] = w;
  }
  if (tid < 32) {
    const float mx = warp_max(fmaxf(G.sg[tid], G.sg[tid + 32]));
    if (tid == 0) G.mnew[0] = fmaxf(g + m_prev, mx);
  }
  __syncthreads();
  const float m_new = G.mnew[0];
  if (tid < kL) {
    G.kvw[tid] = tid < Lc ? expf(G.sg[tid] - m_new) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kL; ++u) s += ws[tid * (kL + 1) + u];
    G.rs[tid] = s;
  }
  return make_float2(m_new, expf(g + m_prev - m_new));
}

__host__ __device__ constexpr size_t smem_floats(int dh) {
  // C tile, n, q/k tile, v tile, w, the gate vectors
  return (size_t)dh * kTV + dh + kL * kPad + kL * kTV + kL * (kL + 1) +
         kGateFloats;
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
  const Gates G(ws + kL * (kL + 1));

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
    const float2 mc = chunk_gates(
        G, ws, i_pre, f_pre, scores + ((long long)bh * nc + c) * kL * kL,
        head, t0, Lc, m_prev);
    const float m_new = mc.x, carry = mc.y;

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
        const float it = G.inter[j];
        const float den = it * (a ? qn1 : qn0) + G.rs[j];
        const float dn = fmaxf(fabsf(den), expf(-G.mj[j]));
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
      tl.store(tile, G.kvw);
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

// ------------------------------------------------------------ bf16, mma
constexpr int kDB = 128;           // head-dim columns of a streamed block
constexpr uint32_t kBlockBytes = kL * kDB * 2;   // one bf16 q or k block
constexpr int kMTV = 32;           // value columns (of C and h) per CTA
constexpr int kScoreThreads = 128; // 4 warps x 16 query rows
constexpr int kStages = 2;         // the main kernel's q/k block ring
constexpr int kPairs = kDB / 16;   // warp pairs: one 16-column chunk each
constexpr int kMThreads = 64 * kPairs;   // a pair: two 16-row m-tiles
constexpr int kAVS = kMTV + 8;     // padded row of a v hi / lo (bf16)
constexpr int kHS = kL + 8;        // padded row of the h^T partials

// Rows [0, rows) x columns [d0, d0 + kDB) of a row-major (., dh) bf16
// matrix into a swizzled kL x kDB tile by cp.async (NT threads); rows
// past `rows` and columns past dh are zero-filled, never read.
template <int NT>
__device__ __forceinline__ void load_block(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           int rows, int dh, int d0) {
  constexpr int kChunks = kDB / 8;
#pragma unroll
  for (int it = 0; it < kL * kChunks / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < rows && d0 + c * 8 < dh;
    cp_async16(dst + swz<kDB>(r, c),
               ok ? src + (long long)r * dh + d0 + c * 8 : src, ok ? 16 : 0);
  }
}

// x and y as bf16 pairs hi + lo: hi = bf16(x), lo = bf16(x - hi), about 16
// significant bits of each between them
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// q k^T of every chunk on mma.sync, as mlstm_scores_kernel: one CTA of 4
// warps per (chunk, head), warp w the 16 query rows 16w.., q and k streamed
// in kDB-column blocks through a 2-stage cp.async ring.  bf16 products are
// exact in the fp32 accumulators.
__global__ void __launch_bounds__(kScoreThreads)
mlstm_scores_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 float* __restrict__ scores, int S, int dh) {
  extern __shared__ float4 smem4[];
  const uint32_t base = smem_addr(smem4);   // stage st: q, then k
  const int c = blockIdx.x, bh = blockIdx.y;
  const int t0 = c * kL;
  const int rows = min(kL, S - t0);
  const __nv_bfloat16* qb = q + ((long long)bh * S + t0) * dh;
  const __nv_bfloat16* kb = k + ((long long)bh * S + t0) * dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = (dh + kDB - 1) / kDB;
  float sc[kL / 8][4];
#pragma unroll
  for (int n = 0; n < kL / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
  load_block<kScoreThreads>(base, qb, rows, dh, 0);
  load_block<kScoreThreads>(base + kBlockBytes, kb, rows, dh, 0);
  cp_async_commit();
  for (int i = 0; i < nb; ++i) {
    const uint32_t sq = base + 2 * (i & 1) * kBlockBytes;
    if (i + 1 < nb) {
      const uint32_t nxt = base + 2 * ((i + 1) & 1) * kBlockBytes;
      load_block<kScoreThreads>(nxt, qb, rows, dh, (i + 1) * kDB);
      load_block<kScoreThreads>(nxt + kBlockBytes, kb, rows, dh,
                                (i + 1) * kDB);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const uint32_t sk = sq + kBlockBytes;
#pragma unroll
    for (int kk = 0; kk < kDB / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sq + swz<kDB>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int n = 0; n < kL / 8; n += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, sk + swz<kDB>(n * 8 + (lane & 7) + ((lane >> 4) << 3),
                                  2 * kk + ((lane >> 3) & 1)));
        mma16816(sc[n], a, bb[0], bb[1]);
        mma16816(sc[n + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();                 // the stage is refilled next
  }
  float* out = scores + ((long long)bh * gridDim.x + c) * kL * kL;
  const int r = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < kL / 8; ++n) {
    *reinterpret_cast<float2*>(out + r * kL + n * 8 + col) =
        make_float2(sc[n][0], sc[n][1]);
    *reinterpret_cast<float2*>(out + (r + 8) * kL + n * 8 + col) =
        make_float2(sc[n][2], sc[n][3]);
  }
}

__host__ __device__ constexpr size_t mma_smem_bytes(int dh) {
  // q/k ring, the warp pairs' h^T partials (rows padded to kHS), n, q . n,
  // v tile, w, gates, a v hi and lo (rows padded to kAVS)
  return kStages * (size_t)kBlockBytes + sizeof(float) * (kPairs * kMTV * kHS
         + dh + kL + kL * kMTV + kL * (kL + 1) + kGateFloats)
         + 2 * 2 * kL * kAVS;
}

// One CTA of 16 warps per (column tile e0 of kMTV = 32, head), walking the
// chunks in order.  The tile C^T[e0.., :] (kMTV x dh) lives in mma
// accumulator fragments: warp w holds rows e0 + 16 (w / 8) .. +15 (its
// m-tile) of the 16-column head-dim chunks w % 8, w % 8 + 8, ... (NCW of
// them), a thread 8 fp32 each; the two warps of a pair share their q and
// k fragments.  Per chunk:
//   h_inter^T = C^T q^T: A = C^T from the accumulators (the
//     FlashAttention-2 P trick), split into bf16 hi + lo and multiplied
//     twice; B = q from the streamed block (ldmatrix); each warp sums its
//     part over its head-dim chunks into its pair's slots in shared
//     memory, 16 tokens at a time, and the 8 pairs' parts are added up;
//   C^T = carry C^T + (a o v)^T k: A = (a o v)^T, fp32, split into bf16
//     hi + lo in shared memory (ldmatrix.trans); B = k from the streamed
//     block (ldmatrix.trans);
// and on the CUDA cores, as the fp32 kernel: the gates and weights
// (chunk_gates), w v, q . n and n.  q and k are exact bf16 operands; the
// hi + lo split keeps ~16 bits of the fp32 one.  Each CTA reads every q
// and k block of its head through L2, so the column tile's width sets the
// L2 traffic (dh / kMTV reads of q and k a head).
template <int NCW>
__global__ void __launch_bounds__(kMThreads, 1)
mlstm_chunkwise_mma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ i_pre,
                    const float* __restrict__ f_pre,
                    const float* __restrict__ scores,
                    const float* __restrict__ C0,
                    const float* __restrict__ n0,
                    const float* __restrict__ m0,
                    __nv_bfloat16* __restrict__ h, float* __restrict__ C_out,
                    float* __restrict__ n_out, float* __restrict__ m_out,
                    int S, int dh) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const uint32_t ring = smem_addr(sm);                  // kStages blocks
  float* hred = reinterpret_cast<float*>(sm + kStages * kBlockBytes);
  float* ns = hred + kPairs * kMTV * kHS;  // hred [pair][e][j]; ns: dh
  float* qns = ns + dh;                                 // q . n: kL
  float* vs = qns + kL;                                 // kL x kMTV
  float* ws = vs + kL * kMTV;                           // kL x (kL + 1)
  const Gates G(ws + kL * (kL + 1));
  __nv_bfloat16* avh = reinterpret_cast<__nv_bfloat16*>(
      ws + kL * (kL + 1) + kGateFloats);                // kL x kAVS
  __nv_bfloat16* avl = avh + kL * kAVS;

  const int e0 = blockIdx.x * kMTV;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = warp % kPairs, mt = warp / kPairs;
  const int g4 = lane >> 2, t4 = lane & 3;
  const long long head = (long long)bh * S;
  const int nc = (S + kL - 1) / kL;
  const int nb = (dh + kDB - 1) / kDB;
  const int n16 = dh / 16;           // 16-column head-dim chunks

  float c[NCW][2][4];                // C^T: rows e0 + 16 mt + g4 (+8)
#pragma unroll
  for (int i = 0; i < NCW; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ci = i * kPairs + pair;
        const int e = 16 * mt + g4 + 8 * (r >> 1);
        const int d = ci * 16 + n * 8 + 2 * t4 + (r & 1);
        c[i][n][r] = C0 && ci < n16
                         ? C0[((long long)bh * dh + d) * dh + e0 + e] : 0.f;
      }
  for (int d = tid; d < dh; d += kMThreads)
    ns[d] = n0 ? n0[(long long)bh * dh + d] : 0.f;
  float m_prev = m0 ? m0[bh] : kNeg;

  // One stream of blocks through the ring, kStages - 1 ahead: per chunk
  // its nb q blocks, then its nb k blocks.  take(u) waits for block u,
  // refills the stage block u - 1 used, and returns u's stage.
  const int n_blocks = nc * 2 * nb;
  auto issue = [&](int u) {
    if (u < n_blocks) {
      const int ch = u / (2 * nb), bi = u % (2 * nb);
      load_block<kMThreads>(ring + (u % kStages) * kBlockBytes,
                            (bi < nb ? q : k) + (head + ch * kL) * dh,
                            min(kL, S - ch * kL), dh, (bi % nb) * kDB);
    }
    cp_async_commit();
  };
  auto take = [&](int u) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(u + kStages - 1);
    return u % kStages;
  };
  for (int u = 0; u < kStages - 1; ++u) issue(u);

  for (int ch = 0; ch < nc; ++ch) {
    const int t0 = ch * kL;
    const int Lc = min(kL, S - t0);
    __syncthreads();                 // the last chunk is done with all
    if (tid < kL * 4) {              // the v tile, fp32 (rows >= Lc zero)
      const int row = tid >> 2, part = tid & 3;
      float f[8];
      const uint4 u = row < Lc ? *reinterpret_cast<const uint4*>(
                                     v + (head + t0 + row) * dh + e0
                                     + part * 8)
                               : make_uint4(0u, 0u, 0u, 0u);
      unpack(u, f, __nv_bfloat16());
#pragma unroll
      for (int x = 0; x < 8; ++x) vs[row * kMTV + part * 8 + x] = f[x];
    }
    const float2 mc = chunk_gates(
        G, ws, i_pre, f_pre, scores + ((long long)bh * nc + ch) * kL * kL,
        head, t0, Lc, m_prev);
    const float m_new = mc.x, carry = mc.y;
    __syncthreads();                 // a_s (kvw) and rs
    {  // a_s v_s as bf16 hi + lo: token tid/8, columns 4 (tid%8) .. +3
      const int s = tid >> 3, e = (tid & 7) * 4;
      const float a = G.kvw[s];
      uint32_t hi[2], lo[2];
      split_bf16(a * vs[s * kMTV + e], a * vs[s * kMTV + e + 1], hi[0],
                 lo[0]);
      split_bf16(a * vs[s * kMTV + e + 2], a * vs[s * kMTV + e + 3], hi[1],
                 lo[1]);
      *reinterpret_cast<uint2*>(avh + s * kAVS + e) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(avl + s * kAVS + e) = make_uint2(lo[0], lo[1]);
    }

    // ---- h_inter^T = C^T q^T over the q blocks, summed into the pair's
    // hred slots of this warp's m-tile 16 tokens at a time (8 accumulators
    // live); q . n on the CUDA cores (token tid/8, an eighth of each
    // block's columns)
    float* hmine = hred + (pair * kMTV + 16 * mt + g4) * kHS + 2 * t4;
#pragma unroll
    for (int n = 0; n < kL / 8; ++n) {
      *reinterpret_cast<float2*>(hmine + n * 8) = make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(hmine + 8 * kHS + n * 8) =
          make_float2(0.f, 0.f);
    }
    float qn_part = 0.f;
#pragma unroll
    for (int i = 0; i < NCW; ++i) {
      if (i >= nb) break;
      const int st = take(ch * 2 * nb + i);
      const uint32_t sq = ring + st * kBlockBytes;
      if (i * kPairs + pair < n16) {
        uint32_t ah[4], al[4];
        split_bf16(c[i][0][0], c[i][0][1], ah[0], al[0]);
        split_bf16(c[i][0][2], c[i][0][3], ah[1], al[1]);
        split_bf16(c[i][1][0], c[i][1][1], ah[2], al[2]);
        split_bf16(c[i][1][2], c[i][1][3], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < kL / 8; n += 2) {
          float hh[2][4] = {};
          uint32_t bb[4];
          ldsm_x4(bb, sq + swz<kDB>(n * 8 + (lane & 7) + ((lane >> 4) << 3),
                                    2 * pair + ((lane >> 3) & 1)));
          mma16816(hh[0], ah, bb[0], bb[1]);
          mma16816(hh[0], al, bb[0], bb[1]);
          mma16816(hh[1], ah, bb[2], bb[3]);
          mma16816(hh[1], al, bb[2], bb[3]);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float2* lo = reinterpret_cast<float2*>(hmine + (n + x) * 8);
            float2* hi = reinterpret_cast<float2*>(hmine + 8 * kHS
                                                   + (n + x) * 8);
            const float2 p = *lo, r = *hi;
            *lo = make_float2(p.x + hh[x][0], p.y + hh[x][1]);
            *hi = make_float2(r.x + hh[x][2], r.y + hh[x][3]);
          }
        }
      }
      {
        const int s = tid >> 3;
        const char* row = sm + st * kBlockBytes;
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int chunk = (tid & 7) * 2 + cc;
          const int d = i * kDB + chunk * 8;
          if (d < dh) {
            float f[8];
            unpack(*reinterpret_cast<const uint4*>(row + swz<kDB>(s, chunk)),
                   f, __nv_bfloat16());
            const float4 n0v = *reinterpret_cast<const float4*>(ns + d);
            const float4 n1v = *reinterpret_cast<const float4*>(ns + d + 4);
            qn_part = fmaf(f[0], n0v.x, qn_part);
            qn_part = fmaf(f[1], n0v.y, qn_part);
            qn_part = fmaf(f[2], n0v.z, qn_part);
            qn_part = fmaf(f[3], n0v.w, qn_part);
            qn_part = fmaf(f[4], n1v.x, qn_part);
            qn_part = fmaf(f[5], n1v.y, qn_part);
            qn_part = fmaf(f[6], n1v.z, qn_part);
            qn_part = fmaf(f[7], n1v.w, qn_part);
          }
        }
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      qn_part += __shfl_xor_sync(0xffffffffu, qn_part, o);
    if ((tid & 7) == 0) qns[tid >> 3] = qn_part;
    __syncthreads();

    // ---- intra-chunk term, normaliser, h: token tid%64, columns 4
    // (tid/64) .. +3 (w_js is 0 for s > j and for rows past Lc)
    {
      const int j = tid & (kL - 1), e = (tid / kL) * 4;
      if (j < Lc) {
        float hq[4] = {0.f, 0.f, 0.f, 0.f}, wv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 0; p < kPairs; ++p)
#pragma unroll
          for (int u = 0; u < 4; ++u) hq[u] += hred[(p * kMTV + e + u) * kHS + j];
#pragma unroll 16
        for (int s = 0; s < kL; ++s) {
          const float wj = ws[j * (kL + 1) + s];
          const float4 vv = *reinterpret_cast<const float4*>(vs + s * kMTV + e);
          wv[0] = fmaf(wj, vv.x, wv[0]);
          wv[1] = fmaf(wj, vv.y, wv[1]);
          wv[2] = fmaf(wj, vv.z, wv[2]);
          wv[3] = fmaf(wj, vv.w, wv[3]);
        }
        const float it = G.inter[j];
        const float den = it * qns[j] + G.rs[j];
        const float dn = fmaxf(fabsf(den), expf(-G.mj[j]));
        const uint2 out = make_uint2(
            pack_bf16((it * hq[0] + wv[0]) / dn, (it * hq[1] + wv[1]) / dn),
            pack_bf16((it * hq[2] + wv[2]) / dn, (it * hq[3] + wv[3]) / dn));
        *reinterpret_cast<uint2*>(h + (head + t0 + j) * dh + e0 + e) = out;
      }
    }

    // ---- state update over the k blocks; n on the CUDA cores
#pragma unroll
    for (int i = 0; i < NCW; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) c[i][n][r] *= carry;
    const uint32_t s_avh = smem_addr(avh), s_avl = smem_addr(avl);
#pragma unroll
    for (int i = 0; i < NCW; ++i) {
      if (i >= nb) break;
      const int st = take(ch * 2 * nb + nb + i);
      const uint32_t sk = ring + st * kBlockBytes;
      if (i * kPairs + pair < n16) {
#pragma unroll
        for (int ks = 0; ks < kL / 16; ++ks) {
          // (a o v)^T rows 16 mt + .., tokens 16 ks..: stored [token][e]
          const uint32_t off = ((ks * 16 + (lane & 7) + ((lane >> 4) << 3))
                                * kAVS + 16 * mt + ((lane >> 3) & 1) * 8) * 2;
          uint32_t ah[4], al[4], bb[4];
          ldsm_x4_trans(ah, s_avh + off);
          ldsm_x4_trans(al, s_avl + off);
          ldsm_x4_trans(bb, sk + swz<kDB>(ks * 16 + (lane & 15),
                                          2 * pair + (lane >> 4)));
          mma16816(c[i][0], ah, bb[0], bb[1]);
          mma16816(c[i][0], al, bb[0], bb[1]);
          mma16816(c[i][1], ah, bb[2], bb[3]);
          mma16816(c[i][1], al, bb[2], bb[3]);
        }
      }
      {
        // n: 8-column chunk tid/32 of the block (16-byte reads), tokens
        // 2 (tid % 32) .. +1, summed over the 32 lanes of the warp
        const int chunk = tid >> 5, s0 = (tid & 31) * 2;
        const char* blk = sm + st * kBlockBytes;
        float nk[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float f[8];
          unpack(*reinterpret_cast<const uint4*>(blk + swz<kDB>(s0 + u,
                                                                chunk)),
                 f, __nv_bfloat16());
          const float a = G.kvw[s0 + u];
#pragma unroll
          for (int x = 0; x < 8; ++x) nk[x] = fmaf(a, f[x], nk[x]);
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            nk[x] += __shfl_xor_sync(0xffffffffu, nk[x], o);
        const int d = i * kDB + chunk * 8 + lane;
        if (lane < 8 && d < dh) {
          float mine = nk[0];
#pragma unroll
          for (int x = 1; x < 8; ++x) mine = lane == x ? nk[x] : mine;
          ns[d] = fmaf(carry, ns[d], mine);
        }
      }
    }
    m_prev = m_new;
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < NCW; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ci = i * kPairs + pair;
        const int e = 16 * mt + g4 + 8 * (r >> 1);
        const int d = ci * 16 + n * 8 + 2 * t4 + (r & 1);
        if (ci < n16) C_out[((long long)bh * dh + d) * dh + e0 + e] = c[i][n][r];
      }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int d = tid; d < dh; d += kMThreads) n_out[(long long)bh * dh + d] = ns[d];
    if (tid == 0) m_out[bh] = m_prev;
  }
}

// fp32: the CUDA-core kernels
int launch_fp32(const void* q, const void* k, const void* v,
                const float* i_pre, const float* f_pre, float* scores,
                const float* C0, const float* n0, const float* m0, void* h,
                float* C, float* n, float* m, int BH, int S, int dh,
                cudaStream_t stream) {
  const int nc = (S + kL - 1) / kL;
  mlstm_scores_kernel<float><<<dim3(nc, BH), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), scores, S,
      dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(dh) * sizeof(float);
  err = cudaFuncSetAttribute(mlstm_chunkwise_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_chunkwise_kernel<float><<<dim3(dh / kTV, BH), kThreads, smem,
                                  stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), i_pre, f_pre, scores, C0, n0, m0,
      static_cast<float*>(h), C, n, m, S, dh);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core kernels; NCW covers dh
template <int NCW>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const float* i_pre,
               const float* f_pre, float* scores, const float* C0,
               const float* n0, const float* m0, __nv_bfloat16* h, float* C,
               float* n, float* m, int BH, int S, int dh,
               cudaStream_t stream) {
  const int nc = (S + kL - 1) / kL;
  const int score_smem = 4 * kBlockBytes;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scores_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      score_smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_scores_mma<<<dim3(nc, BH), kScoreThreads, score_smem, stream>>>(
      q, k, scores, S, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = mma_smem_bytes(dh);
  err = cudaFuncSetAttribute(mlstm_chunkwise_mma<NCW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_chunkwise_mma<NCW><<<dim3(dh / kMTV, BH), kMThreads, smem,
                             stream>>>(
      q, k, v, i_pre, f_pre, scores, C0, n0, m0, h, C, n, m, S, dh);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v,
                const float* i_pre, const float* f_pre, float* scores,
                const float* C0, const float* n0, const float* m0, void* h,
                float* C, float* n, float* m, int BH, int S, int dh,
                cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const bf* qb = static_cast<const bf*>(q);
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  bf* hb = static_cast<bf*>(h);
  if (dh <= kDB)
    return launch_mma<1>(qb, kb, vb, i_pre, f_pre, scores, C0, n0, m0, hb, C,
                         n, m, BH, S, dh, stream);
  if (dh <= 2 * kDB)
    return launch_mma<2>(qb, kb, vb, i_pre, f_pre, scores, C0, n0, m0, hb, C,
                         n, m, BH, S, dh, stream);
  if (dh <= 4 * kDB)
    return launch_mma<4>(qb, kb, vb, i_pre, f_pre, scores, C0, n0, m0, hb, C,
                         n, m, BH, S, dh, stream);
  return launch_mma<8>(qb, kb, vb, i_pre, f_pre, scores, C0, n0, m0, hb, C, n,
                       m, BH, S, dh, stream);
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
    return launch_fp32(q, k, v, f(i_pre), f(f_pre), w(scores), f(C0), f(n0),
                       f(m0), h, w(C), w(n), w(m), BH, S, dh, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, f(i_pre), f(f_pre), w(scores), f(C0), f(n0),
                       f(m0), h, w(C), w(n), w(m), BH, S, dh, s);
  return (int)cudaErrorInvalidValue;
}
