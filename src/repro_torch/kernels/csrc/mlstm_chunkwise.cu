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
// operands and state.  Both paths keep C of one head, dh x dh fp32 (4 MiB
// at dh 1024, far above a CTA's 227 KB of shared memory), as mma
// accumulator fragments of a column tile C^T[e0:e0+32, :] in each of
// dh/32 column CTAs of 16 warps that walk the chunks in order, so the
// state never leaves registers between chunks; q and k stream through a
// cp.async ring.  Each column CTA reads every q and k block of its head
// through L2, so the tile width sets the L2 traffic (dh / 32 reads of q
// and k a head: 1 GB at the serving fp32 shape).
//
// fp32 (`mlstm_local_f32`, `mlstm_scan_f32`, `mlstm_carry_f32`,
// `mlstm_chunkwise_tf32`): four launches; the two dh x dh products on mma.sync.m16n8k8 as
// 3xTF32 (each fp32 operand split into a TF32 big and small part,
// split_tf32; small·big + big·small + big·big keeps fp32 accuracy, where
// one TF32 product would miss the 2e-4 state tolerance).  What does not
// depend on C or on a value column is done once a head, not in every
// column CTA:
//   1. per (chunk, head, half of the score rows), parallel: the gates
//      (b, g, mi_j, M_loc, u_s), q k^T (fp32 fma chains: see
//      mlstm_local_f32), the local weights w_js and nk = sum_s u_s k_s;
//   2. per head, in chunk order: the m and n carries to each chunk's
//      start (a scalar and a dh-vector step a chunk, linear in the
//      prompt) and the final (n, m);
//   3. per (chunk, head), parallel: q_j . n, the denominators,
//      w' = w / den, ci_j and a_s;
//   4. per (column tile, head): the recurrence of C, with h_inter = q C
//      and the update as 3xTF32 products, and h = ci_j h_inter + w' v,
//      one scale a row.
// The mma adds into its accumulator rounding toward zero, so the update
// of each chunk starts from zero and joins C by one fma (carry C + U),
// and q C is summed 16 head-dim columns at a time into fp32 partials.
// What bounds it (an H100 at S 1024, B 1, H 4, dh 1024: 0.64 ms, of which
// the column kernel 0.58): streaming q and k into every column CTA, 8 MB
// a CTA through a ring with a barrier a block.  With every product and
// the h rows skipped the kernels still took 0.375 ms; the q C
// product adds 0.14 and the update hides behind the stream; dropping two
// of the three products saves 18%, the B splits 2%.  A 3-stage ring took
// 0.650 ms, and a cluster of two column CTAs sharing each block by
// multicast bulk copies (half the L2 reads, the same bytes into each SM)
// 0.843: the bytes each SM takes in, not L2's reads or the load latency,
// set the pace.
// Why 32 value columns and 16 warps: the tile is then 64 fp32 registers
// a thread of C (512 threads may have 128 each; 64 columns would need
// all 128 for C alone), and at the serving shape dh/32 x H = 128 CTAs,
// one an SM, fill 128 of the 132 SMs (16 columns would double the L2
// reads of q and k).  Why a 2-stage ring of 128-column blocks: a stage
// is 34 KB, and the ring, the 8 warp pairs' h partials (72 KB) and the
// chunk's v, w' and split a o v take 183 KB of the 227 KB a CTA may have;
// the block in flight covers the next block's compute.
//
// bf16 (`mlstm_scores_mma`, `mlstm_chunkwise_mma`), on mma.sync.m16n8k16
// with fp32 accumulators, in kDB-column blocks; q, k and v are exact
// bf16 operands; the fp32 operand of each state product (C for q C, a_s
// v_s for the update) is split into bf16 hi + lo and multiplied twice
// into the same fp32 accumulator, which keeps ~16 bits of it: one bf16
// rounding (2^-9 relative a term) would miss the 2e-4 state tolerance.
// The gates, the m trajectory and the weights w are recomputed by every
// column CTA on the CUDA cores (chunk_gates), as are w v, q . n and n.
#include "common.cuh"

namespace {

constexpr int kL = 64;             // chunk length
constexpr float kNeg = -1e30f;     // finite "minus infinity" of m

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
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

// ------------------------------------------------------------ bf16, mma
constexpr int kDB = 128;           // head-dim columns of a streamed block
constexpr uint32_t kBlockBytes = kL * kDB * 2;   // one bf16 q or k block
constexpr int kMTV = 32;           // value columns (of C and h) per CTA
constexpr int kScoreThreads = 128; // 4 warps x 16 query rows
constexpr int kStages = 2;         // the column kernels' q/k block ring
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

// q k^T of every chunk on mma.sync, scores[bh][c][j][s] = q_{t0+j} .
// k_{t0+s} (rows past S are zero): one CTA of 4 warps per (chunk, head),
// warp w the 16 query rows 16w.., q and k streamed in kDB-column blocks
// through a 2-stage cp.async ring.  bf16 products are exact in the fp32
// accumulators.
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
// and on the CUDA cores: the gates and weights (chunk_gates), w v,
// q . n and n.  q and k are exact bf16 operands; the
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

// ------------------------------------------------------------ fp32, 3xTF32
// Per (head, chunk) record of fp32 scratch, floats: w (kL x kL: the local
// weights, then w' = w / denominator), the vectors b, mi, u, ci, a (kL
// each), the scalars g, M_loc, carry and the m before the chunk; after
// every record, per (head, chunk) the dh-vector nk, overwritten by the n
// before the chunk.
constexpr int kRb = kL * kL;       // b_j, cumulative log f
constexpr int kRmi = kRb + kL;     // mi_j = max_{s<=j} (b_j - b_s + i_s)
constexpr int kRu = kRmi + kL;     // u_s = e^{g - b_s + i_s - M_loc}
constexpr int kRci = kRu + kL;     // ci_j = e^{b_j + m_prev - m_j} / den_j
constexpr int kRa = kRci + kL;     // a_s = e^{g - b_s + i_s - m'}
constexpr int kRg = kRa + kL;      // g, M_loc = max_s (g - b_s + i_s), carry,
                                   // m before the chunk
constexpr int kRec = kRg + 4;
constexpr int kLT = 256;           // threads of the three pre-pass kernels
constexpr int kLR = kL / 2;        // score rows of a mlstm_local_f32 CTA
constexpr int kLDB = 64;           // head-dim columns of a pre-pass block
constexpr int kLLD = kLDB + 4;     // its padded rows (16-byte loads, no
                                   // bank conflicts)
constexpr int kFDB = 128;          // head-dim columns of a column-kernel block
constexpr int kFTV = 32;           // value columns (of C and h) per column CTA
constexpr int kFThreads = 512;     // 16 warps: 8 pairs x 2 m-tiles
constexpr int kLQ = kFDB + 8;      // padded row of a q block (64-bit loads)
constexpr int kLK = kFDB + 4;      // padded row of a k block (32-bit loads)
constexpr int kAV = kFTV + 4;      // padded row of a o v big / small
constexpr int kFBlock = kL * kLQ;  // floats of a ring stage

// The chunk's local quantities, two CTAs of 8 warps per (chunk c, head),
// fully parallel: the gates as the plain loop computes them (b, g, mi_j,
// M_loc, u_s; written by the first), and CTA z's half of the rest: score
// rows j in [32z, 32z + 32) of q k^T and their local weights w_js =
// (q_j . k_s) e^{b_j - b_s + i_s - mi_j} (s <= j < Lc, else 0), and nk =
// sum_s u_s k_s over the head-dim blocks i = z mod 2.  The chunk's k and
// the CTA's q rows stream in kLDB-column blocks through a 2-stage
// cp.async ring.  The scores are fp32 fma chains on the CUDA cores, each
// one over the whole head dim in order (thread: rows 32z + tid/16 + 16i,
// keys tid%16 + 16j), not 3xTF32 and not split over the head dim: a
// denominator that cancels far below its terms amplifies the scores'
// error, and 3xTF32 (operands kept to 2^-21 of their value, not fp32's
// 2^-24) or a chain cut into partial sums put h past 2e-4 of the plain
// version at S = 128 with large input gates (measured on the card).
// They are 1/16 of the flops of q C and the update.  nk: thread (column
// d, quarter p) sums tokens 16p .. 16p + 15 of a block into red[p][d],
// added in a fixed order at the end (no atomics: the result is the same
// run to run).
__global__ void __launch_bounds__(kLT, 2)
mlstm_local_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ i_pre,
                const float* __restrict__ f_pre, float* __restrict__ recs,
                float* __restrict__ nks, int S, int dh) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // stage: q rows, k block
  float* red = ring + 2 * (kLR + kL) * kLLD;      // [4][dh]
  float* lf = red + 4 * dh;                        // the gate vectors
  float* ii = lf + kL;
  float* bb = ii + kL;
  float* mi = bb + kL;
  float* sg = mi + kL;
  float* us = sg + kL;
  float* mloc = us + kL;
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int z = blockIdx.z;
  const int t0 = c * kL;
  const int Lc = min(kL, S - t0);
  const long long head = (long long)bh * S;
  const float* qg = q + (head + t0 + kLR * z) * dh;
  const float* kg = k + (head + t0) * dh;
  const long long chunk = (long long)bh * nc + c;
  float* rec = recs + chunk * kRec;
  const int tid = threadIdx.x;
  const int nb = dh / kLDB;

  auto issue = [&](int i) {          // block i: q rows, then k; rows >= Lc
    float* dst = ring + (i & 1) * (kLR + kL) * kLLD;   // are zero
    constexpr int kChunks = kLDB / 4;
#pragma unroll
    for (int it = 0; it < (kLR + kL) * kChunks / kLT; ++it) {
      const int x = tid + it * kLT;
      const int r = x / kChunks, cc = x % kChunks;
      const bool is_q = r < kLR;
      const int row = is_q ? r + kLR * z : r - kLR;
      const bool ok = row < Lc;
      const long long off = ok ? (long long)(is_q ? r : row) * dh + i * kLDB
                                 + cc * 4 : 0;
      cp_async16(smem_addr(dst + r * kLLD + cc * 4), (is_q ? qg : kg) + off,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };
  issue(0);

  // ---- gates, in the plain loop's order (threads < kL: token tid)
  if (tid < kL) {
    const bool in = tid < Lc;
    lf[tid] = in ? log_sigmoid(f_pre[head + t0 + tid]) : 0.f;
    ii[tid] = in ? i_pre[head + t0 + tid] : 0.f;
  }
  __syncthreads();
  // inclusive cumsum, in order, in fp64: one rounding, as the plain
  // loop's torch.cumsum on the CPU (m and g are sums of up to 64 log f)
  if (tid < kL) {
    double s = 0.0;
#pragma unroll
    for (int u = 0; u < kL; ++u)
      if (u <= tid) s += lf[u];
    bb[tid] = (float)s;
  }
  __syncthreads();
  const float gl = bb[Lc - 1];       // b at the last VALID token
  if (tid < kL) {
    const int j = tid;
    if (j < Lc) {
      const float bj = bb[j];
      float mx = kNeg;
#pragma unroll
      for (int s = 0; s < kL; ++s)
        if (s <= j) mx = fmaxf(mx, bj - bb[s] + ii[s]);
      mi[j] = mx;
      sg[j] = gl - bj + ii[j];
    } else {
      mi[j] = 0.f;
      sg[j] = kNeg;
    }
  }
  __syncthreads();
  if (tid < 32) {
    const float mx = warp_max(fmaxf(sg[tid], sg[tid + 32]));
    if (tid == 0) mloc[0] = mx;
  }
  __syncthreads();
  if (tid < kL) {
    const float u = tid < Lc ? expf(sg[tid] - mloc[0]) : 0.f;
    us[tid] = u;
    if (z == 0) {
      rec[kRb + tid] = bb[tid];
      rec[kRmi + tid] = mi[tid];
      rec[kRu + tid] = u;
    }
  }
  if (tid == 0 && z == 0) {
    rec[kRg] = gl;
    rec[kRg + 1] = mloc[0];
  }

  // ---- scores (this CTA's rows) and nk (blocks z, z + 2, ...)
  const int tr = tid / 16, tc = tid % 16;
  float sc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
  for (int i = 0; i < nb; ++i) {
    if (i + 1 < nb)
      issue(i + 1);
    else
      cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const float* qs = ring + (i & 1) * (kLR + kL) * kLLD;
    const float* ks = qs + kLR * kLLD;
#pragma unroll 4
    for (int d = 0; d < kLDB; d += 4) {
      float4 a[2], b[4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        a[u] = *reinterpret_cast<const float4*>(qs + (tr + 16 * u) * kLLD + d);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        b[u] = *reinterpret_cast<const float4*>(ks + (tc + 16 * u) * kLLD + d);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2) {
          float x = sc[r][c2];
          x = fmaf(a[r].x, b[c2].x, x);
          x = fmaf(a[r].y, b[c2].y, x);
          x = fmaf(a[r].z, b[c2].z, x);
          sc[r][c2] = fmaf(a[r].w, b[c2].w, x);
        }
    }
    if ((i & 1) == z) {  // nk: column tid % kLDB, tokens 16 (tid / kLDB) ..
      const int d = tid & (kLDB - 1), p = tid / kLDB;
      float x = 0.f;
#pragma unroll
      for (int s = 0; s < 16; ++s)
        x = fmaf(us[16 * p + s], ks[(16 * p + s) * kLLD + d], x);
      red[p * dh + i * kLDB + d] = x;
    }
    __syncthreads();                 // the stage is refilled next
  }

  // ---- the local weights of the CTA's rows, and nk of its blocks
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c2 = 0; c2 < 4; ++c2) {
      const int j = kLR * z + tr + 16 * r, s = tc + 16 * c2;
      rec[j * kL + s] =
          s <= j && j < Lc
              ? sc[r][c2] * expf(bb[j] - bb[s] + ii[s] - mi[j]) : 0.f;
    }
  for (int d = tid; d < dh; d += kLT)
    if (((d / kLDB) & 1) == z)
      nks[chunk * dh + d] =
          ((red[d] + red[dh + d]) + red[2 * dh + d]) + red[3 * dh + d];
}

__host__ __device__ constexpr size_t local_smem_bytes(int dh) {
  return 4 * ((size_t)2 * (kLR + kL) * kLLD + 4 * (size_t)dh + 6 * kL + 4);
}

// The m and n carries, one CTA per head walking the chunks in order: from
// chunk c's record and nk, m' = max(g + m, M_loc) and n' = e^{g + m - m'} n
// + e^{M_loc - m'} nk (a thread holds dh / kLT entries of n, the next
// chunk's nk loaded ahead); writes the m before each chunk into its record
// and the n before it over its nk, then the final n and m.
__global__ void __launch_bounds__(kLT)
mlstm_scan_f32(float* __restrict__ recs, float* __restrict__ nks,
               const float* __restrict__ n0, const float* __restrict__ m0,
               float* __restrict__ n_out, float* __restrict__ m_out, int nc,
               int dh) {
  constexpr int kPer = 1024 / kLT;               // n entries a thread holds
  const int bh = blockIdx.x, tid = threadIdx.x;
  float* head_recs = recs + (long long)bh * nc * kRec;
  float* head_nks = nks + (long long)bh * nc * dh;
  float n[kPer], nk[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int d = tid + u * kLT;
    n[u] = n0 && d < dh ? n0[(long long)bh * dh + d] : 0.f;
    nk[u] = d < dh ? head_nks[d] : 0.f;
  }
  float m = m0 ? m0[bh] : kNeg;
  float gp = head_recs[kRg], mp = head_recs[kRg + 1];
  for (int c = 0; c < nc; ++c) {
    float* nkc = head_nks + (long long)c * dh;
    float* rec = head_recs + (long long)c * kRec;
    const bool more = c + 1 < nc;
    float nk_next[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int d = tid + u * kLT;
      nk_next[u] = more && d < dh ? nkc[dh + d] : 0.f;
    }
    const float g_next = more ? rec[kRec + kRg] : 0.f;
    const float m_next = more ? rec[kRec + kRg + 1] : 0.f;
    const float mn = fmaxf(gp + m, mp);
    const float carry = expf(gp + m - mn), ak = expf(mp - mn);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int d = tid + u * kLT;
      if (d < dh) nkc[d] = n[u];
      n[u] = fmaf(carry, n[u], ak * nk[u]);
      nk[u] = nk_next[u];
    }
    if (tid == 0) rec[kRg + 3] = m;
    m = mn;
    gp = g_next;
    mp = m_next;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int d = tid + u * kLT;
    if (d < dh) n_out[(long long)bh * dh + d] = n[u];
  }
  if (tid == 0) m_out[bh] = m;
}

// The rest of each chunk, one CTA of 8 warps per (chunk c, head), fully
// parallel, from the carries m and n before the chunk (mlstm_scan_f32), a
// warp a row j:
//   q_j . n, m_j = max(b_j + m, mi_j),
//   den_j = e^{b_j + m - m_j} q_j . n + e^{mi_j - m_j} sum_s w_js,
//   dn_j = max(|den_j|, e^{-m_j}), w'_js = w_js e^{mi_j - m_j} / dn_j,
//   ci_j = e^{b_j + m - m_j} / dn_j;
// and a_s = u_s e^{M_loc - m'}, carry = e^{g + m - m'}.
__global__ void __launch_bounds__(kLT)
mlstm_carry_f32(const float* __restrict__ q, float* __restrict__ recs,
                const float* __restrict__ nks, int S, int dh) {
  extern __shared__ float4 smem4[];
  float* ns = reinterpret_cast<float*>(smem4);   // n before the chunk: dh
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int t0 = c * kL;
  const int Lc = min(kL, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long chunk = (long long)bh * nc + c;
  float* rec = recs + chunk * kRec;
  const float m = rec[kRg + 3];
  for (int d = tid; d < dh; d += kLT) ns[d] = nks[chunk * dh + d];
  __syncthreads();

  const float* qg = q + ((long long)bh * S + t0) * dh;
  for (int j = warp; j < kL; j += kLT / 32) {
    float qn = 0.f;
    if (j < Lc) {                    // warp-uniform
#pragma unroll
      for (int u = 0; u < 1024 / 128; ++u) {   // loads in flight together
        const int d = lane * 4 + 128 * u;
        if (d < dh) {
          const float4 a = *reinterpret_cast<const float4*>(
              qg + (long long)j * dh + d);
          const float4 b = *reinterpret_cast<const float4*>(ns + d);
          qn = fmaf(a.x, b.x, qn);
          qn = fmaf(a.y, b.y, qn);
          qn = fmaf(a.z, b.z, qn);
          qn = fmaf(a.w, b.w, qn);
        }
      }
      qn = warp_sum(qn);
    }
    float* wr = rec + j * kL;
    const float w0 = wr[lane], w1 = wr[lane + 32];
    const float rsl = warp_sum(w0 + w1);
    const float bj = rec[kRb + j], mij = rec[kRmi + j];
    const bool in = j < Lc;
    const float mj = fmaxf(bj + m, mij);
    const float inter = expf(bj + m - mj), scale = expf(mij - mj);
    const float den = fmaf(inter, qn, scale * rsl);
    const float dn = fmaxf(fabsf(den), expf(-mj));
    const float ws = in ? scale / dn : 0.f;
    wr[lane] = w0 * ws;
    wr[lane + 32] = w1 * ws;
    if (lane == 0) rec[kRci + j] = in ? inter / dn : 0.f;
  }

  const float gl = rec[kRg], ml = rec[kRg + 1];
  const float mn = fmaxf(gl + m, ml);
  const float carry = expf(gl + m - mn), ak = expf(ml - mn);
  if (tid < kL) rec[kRa + tid] = tid < Lc ? rec[kRu + tid] * ak : 0.f;
  if (tid == 0) rec[kRg + 2] = carry;
}

__host__ __device__ constexpr size_t tf32_smem_bytes() {
  // q/k ring, the warp pairs' h^T partials (rows padded to kHS), v tile,
  // w', a o v big and small (rows padded to kAV), ci
  return 4 * ((size_t)kStages * kFBlock + kPairs * kFTV * kHS + kL * kFTV
              + kL * (kL + 1) + 2 * kL * kAV + kL);
}

// One CTA of 16 warps per (column tile e0 of kFTV = 32, head), walking the
// chunks in order with the tile C^T[e0.., :] in mma accumulator fragments
// as mlstm_chunkwise_mma (warp w: rows e0 + 16 (w / 8) .., 16-column
// head-dim chunks w % 8, w % 8 + 8, ...), every product 3xTF32 on
// m16n8k8 (k permuted: a thread's k columns are 2t and 2t + 1).  Per
// chunk, from the chunk's record:
//   h_inter^T = C^T q^T: A = C^T from the accumulators, split; B = q from
//     the streamed block (one 64-bit load a fragment), split; per 8-token
//     tile the two k-steps of the warp's chunk from zero, added into its
//     pair's slots of hred;
//   h_j = ci_j sum_pairs h_inter^T + sum_s w'_js v_s (CUDA cores);
//   C^T = carry C^T + U, U = (a o v)^T k from zero (big·big and the small
//     terms in two accumulators) over the chunk's 64 tokens: A = a o v,
//     split once into shared big and small tiles; B = k from the streamed
//     block (two 32-bit loads), split.
template <int NCW>
__global__ void __launch_bounds__(kFThreads, 1)
mlstm_chunkwise_tf32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ recs,
                     const float* __restrict__ C0, float* __restrict__ h,
                     float* __restrict__ C_out, int S, int dh) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // kStages blocks
  float* hred = ring + kStages * kFBlock;          // [pair][e][j]
  float* vs = hred + kPairs * kFTV * kHS;          // kL x kFTV
  float* ws = vs + kL * kFTV;                      // kL x (kL + 1)
  float* avb = ws + kL * (kL + 1);                 // kL x kAV
  float* avs = avb + kL * kAV;                     // kL x kAV
  float* cis = avs + kL * kAV;                     // kL

  const int e0 = blockIdx.x * kFTV;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = warp % kPairs, mt = warp / kPairs;
  const int g = lane >> 2, t = lane & 3;
  const long long head = (long long)bh * S;
  const int nc = (S + kL - 1) / kL;
  const int nb = (dh + kFDB - 1) / kFDB;
  const int n16 = dh / 16;           // 16-column head-dim chunks
  const float* head_recs = recs + (long long)bh * nc * kRec;

  float c[NCW][2][4];                // C^T: rows e0 + 16 mt + g (+8)
#pragma unroll
  for (int i = 0; i < NCW; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ci = i * kPairs + pair;
        const int e = 16 * mt + g + 8 * (r >> 1);
        const int d = ci * 16 + n * 8 + 2 * t + (r & 1);
        c[i][n][r] = C0 && ci < n16
                         ? C0[((long long)bh * dh + d) * dh + e0 + e] : 0.f;
      }

  // One stream of blocks through the ring, kStages - 1 ahead: per chunk
  // its nb q blocks (rows of kLQ), then its nb k blocks (rows of kLK).
  // take(u) waits for block u, refills the stage block u - 1 used, and
  // returns u's stage.
  const int n_blocks = nc * 2 * nb;
  auto issue = [&](int u) {
    if (u < n_blocks) {
      const int ch = u / (2 * nb), bi = u % (2 * nb);
      const int ld = bi < nb ? kLQ : kLK;
      const float* src = (bi < nb ? q : k) + (head + ch * kL) * dh;
      const int rows = min(kL, S - ch * kL), d0 = (bi % nb) * kFDB;
      float* dst = ring + (u % kStages) * kFBlock;
      constexpr int kChunks = kFDB / 4;
#pragma unroll
      for (int it = 0; it < kL * kChunks / kFThreads; ++it) {
        const int x = tid + it * kFThreads;
        const int r = x / kChunks, cc = x % kChunks;
        const bool ok = r < rows && d0 + cc * 4 < dh;
        cp_async16(smem_addr(dst + r * ld + cc * 4),
                   ok ? src + (long long)r * dh + d0 + cc * 4 : src,
                   ok ? 16 : 0);
      }
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
    const float* rec = head_recs + (long long)ch * kRec;
    __syncthreads();                 // the last chunk is done with all
    {  // the v tile (rows >= Lc zero): token tid/8, columns 4 (tid%8) ..
      const int row = tid >> 3, part = tid & 7;
      *reinterpret_cast<float4*>(vs + row * kFTV + part * 4) =
          row < Lc ? *reinterpret_cast<const float4*>(
                         v + (head + t0 + row) * dh + e0 + part * 4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int x = tid; x < kL * kL; x += kFThreads)
      ws[(x / kL) * (kL + 1) + x % kL] = rec[x];
    if (tid < kL) cis[tid] = rec[kRci + tid];
    const float carry = rec[kRg + 2];
    __syncthreads();
    {  // a_s v_s split: token tid/8, columns 4 (tid%8) .. +3
      const int s = tid >> 3, e = (tid & 7) * 4;
      const float a = rec[kRa + s];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t big, small;
        split_tf32(a * vs[s * kFTV + e + u], big, small);
        avb[s * kAV + e + u] = __uint_as_float(big);
        avs[s * kAV + e + u] = __uint_as_float(small);
      }
    }

    // ---- h_inter^T = C^T q^T over the q blocks, into the pair's hred
    // slots of this warp's m-tile, 8 tokens at a time
    float* hmine = hred + (pair * kFTV + 16 * mt + g) * kHS + 2 * t;
#pragma unroll
    for (int jt = 0; jt < kL / 8; ++jt) {
      *reinterpret_cast<float2*>(hmine + jt * 8) = make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(hmine + 8 * kHS + jt * 8) =
          make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < NCW; ++i) {
      if (i >= nb) break;
      const int st = take(ch * 2 * nb + i);
      const float* qs = ring + st * kFBlock + g * kLQ + pair * 16 + 2 * t;
      if (i * kPairs + pair < n16) {
        // A = C^T of the warp's chunk, k-steps kn = 0, 1: the accumulator
        // (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) is A's (g, k t),
        // (g, k t+4), (g+8, k t), (g+8, k t+4)
        uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
        for (int kn = 0; kn < 2; ++kn) {
          split_tf32(c[i][kn][0], a_big[kn][0], a_small[kn][0]);
          split_tf32(c[i][kn][2], a_big[kn][1], a_small[kn][1]);
          split_tf32(c[i][kn][1], a_big[kn][2], a_small[kn][2]);
          split_tf32(c[i][kn][3], a_big[kn][3], a_small[kn][3]);
        }
#pragma unroll
        for (int jt = 0; jt < kL / 8; ++jt) {
          float hh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kn = 0; kn < 2; ++kn) {
            const float2 y = *reinterpret_cast<const float2*>(
                qs + jt * 8 * kLQ + kn * 8);
            uint32_t b_big0, b_small0, b_big1, b_small1;
            split_tf32(y.x, b_big0, b_small0);
            split_tf32(y.y, b_big1, b_small1);
            mma1688_tf32(hh, a_small[kn], b_big0, b_big1);
            mma1688_tf32(hh, a_big[kn], b_small0, b_small1);
            mma1688_tf32(hh, a_big[kn], b_big0, b_big1);
          }
          float2* lo = reinterpret_cast<float2*>(hmine + jt * 8);
          float2* hi = reinterpret_cast<float2*>(hmine + 8 * kHS + jt * 8);
          const float2 p = *lo, r = *hi;
          *lo = make_float2(p.x + hh[0], p.y + hh[1]);
          *hi = make_float2(r.x + hh[2], r.y + hh[3]);
        }
      }
    }
    __syncthreads();

    // ---- h: token tid%64, columns 4 (tid/64) .. +3 (w' is 0 for s > j
    // and for rows past Lc)
    {
      const int j = tid & (kL - 1), e = (tid / kL) * 4;
      if (j < Lc) {
        float hq[4] = {0.f, 0.f, 0.f, 0.f}, wv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 0; p < kPairs; ++p)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            hq[u] += hred[(p * kFTV + e + u) * kHS + j];
#pragma unroll 16
        for (int s = 0; s < kL; ++s) {
          const float wj = ws[j * (kL + 1) + s];
          const float4 vv = *reinterpret_cast<const float4*>(vs + s * kFTV + e);
          wv[0] = fmaf(wj, vv.x, wv[0]);
          wv[1] = fmaf(wj, vv.y, wv[1]);
          wv[2] = fmaf(wj, vv.z, wv[2]);
          wv[3] = fmaf(wj, vv.w, wv[3]);
        }
        const float ci = cis[j];
        *reinterpret_cast<float4*>(h + (head + t0 + j) * dh + e0 + e) =
            make_float4(fmaf(ci, hq[0], wv[0]), fmaf(ci, hq[1], wv[1]),
                        fmaf(ci, hq[2], wv[2]), fmaf(ci, hq[3], wv[3]));
      }
    }

    // ---- state update over the k blocks: C^T = carry C^T + U
#pragma unroll
    for (int i = 0; i < NCW; ++i) {
      if (i >= nb) break;
      const int st = take(ch * 2 * nb + nb + i);
      const float* ks = ring + st * kFBlock + 2 * t * kLK + pair * 16 + g;
      if (i * kPairs + pair < n16) {
        float u_bb[2][4], u_sm[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) u_bb[nt][r] = u_sm[nt][r] = 0.f;
#pragma unroll
        for (int kq = 0; kq < kL / 8; ++kq) {
          // A = (a o v)^T: rows e (16 mt + g, +8), tokens 8 kq + 2t, +1
          const int off = (kq * 8 + 2 * t) * kAV + 16 * mt + g;
          const uint32_t a_big[4] = {
              __float_as_uint(avb[off]), __float_as_uint(avb[off + 8]),
              __float_as_uint(avb[off + kAV]),
              __float_as_uint(avb[off + kAV + 8])};
          const uint32_t a_small[4] = {
              __float_as_uint(avs[off]), __float_as_uint(avs[off + 8]),
              __float_as_uint(avs[off + kAV]),
              __float_as_uint(avs[off + kAV + 8])};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t b_big0, b_small0, b_big1, b_small1;
            split_tf32(ks[kq * 8 * kLK + nt * 8], b_big0, b_small0);
            split_tf32(ks[(kq * 8 + 1) * kLK + nt * 8], b_big1, b_small1);
            mma1688_tf32(u_sm[nt], a_small, b_big0, b_big1);
            mma1688_tf32(u_sm[nt], a_big, b_small0, b_small1);
            mma1688_tf32(u_bb[nt], a_big, b_big0, b_big1);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            c[i][nt][r] = fmaf(carry, c[i][nt][r], u_bb[nt][r] + u_sm[nt][r]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < NCW; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ci = i * kPairs + pair;
        const int e = 16 * mt + g + 8 * (r >> 1);
        const int d = ci * 16 + n * 8 + 2 * t + (r & 1);
        if (ci < n16)
          C_out[((long long)bh * dh + d) * dh + e0 + e] = c[i][n][r];
      }
}

// fp32: the four kernels; NCW covers dh.  scratch: BH · nc records of
// kRec floats, then BH · nc · dh floats of nk.
template <int NCW>
int launch_tf32(const float* q, const float* k, const float* v,
                const float* i_pre, const float* f_pre, float* scratch,
                const float* C0, const float* n0, const float* m0, float* h,
                float* C, float* n, float* m, int BH, int S, int dh,
                cudaStream_t stream) {
  const int nc = (S + kL - 1) / kL;
  float* nk = scratch + (size_t)BH * nc * kRec;
  const size_t local = local_smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_local_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)local);
  if (err != cudaSuccess) return (int)err;
  mlstm_local_f32<<<dim3(nc, BH, kL / kLR), kLT, local, stream>>>(
      q, k, i_pre, f_pre, scratch, nk, S, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_scan_f32<<<BH, kLT, 0, stream>>>(scratch, nk, n0, m0, n, m, nc, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_carry_f32<<<dim3(nc, BH), kLT, sizeof(float) * dh, stream>>>(
      q, scratch, nk, S, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = tf32_smem_bytes();
  err = cudaFuncSetAttribute(mlstm_chunkwise_tf32<NCW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_chunkwise_tf32<NCW><<<dim3(dh / kFTV, BH), kFThreads, smem,
                              stream>>>(q, k, v, scratch, C0, h, C, S, dh);
  return (int)cudaGetLastError();
}

int launch_fp32(const void* q, const void* k, const void* v,
                const float* i_pre, const float* f_pre, float* scratch,
                const float* C0, const float* n0, const float* m0, void* h,
                float* C, float* n, float* m, int BH, int S, int dh,
                cudaStream_t stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* hf = static_cast<float*>(h);
  if (dh <= kFDB)
    return launch_tf32<1>(qf, kf, vf, i_pre, f_pre, scratch, C0, n0, m0, hf,
                          C, n, m, BH, S, dh, stream);
  if (dh <= 2 * kFDB)
    return launch_tf32<2>(qf, kf, vf, i_pre, f_pre, scratch, C0, n0, m0, hf,
                          C, n, m, BH, S, dh, stream);
  if (dh <= 4 * kFDB)
    return launch_tf32<4>(qf, kf, vf, i_pre, f_pre, scratch, C0, n0, m0, hf,
                          C, n, m, BH, S, dh, stream);
  return launch_tf32<8>(qf, kf, vf, i_pre, f_pre, scratch, C0, n0, m0, hf, C,
                        n, m, BH, S, dh, stream);
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
// the kernel's chunk length; the wrapper sizes `scores` from it: fp32
// scratch of BH · nc · chunk² floats in bf16 and BH · nc · (chunk² +
// 5 chunk + 4 + dh) in fp32 (nc = ceil(S / chunk)).  dh a multiple of 64
// up to 1024.  C0, n0, m0 may be null together: a fresh state (zeros, m =
// -1e30).  The outputs must not alias the inputs.  Returns the
// cudaError_t of the launches (0 = launched).
extern "C" int mlstm_chunkwise_launch(
    const void* q, const void* k, const void* v, const void* i_pre,
    const void* f_pre, void* scores, const void* C0, const void* n0,
    const void* m0, void* h, void* C, void* n, void* m, int BH, int S,
    int dh, int chunk, int dtype, void* stream) {
  if (chunk != kL || BH <= 0 || S <= 0 || dh <= 0 || dh % 64 != 0 ||
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
