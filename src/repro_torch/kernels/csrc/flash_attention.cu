// Causal / sliding-window GQA flash attention for Hopper (sm_90a): the
// prefill attention of every layer.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, body `_kernel`).  Layouts are the JAX package's:
//   q (B,H,S,dh); k/v (B,KVH,S,dh); out (B,H,S,dh); H % KVH == 0; dh a
//   multiple of 8, at most 256.
// Unlike the TPU kernel, S need not be a multiple of the tile: the ragged
// tail is masked, since prefill runs prompts of any length.
//
// What bounds it on the H100: operations.  Causal attention does about
// 2·S²·dh flops per head against 4·S·dh elements moved, so past a few
// hundred tokens the work is far above the ridge point, and only the
// tensor cores come near the bound.
//
// Two kernels, chosen by the storage type (a fixed dispatch, not a
// fallback: a call that cannot launch returns its error).  Both have the
// FlashAttention-2 structure: one CTA per (query tile, b, h), warps of 16
// query rows each; the Q tile and a 2-stage ring of K and V tiles in
// shared memory, loaded by 16-byte cp.async (tile k+1 in flight while
// tile k is used); the online softmax in fp32 registers with
// scale·log2(e) folded into exp2f (the scores are never rounded; q is not
// pre-scaled).  Head dims are compile-time buckets 64, 128 and 256; any
// other dh (a multiple of 8) is zero-padded in shared memory to the next
// bucket and the padded output columns are not written.
//
// bf16: `flash_mma_kernel` on mma.sync.m16n8k16 (bf16 in, fp32
// accumulators), 4 warps a 64-row query tile.  Rows XOR-swizzled in
// 16-byte chunks, so that ldmatrix reads are free of bank conflicts.
// S = Q·Kᵀ takes A (Q, re-read by ldmatrix every k-step rather than held
// in registers) and B (K) by ldmatrix; P is rounded to bf16 in registers
// and is directly the A operand of O += P·V, V coming in by
// ldmatrix.trans.  Shared memory, Q + 2 × (K + V): 80 KB at 128 (two CTAs
// per SM), 96 KB at 256 (two: 32-key tiles halve the ring and the score
// registers; 64-key tiles there take 160 KB, one 4-warp CTA per SM, and
// spill registers).
//
// fp32: `flash_tf32x3_kernel` on mma.sync.m16n8k8 with tf32 operands and
// fp32 accumulators.  One TF32 product keeps 11 significant bits (about
// 3 decimal digits) and misses the fp32 tolerance (2e-5) many times, so
// every product is error-compensated ("3xTF32", as CUTLASS's
// OpMultiplyAddFastF32): each fp32 operand x is split as it is loaded
// into big = x rounded to tf32 and small = x − big (split_tf32), and a·b
// is taken as small·big + big·small + big·big; the dropped small·small
// term is near 2⁻²² of the product, so the result keeps fp32 accuracy at
// a third of the 495 TFLOP/s TF32 rate (~165 TFLOP/s, 2.5× the 67 of the
// CUDA cores).  What bounds it instead is issue: the split takes three
// ALU operations an operand element, and each warp splits every K and V
// fragment it reads (the four warps of a CTA read the same ones).  Where
// its fp32 result is made:
// - the mma adds into its accumulator rounding toward zero, so a long
//   sum in one accumulator drifts: the score's big·big, small·big and
//   big·small go to three accumulators, summed once a tile (this also
//   keeps three mma chains in flight a score tile), and each tile's P·V
//   starts from zero and joins O by one fma, O·corr + P·V;
// - P is split like any other operand.
// Operands come from shared memory by 32- and 64-bit loads (ldmatrix moves
// 16-bit elements and cannot transpose fp32): the k index of each 8-deep
// step is permuted so that a thread's two k columns are adjacent, 2t and
// 2t+1 rather than t and t+4.  Q's and K's fragments are then one 64-bit
// load a row, and the score accumulator of an 8-key tile, (g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1), is already the A fragment of that
// tile's P·V step, with no shuffle; V's B fragment is two 32-bit loads,
// rows 2t and 2t+1.  Rows are padded, not swizzled, against bank conflicts
// (ld_qk, ld_v), which leaves every fragment offset a per-thread base plus
// a constant.  fp32 tiles are twice bf16's, so the key tiles are shorter:
// 32 keys and 4 warps (64 query rows) at dh 64 and 128, Q + 2 × (K + V)
// 53 and 101 KB (two CTAs per SM); at dh 256 16 keys and 8 warps (128
// query rows), 197.5 KB, one CTA of 8 warps per SM (4 warps there leave the
// SM's 4 schedulers one warp each and wait on latency).
//
// Both: the KV range of each query tile is bounded to the blocks its
// causal/window mask can reach (first_blk..last_blk, as the TPU kernel
// bounds its grid); the mask is applied only on the tiles that cross the
// diagonal, the window edge or the ragged tail, where masked scores
// become the sentinel and then exactly 0; query tiles are issued
// longest-first across every (b, h) (the query tile is the slow grid
// dimension, so no head's longest tile waits for another head's short
// ones); a row that no key reaches gets l floored at 1e-30.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kMaxDh = 256;
constexpr float kNegInf = -1e30f;
constexpr int kMmaThreads = 128;    // 4 warps, 16 query rows each

// ------------------------------------------------------------ bf16, mma
// Rows [row0, row0 + ROWS) of a (S, dh) bf16 matrix into a swizzled tile
// of ROWS rows of DH, by cp.async; rows past S and columns past dh are
// zeros.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int S, int dh) {
  constexpr int kChunks = DH / 8;
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kMmaThreads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < S && c * 8 < dh;
    const __nv_bfloat16* g = ok ? src + (long long)(row0 + r) * dh + c * 8
                                : src;
    cp_async16(dst + swz<DH>(r, c), g, ok ? 16 : 0);
  }
}

// DH: the head-dim bucket (64, 128 or 256), dh <= DH the real one; BK:
// keys per K/V tile; MINB: CTAs per SM the registers must allow.
// Thread (warp w, lane) holds, of each 16×8 accumulator tile, rows
// r_lo = 16w + lane/4 and r_lo + 8, columns 2·(lane%4) and +1.
template <int DH, int BK, int MINB>
__global__ void __launch_bounds__(kMmaThreads, MINB)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int H, int KVH, int S,
                 int dh, int causal, int window, float scale_log2) {
  constexpr uint32_t kQBytes = kBQ * DH * 2;
  constexpr uint32_t kTileBytes = BK * DH * 2;   // one K or V tile
  constexpr int kNT = BK / 8;      // 8-key column tiles of the scores
  constexpr int kDT = DH / 8;      // 8-column tiles of the output
  // grid (B·H, nq): the CTAs of one query tile index start together for
  // every (b, h), longest tiles first
  const int nq = gridDim.y;
  const int qb = nq - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Q tile, then the ring: stage st holds K, then V
  extern __shared__ float4 smem4[];
  const uint32_t s_q = smem_addr(smem4);

  const __nv_bfloat16* qg = q + ((long long)b * H + h) * S * dh;
  const __nv_bfloat16* kg = k + ((long long)b * KVH + kvh) * S * dh;
  const __nv_bfloat16* vg = v + ((long long)b * KVH + kvh) * S * dh;
  const int q0 = qb * kBQ;
  const int q_last = (q0 + kBQ - 1 < S - 1) ? q0 + kBQ - 1 : S - 1;
  const int n_kb = (S + BK - 1) / BK;
  const int last_blk = causal ? q_last / BK : n_kb - 1;
  int first_blk = 0;
  if (window > 0 && q0 - window + 1 > 0) first_blk = (q0 - window + 1) / BK;

  load_tile<DH, kBQ>(s_q, qg, q0, S, dh);
  load_tile<DH, BK>(s_q + kQBytes, kg, first_blk * BK, S, dh);
  load_tile<DH, BK>(s_q + kQBytes + kTileBytes, vg, first_blk * BK, S, dh);
  cp_async_commit();

  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int r_lo = q0 + warp * 16 + (lane >> 2);
  const int c_lo = 2 * (lane & 3);

  for (int kb = first_blk; kb <= last_blk; ++kb) {
    const int st = (kb - first_blk) & 1;
    if (kb < last_blk) {                       // next tile in flight
      const uint32_t nxt = s_q + kQBytes + 2 * (st ^ 1) * kTileBytes;
      load_tile<DH, BK>(nxt, kg, (kb + 1) * BK, S, dh);
      load_tile<DH, BK>(nxt + kTileBytes, vg, (kb + 1) * BK, S, dh);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const uint32_t s_k = s_q + kQBytes + 2 * st * kTileBytes;
    const uint32_t s_v = s_k + kTileBytes;

    // S = Q·Kᵀ for this warp's 16 rows × BK keys
    float sc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, s_q + swz<DH>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, s_k + swz<DH>(n * 8 + (lane & 7) + ((lane >> 4) << 3),
                                  2 * kk + ((lane >> 3) & 1)));
        mma16816(sc[n], a, bb[0], bb[1]);
        mma16816(sc[n + 1], a, bb[2], bb[3]);
      }
    }

    // mask only the tiles that cross the diagonal, the window edge or the
    // ragged tail; masked scores become the sentinel and then exactly 0
    const int k0 = kb * BK;
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0)
                      || (window > 0 && q_last - k0 >= window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = r_lo + (e >> 1) * 8;
          const int kp = k0 + n * 8 + c_lo + (e & 1);
          bool ok = kp < S;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && qp - kp < window;
          if (!ok) sc[n][e] = kNegInf;
        }
    }

    // online softmax in fp32: rows r_lo (i = 0) and r_lo + 8 (i = 1),
    // reduced over the quad of lanes that share them
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    float corr[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f((m[i] - mx[i]) * scale_log2);
      m[i] = mx[i];
      mc[i] = mx[i] * scale_log2;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(sc[n][e], scale_log2, -mc[e >> 1]));
        if (edge && sc[n][e] == kNegInf) p = 0.f;
        sc[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P·V: P rounded to bf16 in registers is the A fragment of each
    // 16-key step
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kDT; j += 2) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, s_v + swz<DH>(kk * 16 + (lane & 15),
                                        j + (lane >> 4)));
        mma16816(o[j], pa, bb[0], bb[1]);
        mma16816(o[j + 1], pa, bb[2], bb[3]);
      }
    }
    __syncthreads();                 // stage st is refilled next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  __nv_bfloat16* og = out + ((long long)b * H + h) * S * dh;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int c = j * 8 + c_lo;
    if (c >= dh) continue;                     // padded columns
    if (r_lo < S)
      *reinterpret_cast<uint32_t*>(og + (long long)r_lo * dh + c) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (r_lo + 8 < S)
      *reinterpret_cast<uint32_t*>(og + (long long)(r_lo + 8) * dh + c) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

template <int DH, int BK, int MINB>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int H, int KVH, int S, int dh, int causal, int window,
               float scale, cudaStream_t stream) {
  const int smem = (kBQ + 4 * BK) * DH * 2;     // Q + 2 × (K + V)
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DH, BK, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_mma_kernel<DH, BK, MINB><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      H, KVH, S, dh, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// bf16: the head-dim bucket at or above dh
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int H, int KVH, int S, int dh, int causal, int window,
                float scale, cudaStream_t stream) {
  if (dh % 8 || dh > kMaxDh) return (int)cudaErrorInvalidValue;
  if (dh <= 64)
    return launch_mma<64, 64, 4>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  if (dh <= 128)
    return launch_mma<128, 64, 2>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  return launch_mma<256, 32, 2>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
}

// ------------------------------------------------------------ fp32, 3xTF32

// Row strides (floats) of the fp32 tiles, padded against bank conflicts:
// Q and K rows of DH + 8, so the 64-bit loads of a half-warp (rows g ..
// g + 3 at 8 adjacent columns) start 8 banks apart; V rows of DH + 4, so
// the 32-bit loads of a warp (rows 2t or 2t + 1 at 8 adjacent columns)
// do.  Unlike a swizzle, padding leaves every fragment offset a
// per-thread base plus a compile-time constant.
template <int DH> __host__ __device__ constexpr int ld_qk() { return DH + 8; }
template <int DH> __host__ __device__ constexpr int ld_v() { return DH + 4; }

// Rows [row0, row0 + ROWS) of a (S, dh) fp32 matrix into a tile of ROWS
// rows of stride LD, by cp.async from THREADS threads; rows past S and
// columns past dh are zeros (dh <= DH).
template <int DH, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int S, int dh) {
  constexpr int kChunks = DH / 4;
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < S && c * 4 < dh;
    const float* g = ok ? src + (long long)(row0 + r) * dh + c * 4 : src;
    cp_async16(smem_addr(dst + r * LD + c * 4), g, ok ? 16 : 0);
  }
}

// DH: the head-dim bucket (64, 128 or 256), dh <= DH the real one; BK:
// keys per K/V tile; WARPS: warps of 16 query rows (the query tile is
// 16·WARPS rows); MINB: CTAs per SM the registers must allow.  Thread
// (warp w, lane; g = lane/4, t = lane%4) holds, of each 16×8 accumulator
// tile, rows r_lo = 16w + g and r_lo + 8, columns 2t and 2t + 1.  In every
// 8-deep k-step the thread's k columns are 2t (the mma's k = t) and 2t + 1
// (its k = t + 4), in A and in B alike.
template <int DH, int BK, int WARPS, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB)
flash_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int H, int KVH, int S, int dh, int causal, int window,
                    float scale_log2) {
  constexpr int kRows = 16 * WARPS, kThreads = 32 * WARPS;
  constexpr int kLQ = ld_qk<DH>(), kLV = ld_v<DH>();
  constexpr int kStage = BK * (kLQ + kLV);   // floats of a K and a V tile
  constexpr int kNT = BK / 8;      // 8-key tiles: score tiles, P·V k-steps
  constexpr int kDT = DH / 8;      // Q·Kᵀ k-steps, 8-column output tiles
  // grid (B·H, nq): the CTAs of one query tile index start together for
  // every (b, h), longest tiles first
  const int nq = gridDim.y;
  const int qb = nq - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // Q tile, then the ring: stage st holds K, then V
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* ring = q_s + kRows * kLQ;

  const float* qg = q + ((long long)b * H + h) * S * dh;
  const float* kg = k + ((long long)b * KVH + kvh) * S * dh;
  const float* vg = v + ((long long)b * KVH + kvh) * S * dh;
  const int q0 = qb * kRows;
  const int q_last = (q0 + kRows - 1 < S - 1) ? q0 + kRows - 1 : S - 1;
  const int n_kb = (S + BK - 1) / BK;
  const int last_blk = causal ? q_last / BK : n_kb - 1;
  int first_blk = 0;
  if (window > 0 && q0 - window + 1 > 0) first_blk = (q0 - window + 1) / BK;

  load_tile_f32<DH, kRows, kLQ, kThreads>(q_s, qg, q0, S, dh);
  load_tile_f32<DH, BK, kLQ, kThreads>(ring, kg, first_blk * BK, S, dh);
  load_tile_f32<DH, BK, kLV, kThreads>(ring + BK * kLQ, vg, first_blk * BK,
                                       S, dh);
  cp_async_commit();

  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int r_lo = q0 + warp * 16 + g;
  const int c_lo = 2 * t;
  // this thread's fragments: Q rows 16w + g (and + 8), K rows g, V rows
  // 2t (and + 1), at columns 2t (Q, K) or g (V) of each 8-column step
  const float* qa = q_s + (warp * 16 + g) * kLQ + c_lo;
  const int k_off = g * kLQ + c_lo;
  const int v_off = BK * kLQ + c_lo * kLV + g;

  for (int kb = first_blk; kb <= last_blk; ++kb) {
    const int st = (kb - first_blk) & 1;
    if (kb < last_blk) {                       // next tile in flight
      float* nxt = ring + (st ^ 1) * kStage;
      load_tile_f32<DH, BK, kLQ, kThreads>(nxt, kg, (kb + 1) * BK, S, dh);
      load_tile_f32<DH, BK, kLV, kThreads>(nxt + BK * kLQ, vg,
                                           (kb + 1) * BK, S, dh);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const float* kf = ring + st * kStage + k_off;
    const float* vf = ring + st * kStage + v_off;

    // S = Q·Kᵀ for this warp's 16 rows × BK keys, 3xTF32: big·big into
    // sc, the two small terms into sc_sb and sc_bs, summed at the end
    // (the mma adds into its accumulator rounding toward zero, so fewer
    // additions into the large sum keep its bias small; three independent
    // accumulators also keep three mma chains in flight a score tile)
    float sc[kNT][4], sc_sb[kNT][4], sc_bs[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = sc_sb[n][e] = sc_bs[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(qa + kk * 8);
      const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * kLQ
                                                         + kk * 8);
      uint32_t a_big[4], a_small[4];
      split_tf32(x0.x, a_big[0], a_small[0]);
      split_tf32(x1.x, a_big[1], a_small[1]);
      split_tf32(x0.y, a_big[2], a_small[2]);
      split_tf32(x1.y, a_big[3], a_small[3]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(
            kf + n * 8 * kLQ + kk * 8);
        uint32_t b_big0, b_small0, b_big1, b_small1;
        split_tf32(y.x, b_big0, b_small0);
        split_tf32(y.y, b_big1, b_small1);
        mma1688_tf32(sc_sb[n], a_small, b_big0, b_big1);
        mma1688_tf32(sc_bs[n], a_big, b_small0, b_small1);
        mma1688_tf32(sc[n], a_big, b_big0, b_big1);
      }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] += sc_sb[n][e] + sc_bs[n][e];

    // mask only the tiles that cross the diagonal, the window edge or the
    // ragged tail; masked scores become the sentinel and then exactly 0
    const int k0 = kb * BK;
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0)
                      || (window > 0 && q_last - k0 >= window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = r_lo + (e >> 1) * 8;
          const int kp = k0 + n * 8 + c_lo + (e & 1);
          bool ok = kp < S;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && qp - kp < window;
          if (!ok) sc[n][e] = kNegInf;
        }
    }

    // online softmax in fp32: rows r_lo (i = 0) and r_lo + 8 (i = 1),
    // reduced over the quad of lanes that share them
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    float corr[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f((m[i] - mx[i]) * scale_log2);
      m[i] = mx[i];
      mc[i] = mx[i] * scale_log2;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(sc[n][e], scale_log2, -mc[e >> 1]));
        if (edge && sc[n][e] == kNegInf) p = 0.f;
        sc[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];

    // O = O·corr + P·V, 3xTF32: the score tile n is the A fragment of
    // k-step n (its accumulator (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
    // is A's (g, k t), (g, k t+4), (g+8, k t), (g+8, k t+4) in the permuted
    // k).  Each 8-column tile's P·V starts from zero and joins O in one
    // rounded fma: summed in O's own accumulator over thousands of keys,
    // the mma's additions toward zero would bias O several times more than
    // the fp32 plain version errs.
    uint32_t p_big[kNT][4], p_small[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      split_tf32(sc[n][0], p_big[n][0], p_small[n][0]);
      split_tf32(sc[n][2], p_big[n][1], p_small[n][1]);
      split_tf32(sc[n][1], p_big[n][2], p_small[n][2]);
      split_tf32(sc[n][3], p_big[n][3], p_small[n][3]);
    }
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t b_big0, b_small0, b_big1, b_small1;
        split_tf32(vf[n * 8 * kLV + j * 8], b_big0, b_small0);
        split_tf32(vf[(n * 8 + 1) * kLV + j * 8], b_big1, b_small1);
        mma1688_tf32(pv, p_small[n], b_big0, b_big1);
        mma1688_tf32(pv, p_big[n], b_small0, b_small1);
        mma1688_tf32(pv, p_big[n], b_big0, b_big1);
      }
      o[j][0] = fmaf(o[j][0], corr[0], pv[0]);
      o[j][1] = fmaf(o[j][1], corr[0], pv[1]);
      o[j][2] = fmaf(o[j][2], corr[1], pv[2]);
      o[j][3] = fmaf(o[j][3], corr[1], pv[3]);
    }
    __syncthreads();                 // stage st is refilled next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  float* og = out + ((long long)b * H + h) * S * dh;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int c = j * 8 + c_lo;
    if (c >= dh) continue;                     // padded columns
    if (r_lo < S)
      *reinterpret_cast<float2*>(og + (long long)r_lo * dh + c) =
          make_float2(o[j][0] * inv0, o[j][1] * inv0);
    if (r_lo + 8 < S)
      *reinterpret_cast<float2*>(og + (long long)(r_lo + 8) * dh + c) =
          make_float2(o[j][2] * inv1, o[j][3] * inv1);
  }
}

template <int DH, int BK, int WARPS, int MINB>
int launch_tf32x3(const void* q, const void* k, const void* v, void* out,
                  int B, int H, int KVH, int S, int dh, int causal,
                  int window, float scale, cudaStream_t stream) {
  constexpr int kRows = 16 * WARPS;
  // Q + 2 × (K + V)
  const int smem = (kRows * ld_qk<DH>() + 2 * BK * (ld_qk<DH>() + ld_v<DH>()))
                   * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tf32x3_kernel<DH, BK, WARPS, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + kRows - 1) / kRows);
  flash_tf32x3_kernel<DH, BK, WARPS, MINB><<<grid, 32 * WARPS, smem,
                                             stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KVH, S, dh,
      causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// fp32: the head-dim bucket at or above dh
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int H, int KVH, int S, int dh, int causal, int window,
               float scale, cudaStream_t stream) {
  if (dh % 8 || dh > kMaxDh) return (int)cudaErrorInvalidValue;
  if (dh <= 64)
    return launch_tf32x3<64, 32, 4, 2>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  if (dh <= 128)
    return launch_tf32x3<128, 32, 4, 2>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  return launch_tf32x3<256, 16, 8, 1>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
}

}  // namespace

// dtype: 0 = float32 (3xTF32 tensor-core kernel), 1 = bfloat16
// (tensor-core kernel).  causal: 0/1.  window <= 0 = none.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int KVH, int S, int dh, int causal,
                                      int window, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0) return 0;
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, H, KVH, S, dh, causal, window, scale,
                      s);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, B, H, KVH, S, dh, causal, window, scale,
                       s);
  return (int)cudaErrorInvalidValue;
}
