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
// fallback: a call that cannot launch returns its error).  Both keep the
// online softmax in fp32 registers with scale·log2(e) folded into the
// exponent (the scores are never rounded; q is not pre-scaled), and take
// head dims as compile-time buckets 64, 128 and 256, any other dh (a
// multiple of 8) zero-padded to the next bucket, the padded output
// columns not written.
//
// bf16: `flash_wgmma_kernel`, Hopper's structure.  A CTA is two consumer
// warpgroups of 64 query rows each and one producer warp (384 threads;
// `setmaxnreg` moves registers from the producer's warpgroup, 24 a
// thread, to the consumers, 240).  The producer's one thread loads, by
// TMA through tensor maps built on the host from the operands' own
// strides (q, k and v are read where they lie, the transposed views of a
// (B,S,heads,dh) projection included), the CTA's two Q tiles and then
// every K/V block of its stream into rings of K and of V blocks (3
// stages at dh 64 and 128, 2 at 256) on full/empty mbarriers.  Boxes are
// 64 columns (128 bytes) wide in the 128-byte swizzle, so a 128- or
// 256-wide row is 2 or 4 boxes; rows and columns past the tensor load as
// zeros.  Each consumer warpgroup runs `wgmma.mma_async` m64nNk16: S =
// Q·Kᵀ with Q and K both K-major in shared memory (N = the key block,
// 128 keys, 64 at dh 256), O += P·V with P in registers (the score
// accumulator is already the A fragment, rounded to bf16) and V read as
// an MN-major (transposed) B, so V is staged as it lies.  A block's
// scores are issued and waited for alone, then the previous block's P·V
// is in flight while this block's softmax runs; no product is in flight
// across a branch (ptxas would serialise them).  A block's K stage is
// released once its scores are in registers, its V stage once its P·V is
// done; a warpgroup acknowledges the blocks it skips too (ack_blocks).
// Scheduling (`tile_pair`, mirrored by the wrapper): causal tiles are
// paired p with nq-1-p, so every CTA of a prompt walks about the same
// nq+1 tile-blocks (qwen2.5-3b's S 1024 is 128 equal CTAs, one wave);
// windowed and non-causal tiles pair 2p with 2p+1.  The longer walk's
// extra blocks go, every other one, to the other warpgroup, and the two
// partial states of that tile are joined in shared memory.  At dh 256,
// where only 2-stage rings fit and a walk whose blocks alternate between
// the warpgroups would starve them, the wrapper pairs tile p of two query
// heads instead, where a KV head serves an even number of them (every
// block streamed then serves both warpgroups).  The wrapper's
// `split_plan` may split the longest pairs into pieces of their stream,
// one CTA each, whose partial states go through device memory to the
// last piece to arrive on the pair's counter, which joins them
// (recurrentgemma-2b's pairs at dh 256 would otherwise leave its longest
// CTAs running alone).
// What bounds it: the tensor cores and, between a warpgroup's products,
// its softmax (at dh 64 the exponents are as much work as the products);
// at dh 256 also the blocks the SMs read from L2.
//
// fp32: `flash_tf32x3_kernel`, the FlashAttention-2 structure (one CTA
// per (query tile, b, h), warps of 16 query rows, the Q tile and a
// 2-stage ring of K and V tiles loaded by 16-byte cp.async), on
// mma.sync.m16n8k8 with tf32 operands and fp32 accumulators.  One TF32
// product keeps 11 significant bits (about 3 decimal digits) and misses
// the fp32 tolerance (2e-5) many times, so
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
// bounds its grid); the mask is applied only on the blocks that cross the
// diagonal, the window edge or the ragged tail, where masked scores
// become exactly 0; the longest work is issued first across every (b, h)
// (the slow grid dimension); a row that no key reaches gets l floored at
// 1e-30.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxDh = 256;
constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------ bf16, wgmma
constexpr int kRowsQ = 64;           // query rows of a tile: one warpgroup
constexpr int kBox = 64;             // bf16 columns of a TMA box (128 B)
constexpr int kBoxBytes = 2 * kBox;  // one row of a box
constexpr int kThreads = 384;        // 2 consumer warpgroups + producer
constexpr int kConsumerRegs = 240, kProducerRegs = 24;

// The two query tiles of a CTA and the KV blocks (BK keys each) its
// consumer warpgroups walk (mirrored by the wrapper's tile_pair).  With
// head_pairs (the wrapper's use_head_pairs) the slots are tile p of two
// query heads of one KV head: every block streamed serves both
// warpgroups.  Otherwise slot 1 holds the later tile; slot 0 the earlier
// one, or none (-1).  Causal
// attention with no window that can bind pairs tile p with tile nq-1-p
// ("complementary": every pair then reaches nq + 1 tile-blocks or so,
// where unpaired tiles reach 1..nq); a window or non-causal attention
// pairs tiles 2p and 2p+1 ("adjacent": their block ranges overlap or
// touch).  The ring streams blocks s0..s1, the union of the two ranges.
// Warpgroup 0 walks slot 0's n[0] blocks and then, every other one from
// bo0 (the first block only slot 1 reaches), `moved` blocks of slot 1;
// warpgroup 1 walks the rest of slot 1's n[1]; when moved > 0 the two
// partial softmax states of slot 1 are merged at the end.  moved =
// (n1 - n0) / 2 evens the two walks.  Piece k of `pieces` (a split pair)
// clips all of it to its share of the stream.
struct TilePair {
  int t[2], first[2], last[2], n[2];
  int s0, s1, bo0, moved;
};

__device__ __forceinline__ void tile_blocks(int t, int S, int BK, int causal,
                                            int window, int& first,
                                            int& last) {
  const int q0 = t * kRowsQ;
  const int q_last = min(q0 + kRowsQ - 1, S - 1);
  last = causal ? q_last / BK : (S - 1) / BK;
  first = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BK : 0;
}

__device__ __forceinline__ TilePair tile_pair(int p, int nq, int S, int BK,
                                              int causal, int window,
                                              int piece, int pieces,
                                              int head_pairs) {
  TilePair r;
  if (head_pairs) {
    r.t[0] = r.t[1] = p;
  } else if (causal && (window <= 0 || window >= S)) {
    r.t[0] = p;
    r.t[1] = nq - 1 - p;
    if (r.t[0] == r.t[1]) r.t[0] = -1;
  } else {
    r.t[0] = 2 * p;
    r.t[1] = 2 * p + 1;
    if (r.t[1] >= nq) {
      r.t[1] = r.t[0];
      r.t[0] = -1;
    }
  }
  tile_blocks(r.t[1], S, BK, causal, window, r.first[1], r.last[1]);
  if (r.t[0] >= 0) {
    tile_blocks(r.t[0], S, BK, causal, window, r.first[0], r.last[0]);
  } else {
    r.first[0] = r.first[1];
    r.last[0] = r.first[1] - 1;            // no blocks
  }
  r.s0 = min(r.first[0], r.first[1]);
  r.s1 = r.last[1];
  if (pieces > 1) {
    const int n = r.s1 - r.s0 + 1;
    r.s1 = r.s0 + (piece + 1) * n / pieces - 1;
    r.s0 = r.s0 + piece * n / pieces;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r.first[i] = max(r.first[i], r.s0);
      r.last[i] = min(r.last[i], r.s1);
    }
  }
  r.n[0] = r.t[0] >= 0 ? max(0, r.last[0] - r.first[0] + 1) : 0;
  r.n[1] = max(0, r.last[1] - r.first[1] + 1);
  r.bo0 = r.n[0] ? max(r.first[1], r.last[0] + 1) : r.first[1];
  r.moved = r.n[1] > r.n[0] ? (r.n[1] - r.n[0]) / 2 : 0;
  return r;
}

// What the consumers' epilogue needs of a CTA, kept in shared memory
// across the walks rather than in registers (dh 256 has none to spare).
struct CtaEnd {
  int b, h0, h1, t0, t1, moved, in_piece, pair_id, piece;
};

// A warpgroup's walks (the consumers' view), each in stream order: 0,
// warpgroup 0 over slot 0's blocks; 1, warpgroup 0 over its `moved`
// blocks of slot 1 (every other one from bo0); 2, warpgroup 1 over the
// rest of slot 1's.  Step i of a walk is block a + i for i < pre, then
// b + 2 (i - pre) for `alt` steps, then c + (i - pre - alt); s0 is the
// stream's first block (block j sits in stage (j - s0) % STAGES).
struct Walk {
  int a, pre, b, alt, c, s0, steps;
};

__device__ __forceinline__ Walk make_walk(const TilePair& r, int walk) {
  Walk w;
  w.s0 = r.s0;
  w.a = walk == 0 ? r.first[0] : r.first[1];
  w.pre = walk == 0 ? r.n[0] : walk == 1 ? 0 : r.bo0 - r.first[1];
  w.b = walk == 1 ? r.bo0 : r.bo0 + 1;
  w.alt = walk == 0 ? 0 : r.moved;
  w.c = r.bo0 + 2 * r.moved;
  w.steps = walk == 0 ? r.n[0] : walk == 1 ? r.moved : r.n[1] - r.moved;
  return w;
}

__device__ __forceinline__ int walk_block(const Walk& w, int i) {
  if (i < w.pre) return w.a + i;
  if (i < w.pre + w.alt) return w.b + 2 * (i - w.pre);
  return w.c + (i - w.pre - w.alt);
}


// S = Q·Kᵀ for one warpgroup's 64 query rows (Q tile at s_q) and a block
// of BK keys (K at s_k), issued and committed, not waited for.  Both are
// K-major: a k-step is 16 columns (32 bytes) inside a box's swizzle atom,
// a box 64 columns.  Thread (warp w, lane = 4g + t) holds sc[4n + 2i + e]
// = S(16w + g + 8i, 8n + 2t + e) (wgmma's fp32 layout).
template <int DH, int BK>
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2],
                                             uint32_t s_q, uint32_t s_k) {
  // opaque to the compiler, so that Q's DH/16 descriptors are built at
  // each block instead of being hoisted out of the walk into 2·DH/16
  // registers that dh 256 does not have
  asm volatile("" : "+r"(s_q));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    Wgmma<BK>::ss(sc,
                  sw128_desc(s_q + (kk >> 2) * kRowsQ * kBoxBytes + col, 16,
                             1024),
                  sw128_desc(s_k + (kk >> 2) * BK * kBoxBytes + col, 16,
                             1024),
                  kk > 0);
  }
  wgmma_commit();
}

// O += P·V, issued and committed: P (bf16 A fragments in registers) over
// the block's V at s_v, the MN-major B operand (its rows are keys, dh
// contiguous: 64-column chunks one box apart, 8-key groups 1024 bytes
// apart).
template <int DH, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         uint32_t (&pa)[BK / 16][4],
                                         uint32_t s_v) {
  pin_regs(o);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kk][i]));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<DH>::rs_t(o, pa[kk],
                    sw128_desc(s_v + kk * 16 * kBoxBytes, BK * kBoxBytes,
                               1024),
                    1);
  wgmma_commit();
}

// The mask of one block's scores for rows r_lo (i = 0) and r_lo + 8
// (i = 1) of the tile at q0, applied only to blocks that cross the
// diagonal, the window edge or the ragged tail: masked scores become the
// sentinel (and then exactly 0).
template <int BK>
__device__ __forceinline__ void mask_block(float (&sc)[BK / 2], int q0,
                                           int k0, int r_lo, int c_lo, int S,
                                           int causal, int window) {
  const int q_last = min(q0 + kRowsQ - 1, S - 1);
  const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0)
                    || (window > 0 && q_last - k0 >= window);
  if (!edge) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // admitted keys of row qp: lo..hi
    const int qp = r_lo + 8 * i;
    const int hi = min(S - 1, causal ? qp : S - 1) - k0 - c_lo;
    const int lo = (window > 0 ? qp - window + 1 : -1) - k0 - c_lo;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = n * 8 + e;
        if (kp > hi || kp < lo) sc[4 * n + 2 * i + e] = kNegInf;
      }
  }
}

// ex2.approx: 2^x to about 2 ulp (the probabilities are rounded to bf16)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one (masked) block's scores, rows as mask_block's,
// reduced over the quad of lanes that share them: sc becomes P
// (unnormalised, fp32), (m, l) are updated and corr is what O must be
// scaled by.  A row that no key has reached yet keeps m at the sentinel
// and takes its exponents against 0, so its masked scores give exactly 0.
template <int BK>
__device__ __forceinline__ void softmax_block(float (&sc)[BK / 2],
                                              float (&m)[2], float (&l)[2],
                                              float (&corr)[2],
                                              float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
  float mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = fast_exp2((m[i] - mx[i]) * scale_log2);
    m[i] = mx[i];
    mc[i] = mx[i] == kNegInf ? 0.f : mx[i] * scale_log2;
  }
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(sc[4 * n + e], scale_log2,
                                     -mc[e >> 1]));
      sc[4 * n + e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
}

// O / l of a finished tile into out (rows < S, columns < dh), bf16
template <int DH>
__device__ __forceinline__ void store_tile(const float (&o)[DH / 2],
                                           float (&l)[2],
                                           __nv_bfloat16* og, long long os_s,
                                           int r_lo, int c_lo, int S,
                                           int dh) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = j * 8 + c_lo;
    if (c >= dh) continue;                     // padded columns
    if (r_lo < S)
      *reinterpret_cast<uint32_t*>(og + r_lo * os_s + c) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r_lo + 8 < S)
      *reinterpret_cast<uint32_t*>(og + (r_lo + 8) * os_s + c) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int DH>
__device__ __forceinline__ void reset_state(float (&o)[DH / 2], float (&m)[2],
                                            float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;
}

// A warpgroup's softmax state (o, m, l) to dst, thread-major: thread tid
// writes dst[i * 128 + tid] for o[i], then m, then l (its per-thread
// partial l), so that any warpgroup's thread tid (the same rows and
// columns) reads it back.
template <int DH>
__device__ __forceinline__ void put_state(float* dst, int tid,
                                          const float (&o)[DH / 2],
                                          const float (&m)[2],
                                          const float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dst[i * 128 + tid] = o[i];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dst[(DH / 2 + i) * 128 + tid] = m[i];
    dst[(DH / 2 + 2 + i) * 128 + tid] = l[i];
  }
}

// (o, m, l) joined with the state put_state wrote at src (from another
// warpgroup of this CTA, or, global, from another CTA: read past L1)
template <int DH>
__device__ __forceinline__ void join_state(float (&o)[DH / 2], float (&m)[2],
                                           float (&l)[2], const float* src,
                                           int tid, float scale_log2,
                                           bool global) {
  auto rd = [&](int i) {
    return global ? __ldcg(src + i * 128 + tid) : src[i * 128 + tid];
  };
  float c_own[2], c_src[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float ms = rd(DH / 2 + i);
    const float mm = fmaxf(m[i], ms);
    c_own[i] = exp2f((m[i] - mm) * scale_log2);
    c_src[i] = exp2f((ms - mm) * scale_log2);
    l[i] = l[i] * c_own[i] + rd(DH / 2 + 2 + i) * c_src[i];
    m[i] = mm;
  }
#pragma unroll
  for (int i = 0; i < DH / 2; ++i)
    o[i] = o[i] * c_own[(i >> 1) & 1] + rd(i) * c_src[(i >> 1) & 1];
}

// one consumer warp's arrival on an empty barrier (8 make a phase)
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// A warpgroup acknowledges every block of the stream, in stream order:
// the blocks it skips too (waits for the load, then arrives on the empty
// barrier), so that no stage's barriers run two phases ahead of it (a
// wait by phase parity cannot tell phase u from u + 2).  Skipped blocks
// come at most one at a time inside a walk: their K is acknowledged
// before the next block's scores, their V once the previous block's V
// stage is released (the producer loads a block's K and V in turn); at a
// walk's start and after the last walk, nothing of the warpgroup's is
// held, and both are acknowledged block by block.  bars: the full
// barriers of K or V, their empty ones STAGES further.
template <int STAGES>
__device__ __forceinline__ void ack_blocks(uint32_t bars, int s0, int from,
                                           int to, int lane) {
  for (int jj = from; jj < to; ++jj) {
    const int it = jj - s0;
    mbar_wait(bars + 8 * (it % STAGES), (it / STAGES) & 1);
    release(bars + 8 * (STAGES + it % STAGES), lane);
  }
}
template <int STAGES>
__device__ __forceinline__ void ack_kv(uint32_t s_bar, int s0, int from,
                                       int to, int lane) {
  for (int jj = from; jj < to; ++jj) {
    ack_blocks<STAGES>(s_bar, s0, jj, jj + 1, lane);
    ack_blocks<STAGES>(s_bar + 8 * 2 * STAGES, s0, jj, jj + 1, lane);
  }
}

// The masked scores of step i of a walk: wait for the block's K stage,
// issue Q·Kᵀ and wait for it (nothing else in flight), release the
// stage, mask.  Returns the block, its stage and phase.
template <int DH, int BK, int STAGES>
__device__ __forceinline__ int walk_scores(
    float (&sc)[BK / 2], const Walk& w, int i, int seen, uint32_t s_qt,
    int q0, uint32_t s_k, uint32_t s_bar, int lane, int r_lo, int c_lo,
    int S, int causal, int window, int& st, uint32_t& ph) {
  constexpr uint32_t kKVBytes = (DH / kBox) * BK * kBoxBytes;
  const int j = walk_block(w, i);
  const int it = j - w.s0;
  st = it % STAGES;
  ph = (it / STAGES) & 1;
  if (i == 0)
    ack_kv<STAGES>(s_bar, w.s0, seen + 1, j, lane);     // skipped K and V
  else
    ack_blocks<STAGES>(s_bar, w.s0, seen + 1, j, lane);  // skipped K
  mbar_wait(s_bar + 8 * st, ph);                        // K full
  issue_scores<DH, BK>(sc, s_qt, s_k + st * kKVBytes);
  wgmma_wait<0>();
  pin_regs(sc);
  release(s_bar + 8 * (STAGES + st), lane);             // K empty
  mask_block<BK>(sc, q0, j * BK, r_lo, c_lo, S, causal, window);
  return j;
}

// P rounded to bf16: the accumulator of keys 16kk..16kk+15 is already the
// A fragment of k-step kk
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// One walk w of a warpgroup, of w.steps > 0 blocks, with its Q tile at
// s_qt (rows q0..): each block's scores come with nothing else in flight
// (walk_scores), then the previous block's P·V is on the tensor cores
// while this block's softmax runs; a block's V stage is released once its
// P·V is done.  No product is in flight across a branch.  seen: the last
// block of the stream this warpgroup has acknowledged (ack_blocks),
// updated.
// Leaves the walk's softmax state in (o, m, l), o starting at zero.
template <int DH, int BK, int STAGES>
__device__ __forceinline__ void walk_tile(
    float (&o)[DH / 2], float (&m)[2], float (&l)[2], const Walk& w,
    int& seen, uint32_t s_qt, int q0, uint32_t s_k, uint32_t s_v,
    uint32_t s_bar, int lane, int r_lo, int c_lo, int S, int causal,
    int window, float scale_log2) {
  constexpr uint32_t kKVBytes = (DH / kBox) * BK * kBoxBytes;
  const uint32_t full_v = s_bar + 8 * 2 * STAGES;
  uint32_t pa[BK / 16][4];
  float sc[BK / 2], corr[2];
  int p_st, st;
  uint32_t p_ph, ph;
  int j = walk_scores<DH, BK, STAGES>(sc, w, 0, seen, s_qt, q0, s_k, s_bar,
                                      lane, r_lo, c_lo, S, causal, window,
                                      p_st, p_ph);
  softmax_block<BK>(sc, m, l, corr, scale_log2);
  seen = j;
  pack_p<BK>(pa, sc);
  for (int i = 1; i < w.steps; ++i) {
    j = walk_scores<DH, BK, STAGES>(sc, w, i, seen, s_qt, q0, s_k, s_bar,
                                    lane, r_lo, c_lo, S, causal, window, st,
                                    ph);
    mbar_wait(full_v + 8 * p_st, p_ph);                  // V full
    issue_pv<DH, BK>(o, pa, s_v + p_st * kKVBytes);
      softmax_block<BK>(sc, m, l, corr, scale_log2);
    wgmma_wait<0>();
    pin_regs(o);
    release(s_bar + 8 * (3 * STAGES + p_st), lane);      // V empty
    ack_blocks<STAGES>(full_v, w.s0, seen + 1, j, lane);  // skipped V
    seen = j;
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj) {
      o[4 * jj] *= corr[0];
      o[4 * jj + 1] *= corr[0];
      o[4 * jj + 2] *= corr[1];
      o[4 * jj + 3] *= corr[1];
    }
    pack_p<BK>(pa, sc);
    p_st = st;
    p_ph = ph;
  }
  mbar_wait(full_v + 8 * p_st, p_ph);                    // the last P·V
  issue_pv<DH, BK>(o, pa, s_v + p_st * kKVBytes);
  wgmma_wait<0>();
  pin_regs(o);
  release(s_bar + 8 * (3 * STAGES + p_st), lane);
}

// DH: the head-dim bucket (64, 128 or 256), dh <= DH the real one (the
// columns past it load as zeros); BK: keys per K/V block; STAGES: blocks
// in each of the K and V rings.  grid (B·H, or B·H/2 head pairs;
// pairs + split · (pieces - 1)): the CTAs of one index start together for
// every (b, h); the `split` longest pairs first, `pieces` CTAs each (each
// walks its share of the pair's stream, writes both tiles' partial
// softmax states to ws, and the last of the pair to arrive on its counter
// merges them; counters are left zero), then the other pairs, longest
// first, one CTA each.  Threads: warpgroups 0
// and 1 consume (64 query rows each), warp 8 (warpgroup 2) produces.
template <int DH, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, long long os_b,
                   long long os_h, long long os_s, int H, int KVH, int S,
                   int dh, int causal, int window, float scale_log2,
                   int head_pairs, int split, int pieces,
                   float* __restrict__ ws, int* __restrict__ counters) {
  constexpr int kNB = DH / kBox;                            // boxes a row
  constexpr uint32_t kQBytes = kNB * kRowsQ * kBoxBytes;    // one Q tile
  constexpr uint32_t kKVBytes = kNB * BK * kBoxBytes;       // K or V block
  // 1024-aligned (the swizzle atom): Q tiles of slots 0 and 1, the K
  // ring, the V ring (each block box after box), then the barriers:
  // full and empty of each K stage, of each V stage, and Q's
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base + 2 * kQBytes;
  const uint32_t s_v = s_k + STAGES * kKVBytes;
  const uint32_t s_bar = s_v + STAGES * kKVBytes;
  const uint32_t q_bar = s_bar + 32 * STAGES;
  auto full_k = [&](int st) { return s_bar + 8 * st; };
  auto empty_k = [&](int st) { return s_bar + 8 * (STAGES + st); };
  auto full_v = [&](int st) { return s_bar + 8 * (2 * STAGES + st); };
  auto empty_v = [&](int st) { return s_bar + 8 * (3 * STAGES + st); };

  const int nq = (S + kRowsQ - 1) / kRowsQ;
  const int pairs = head_pairs ? nq : (nq + 1) / 2;
  const int hx = head_pairs ? H / 2 : H;           // CTAs of one b
  const int bh = blockIdx.x;
  const int b = bh / hx;
  const int h0 = head_pairs ? 2 * (bh % hx) : bh % hx;
  const int h1 = head_pairs ? h0 + 1 : h0;          // the slots' heads
  const int kvh = h0 / (H / KVH);
  // the split pairs' pieces first, longest pair first, then whole pairs
  const bool in_piece = (int)blockIdx.y < split * pieces;
  const int p = pairs - 1 - (in_piece ? blockIdx.y / pieces
                                      : blockIdx.y - split * (pieces - 1));
  const int piece = in_piece ? blockIdx.y % pieces : 0;
  const TilePair pr = tile_pair(p, nq, S, BK, causal, window, piece,
                                in_piece ? pieces : 1, head_pairs);

  CtaEnd* cta_end = reinterpret_cast<CtaEnd*>(smem_raw + (q_bar + 16 - raw));
  if (threadIdx.x == 0) {
    *cta_end = CtaEnd{b, h0, h1, pr.t[0], pr.t[1], pr.moved, in_piece,
                      bh * split + (pairs - 1 - p), piece};
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(empty_k(st), 8);
      mbar_init(full_v(st), 1);
      mbar_init(empty_v(st), 8);
    }
    mbar_init(q_bar, 1);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread of warp 8 issues every TMA load
    regs_release<kProducerRegs>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_expect_tx(q_bar, ((pr.n[0] > 0) + (pr.n[1] > 0)) * kQBytes);
      for (int slot = 0; slot < 2; ++slot) {
        if (!pr.n[slot]) continue;
#pragma unroll
        for (int c = 0; c < kNB; ++c)
          tma_load_4d(base + slot * kQBytes + c * kRowsQ * kBoxBytes, &tq,
                      q_bar, c * kBox, pr.t[slot] * kRowsQ,
                      slot ? h1 : h0, b);
      }
      for (int j = pr.s0, it = 0; j <= pr.s1; ++j, ++it) {
        const int st = it % STAGES;
        const uint32_t wait_parity = (it / STAGES - 1) & 1;
        if (it >= STAGES) mbar_wait(empty_k(st), wait_parity);
        mbar_expect_tx(full_k(st), kKVBytes);
#pragma unroll
        for (int c = 0; c < kNB; ++c)
          tma_load_4d(s_k + st * kKVBytes + c * BK * kBoxBytes, &tk,
                      full_k(st), c * kBox, j * BK, kvh, b);
        if (it >= STAGES) mbar_wait(empty_v(st), wait_parity);
        mbar_expect_tx(full_v(st), kKVBytes);
#pragma unroll
        for (int c = 0; c < kNB; ++c)
          tma_load_4d(s_v + st * kKVBytes + c * BK * kBoxBytes, &tv,
                      full_v(st), c * kBox, j * BK, kvh, b);
      }
    }
  } else {
    // consumers: warpgroup 0 walks slot 0's tile and writes it, then its
    // share of slot 1's; warpgroup 1 walks the rest of slot 1's
    regs_claim<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row = 16 * (tid / 32) + (lane >> 2);
    const int c_lo = 2 * (lane & 3);
    float o[DH / 2], m[2], l[2];
    reset_state<DH>(o, m, l);
    mbar_wait(q_bar, 0);
    // a split pair's partial states: (DH/2 + 4) x 128 floats a slot,
    // thread-major (o, then m, then l)
    constexpr int kPart = (DH / 2 + 4) * 128;
    int seen = pr.s0 - 1;
    if (wg == 0 && pr.t[0] >= 0) {
      const int q0 = pr.t[0] * kRowsQ;
      const Walk w = make_walk(pr, 0);
      if (w.steps > 0)
        walk_tile<DH, BK, STAGES>(o, m, l, w, seen, base, q0, s_k, s_v,
                                  s_bar, lane, q0 + row, c_lo, S, causal,
                                  window, scale_log2);
      const CtaEnd e = *cta_end;
      if (e.in_piece)
        put_state<DH>(ws + ((long long)e.pair_id * pieces + e.piece) * 2
                               * kPart,
                      tid, o, m, l);
      else
        store_tile<DH>(o, l, out + e.b * os_b + e.h0 * os_h, os_s,
                       e.t0 * kRowsQ + row, c_lo, S, dh);
      reset_state<DH>(o, m, l);
    }
    const Walk w = make_walk(pr, wg == 0 ? 1 : 2);
    if (w.steps > 0) {
      const int q0 = pr.t[1] * kRowsQ;
      walk_tile<DH, BK, STAGES>(o, m, l, w, seen, base + kQBytes, q0, s_k,
                                s_v, s_bar, lane, q0 + row, c_lo, S, causal,
                                window, scale_log2);
    }
    ack_kv<STAGES>(s_bar, pr.s0, seen + 1, pr.s1 + 1, lane);
    const CtaEnd e = *cta_end;
    float* mine = ws + ((long long)e.pair_id * pieces + e.piece) * 2 * kPart;
    if (e.moved > 0) {
      // warpgroup 0's partial state of slot 1 joins warpgroup 1's through
      // the rings, which every load and product has left: thread tid of
      // both holds the same rows and columns
      float* buf = reinterpret_cast<float*>(smem_raw + (s_k - raw));
      named_sync(1, 256);
      if (wg == 0) put_state<DH>(buf, tid, o, m, l);
      named_sync(2, 256);
      if (wg == 1) join_state<DH>(o, m, l, buf, tid, scale_log2, false);
    }
    if (!e.in_piece) {
      if (wg == 1)
        store_tile<DH>(o, l, out + e.b * os_b + e.h1 * os_h, os_s,
                       e.t1 * kRowsQ + row, c_lo, S, dh);
    } else {
      // every piece writes both slots' states; the last of the pair to
      // arrive merges them, warpgroup s slot s, and leaves the counter 0
      if (wg == 1) put_state<DH>(mine + kPart, tid, o, m, l);
      __threadfence();
      named_sync(3, 256);
      volatile int* last = reinterpret_cast<volatile int*>(
          smem_raw + (q_bar + 8 - raw));
      if (threadIdx.x == 0) {
        int* counter = counters + e.pair_id;
        const int is_last = atomicAdd(counter, 1) == pieces - 1;
        if (is_last) *counter = 0;
        *last = is_last;
      }
      named_sync(4, 256);
      if (*last && (wg == 1 || e.t0 >= 0)) {
        __threadfence();
        reset_state<DH>(o, m, l);
        const float* parts = ws + (long long)e.pair_id * pieces * 2 * kPart
                             + wg * kPart;
        for (int k = 0; k < pieces; ++k)
          join_state<DH>(o, m, l, parts + k * 2 * kPart, tid, scale_log2,
                         true);
        store_tile<DH>(o, l, out + e.b * os_b + (wg ? e.h1 : e.h0) * os_h,
                       os_s, (wg ? e.t1 : e.t0) * kRowsQ + row, c_lo, S, dh);
      }
    }
  }
}

template <int DH, int BK, int STAGES>
int launch_wgmma(const CUtensorMap& mq, const CUtensorMap& mk,
                 const CUtensorMap& mv, void* out, long long os_b,
                 long long os_h, long long os_s, int B, int H, int KVH,
                 int S, int dh, int causal, int window, float scale,
                 int head_pairs, int split, int pieces, float* ws,
                 int* counters, cudaStream_t stream) {
  constexpr int kNB = DH / kBox;
  // alignment slack + Q tiles + K and V rings + barriers + a flag + CtaEnd
  const int smem = 1024 + 2 * kNB * kRowsQ * kBoxBytes
                   + STAGES * 2 * kNB * BK * kBoxBytes + 8 * (4 * STAGES + 2)
                   + (int)sizeof(CtaEnd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH, BK, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + kRowsQ - 1) / kRowsQ;
  const int pairs = head_pairs ? nq : (nq + 1) / 2;
  dim3 grid(B * (head_pairs ? H / 2 : H), pairs + split * (pieces - 1));
  flash_wgmma_kernel<DH, BK, STAGES><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), os_b, os_h, os_s, H, KVH,
      S, dh, causal, window, scale * 1.4426950408889634f, head_pairs, split,
      pieces, ws, counters);
  return (int)cudaGetLastError();
}

// keys of a K/V block for a head-dim bucket (the wrapper's KEY_TILE)
constexpr int key_tile(int DH) { return DH > 128 ? 64 : 128; }

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

// fp32 (dtype 0: the 3xTF32 tensor-core kernel) over contiguous
// (B,H,S,dh) / (B,KVH,S,dh) tensors.  causal: 0/1.  window <= 0 = none.
// Returns the cudaError_t of the launch (0 = launched).
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
  return (int)cudaErrorInvalidValue;
}

// bf16 (the wgmma kernel) over strided views: geo holds, for q, k and v
// in turn, the tensor map's dims (dh, S, heads, B), byte strides of S,
// heads and B, and box (64, rows, 1, 1): 11 values each, from the
// wrapper's tma_geometry.  out is written through element strides
// (os_b, os_h, os_s; dh contiguous).  head_pairs (1 where H / KVH is
// even: a CTA's two tiles are one tile of two query heads), split, pieces:
// the wrapper's split_plan; a split launch takes ws (fp32, CTAs of one
// pair index (B·H, or B·H/2) · split · pieces · 2 · (dh bucket/2 + 4) ·
// 128) and as many times split zeroed int32 counters, which it leaves
// zero.  Returns 0, a cudaError_t, or 1000 + the CUresult of a tensor map
// that did not encode.
extern "C" int flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, void* out,
    const unsigned long long* geo, long long os_b, long long os_h,
    long long os_s, int B, int H, int KVH, int S, int dh, int causal,
    int window, float scale, int head_pairs, int split, int pieces, void* ws,
    void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0) return 0;
  if (dh % 8 || dh > kMaxDh || split < 0 || pieces < 1
      || (split > 0 && (pieces < 2 || !ws || !counters))
      || (head_pairs && (H / KVH) % 2))
    return (int)cudaErrorInvalidValue;
  const int bucket = dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
  if (geo[8] != kRowsQ || geo[11 + 8] != (unsigned long long)key_tile(bucket)
      || geo[22 + 8] != (unsigned long long)key_tile(bucket))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const unsigned long long* g = geo + 11 * i;
    const int res = encode_bf16_map(&maps[i], ptrs[i], g, g + 4, g + 7);
    if (res != 0) return 1000 + res;
  }
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  if (bucket == 64)
    return launch_wgmma<64, key_tile(64), 3>(maps[0], maps[1], maps[2], out, os_b, os_h, os_s, B, H, KVH, S, dh, causal, window, scale, head_pairs, split, pieces, w, c, s);
  if (bucket == 128)
    return launch_wgmma<128, key_tile(128), 3>(maps[0], maps[1], maps[2], out, os_b, os_h, os_s, B, H, KVH, S, dh, causal, window, scale, head_pairs, split, pieces, w, c, s);
  return launch_wgmma<256, key_tile(256), 2>(maps[0], maps[1], maps[2], out, os_b, os_h, os_s, B, H, KVH, S, dh, causal, window, scale, head_pairs, split, pieces, w, c, s);
}
