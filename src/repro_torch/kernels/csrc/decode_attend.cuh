// One query token per query head against a stored K/V sequence: the
// walks, the split and the merge shared by the decode kernels
// (paged_decode_step.cu: the fused step and the read-only paged form;
// decode_attention.cu: the ring cache).
//
// A CTA owns one (slot, KV head) and query heads of it, so each K/V row is
// read from device memory once for all of them.  A `Walk` maps token
// index t to the row of the K/V array that stores it, or -1 when t is
// masked:
//   long long row(int t) const;      // masked or t >= end: -1
//   long long any_row(int t) const;  // every t < n_all, masked or not
//   int begin, end, n_all;
// Masked tokens are never loaded and their probabilities are exactly 0
// (not garbage times 0), so NaN or Inf garbage in a masked row cannot
// reach the accumulator; a tile with no valid token is skipped.
//
// Split and merge.  Every entry point splits each (slot, KV head) walk
// over n CTAs (split_walk, shares of whole kTile-token tiles), as
// flash-decoding does: with few slots, one CTA each would leave most of
// the 132 SMs idle.  Each CTA writes its unnormalised fp32 partial (acc,
// m in log2 units, l), then bumps the pair's int32 arrival counter; the
// last CTA to arrive merges the n partials in the same launch
// (merge_pair: partials brought in by bulk copies, every thread on the
// output elements; the fused step's new token is one more partial) and
// resets the counter to 0.  A pair with no valid token at all gives the uniform
// mean of V over its n_all entries, as the plain softmax over an
// all-masked row does (only the read-only forms can have one).
//
// Two walks of one structure, chosen by the storage type (a fixed
// dispatch, not a fallback), both on the tensor cores.  The CTA's query
// heads (at most kRows = 16: a pair with g > 16 takes ceil(g/16) row
// tiles, each its own CTAs) are the A rows, zero-padded to 16, in shared
// memory.  Each of the 4 warps walks key tiles of the CTA's share (warp w
// takes tiles w, w+4, ...) on its own: a private ring of K and V tiles
// loaded by cp.async ahead of use (masked rows and padded head
// dimensions zero-filled with a source size of 0), S = Q·Kᵀ and O += P·V
// on mma.sync, the online softmax on the accumulator fragments in fp32
// with scale·log2 e folded into exp2f (the scores are never rounded).  No
// barrier in the loop: the warps meet once at the end, when their four
// partials are merged in shared memory into the CTA's (merge_warps).
// Head dims are compile-time buckets 64, 128, 256 (any dh, a multiple of
// 8, is zero-padded to the next).
// bf16 `attend_mma`, on m16n8k16: a 2-stage ring of 16-key tiles in
// swizzled rows, operands by ldmatrix / ldmatrix.trans; P rounded to bf16
// is the A operand of P·V.
// fp32 `attend_tf32`, on m16n8k8 as 3xTF32 (flash_attention.cu's
// flash_tf32x3_kernel has the same products): every fp32 operand split
// into a TF32 big part and a small part (split_tf32), each product taken
// as small·big + big·small + big·big; one TF32 product would miss 2e-5.
// Each warp splits the K and V fragments of its own tiles (every element
// once per CTA) and Q's fragments as it reads them, again for every tile:
// a second, pre-split Q tile would take the shared memory of the ring's
// third stage.  The score's big·big and small terms go to separate
// accumulators, four of each (k-steps mod 4: eight mma chains), and each
// tile's P·V starts from zero and joins O by one fma, O·corr + P·V (the
// mma adds into its accumulator rounding toward zero, which a long sum in
// one accumulator would turn into a bias).  ldmatrix cannot move fp32, so
// the k index of every 8-deep step is permuted (a thread's k columns are
// 2t and 2t + 1): Q and K fragments are one 64-bit load a row, the score
// accumulator of the 8-key tile is already P's A fragment, and V's B
// fragment is two 32-bit loads; rows are padded (Q, K: DH + 8 floats; V:
// DH + 4), not swizzled, so every fragment load is free of bank
// conflicts.  fp32 tiles are twice bf16's, so a warp's tile is 8 keys,
// in a 3-stage ring (two tiles in flight while it computes a third): the
// four rings and Q take 213 KB at dh 256 (one CTA an SM; 2-stage rings of
// 16-key tiles would take 256 KB, above a CTA's 227 KB), 109 KB at 128
// (two CTAs an SM), 57 KB at 64.
//
// What bounds both: bytes, by the work (4·g·dh flops a K/V row of 2·dh
// elements), but at the serving shapes a launch is a few microseconds of
// walk against a fixed cost: the ramp of a short grid, the ring's first
// tile, the arrival and the merge (25–31% of an fp32 launch, 28–41% of a
// bf16 one on an H100), which no walk design removes.  In the fp32 walk a
// tile's load latency, not its 96 score and 96 P·V mma (at dh 256) nor
// its splits (skipping the K and V splits saves 2% of a launch), sets the
// pace: so the fp32 walk is split over every CTA the SMs hold at once
// (walk_fill, where the bf16 walk takes half; at the recurrentgemma ring
// 0.0376 → 0.0295 ms), and keeps two tiles in flight a warp (the fused
// step at recurrentgemma's shape 0.0366 → 0.0340 ms against one).
#pragma once
#include "common.cuh"

namespace {

constexpr int kTile = 32;            // the unit of split shares
constexpr float kNegInf = -1e30f;    // finite sentinel, as the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kKeys = 16;            // keys of one bf16 warp tile
constexpr int kKeysF = 8;            // keys of one fp32 warp tile
constexpr int kStagesF = 3;          // stages of an fp32 warp's ring
constexpr int kRows = 16;            // query heads of one mma row tile
constexpr int kMaxHeadDim = 256;
// dynamic shared memory a CTA may use, less the static is_last
constexpr size_t kMaxSmem = 232448 - 16;

// split_count's fill: the bf16 walk is split over half the CTAs the SMs
// hold, the fp32 walk over all of them (see the header)
template <typename T>
constexpr int walk_fill() { return sizeof(T) == 4 ? 1 : 2; }
// CTAs an SM must hold by registers: fp32 (f32) or bf16, at bucket DH
__host__ __device__ constexpr int walk_min_blocks(int DH, bool f32) {
  return DH == 256 ? 1 : f32 && DH == 128 ? 2 : 3;
}
inline int dh_bucket(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 128 : 256; }
inline bool decode_dh_ok(int dh) {
  return dh > 0 && dh % 8 == 0 && dh <= kMaxHeadDim;
}

// row strides (floats) of the fp32 walk's Q and K tiles, and of V
__host__ __device__ constexpr int ld_qk(int DH) { return DH + 8; }
__host__ __device__ constexpr int ld_v(int DH) { return DH + 4; }

// bytes of the bf16 walk: the Q tile and each warp's 2-stage K/V ring (the
// warps' merge reuses it: kMmaWarps · (kRows·DH + 3·kRows) floats)
__host__ __device__ constexpr size_t mma_smem_bytes(int DH) {
  return (size_t)kRows * DH * 2 + (size_t)kMmaWarps * 4 * kKeys * DH * 2;
}
// bytes of the fp32 walk: the Q tile and each warp's kStagesF-stage K/V
// ring (the warps' merge reuses it)
__host__ __device__ constexpr size_t tf32_smem_bytes(int DH) {
  return 4 * ((size_t)kRows * ld_qk(DH) + (size_t)kMmaWarps * kStagesF
              * kKeysF * (ld_qk(DH) + ld_v(DH)));
}

template <typename T>
size_t walk_smem_bytes(int DH) {
  return sizeof(T) == 4 ? tf32_smem_bytes(DH) : mma_smem_bytes(DH);
}

// the merge's shared memory, in floats, before its accumulator: every
// entry's (m, l) and weight per row, and per row the reciprocal
// denominator (rounded up to 4 floats)
__host__ __device__ inline int merge_head_floats(int rows, int n) {
  return (3 * rows * n + rows + 3) & ~3;
}
// at least: the head, the accumulator and one split's staged partial
inline size_t merge_smem_bytes(int rows, int n, int dh) {
  return sizeof(float) * ((size_t)merge_head_floats(rows, n)
                          + 2 * (size_t)rows * dh);
}

// query rows a CTA holds and row tiles a pair takes
inline int cta_rows(int g) { return g > kRows ? kRows : g; }
inline int row_tiles(int g) { return (g + kRows - 1) / kRows; }

// n cut where the merge's shared memory would not fit a CTA's
inline int fit_splits(int rows, int dh, int n) {
  while (n > 1 && merge_smem_bytes(rows, n, dh) > kMaxSmem) --n;
  return n;
}

// The launch's dynamic shared memory, with n_split cut to what the
// merge's shared memory admits (n_split + extra entries a pair).
template <typename T, int DH>
size_t launch_smem(int g, int dh, int& n_split, int extra) {
  const int rows = cta_rows(g);
  const int n = fit_splits(rows, dh, n_split + extra);
  n_split = n - extra > 1 ? n - extra : 1;
  const size_t walk = walk_smem_bytes<T>(DH);
  const size_t merge = merge_smem_bytes(rows, n_split + extra, dh);
  return walk > merge ? walk : merge;
}

// How many CTAs share one (slot, KV head) walk: enough for `pairs` walks
// (pairs · row tiles CTAs per split) to fill 1/fill of the CTAs of
// `kernel` that `device`'s SMs hold at once (by its registers, `threads`
// and `smem`): the merge reads every partial in one CTA, and for the bf16
// walk half (fill 2) beat all of them at every serving shape on an H100,
// for the fp32 walk all (walk_fill).  n_tokens is the longest walk a pair
// can have (a paged slot's walk ends at its lens, so its later shares may
// be empty); a walk that long leaves no share empty.  Returns
// n >= 1, or -cudaError_t.
template <typename K>
inline int split_count(K* kernel, int threads, size_t smem, int pairs,
                       int n_tokens, int device, int fill) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return -(int)err;
  const int tiles = n_tokens > kTile ? (n_tokens + kTile - 1) / kTile : 1;
  const int p = pairs > 1 ? pairs : 1;
  const int slots = (per_sm > 1 ? per_sm : 1) * sms / fill;
  int want = (slots + p - 1) / p;
  want = want < tiles ? want : tiles;
  want = want > 1 ? want : 1;
  const int per = (tiles + want - 1) / want;
  return (tiles + per - 1) / per;
}

// share z of n of the walk's tiles (empty when the walk is shorter)
template <typename Walk>
__device__ __forceinline__ Walk split_walk(Walk w, int z, int n) {
  const int tiles = w.end > w.begin ? (w.end - w.begin + kTile - 1) / kTile
                                    : 0;
  const int per = (tiles + n - 1) / n;
  const int lo = w.begin + z * per * kTile;
  const int hi = lo + per * kTile < w.end ? lo + per * kTile : w.end;
  w.begin = lo;
  w.end = hi > lo ? hi : lo;
  return w;
}

// `return fn<T, DH>(args...)` for the storage type `dtype` (0 = float32,
// 1 = bfloat16) at dh's bucket DH
#define DISPATCH(fn, ...)                                                \
  do {                                                                   \
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;     \
    switch (dh_bucket(dh)) {                                             \
      case 64:                                                           \
        return dtype ? fn<__nv_bfloat16, 64>(__VA_ARGS__)                \
                     : fn<float, 64>(__VA_ARGS__);                       \
      case 128:                                                          \
        return dtype ? fn<__nv_bfloat16, 128>(__VA_ARGS__)               \
                     : fn<float, 128>(__VA_ARGS__);                      \
      default:                                                           \
        return dtype ? fn<__nv_bfloat16, 256>(__VA_ARGS__)               \
                     : fn<float, 256>(__VA_ARGS__);                      \
    }                                                                    \
  } while (0)

// The CTA's place: (b, KV head, first query row r0 and rows) from the grid
// (B, KVH · row tiles, n_split), its pair's partials at entry 0 (po, pml;
// `entries` per pair: the n_split CTAs' and, in the fused step, the new
// token's) and its pair's arrival counter.
struct Place {
  int b, kvh, r0, rows, entries;
  long long pair;
  __device__ __forceinline__ Place(int KVH, int g, int extra) {
    b = blockIdx.x;
    const int n_rt = gridDim.y / KVH;
    kvh = blockIdx.y / n_rt;
    r0 = (blockIdx.y % n_rt) * kRows;
    rows = g - r0 < kRows ? g - r0 : kRows;
    entries = gridDim.z + extra;
    pair = (long long)b * KVH + kvh;
  }
  __device__ __forceinline__ float* po(float* part, int g, int dh) const {
    return part + (pair * entries * g + r0) * dh;
  }
  __device__ __forceinline__ float* pml(float* part, int KVH, int g,
                                        int dh) const {
    return part + (long long)gridDim.x * KVH * entries * g * dh
           + (pair * entries * g + r0) * 2;
  }
  __device__ __forceinline__ int* counter(int* arrived) const {
    return arrived + (long long)b * gridDim.y + blockIdx.y;
  }
};

// The four warps' partials of `rows` query heads, each a 16-row mma tile
// (o: rows lane/4 and lane/4 + 8, columns 2 (lane%4) and +1 of every
// 8-column tile; m in score units; l this lane's part of the row sum),
// merged into the CTA's partial: po (rows × dh), pml (rows × 2: m in log2
// units, l).  The warps' rings are done; their shared memory is reused.
template <int DH>
__device__ __forceinline__ void merge_warps(const float (&o)[DH / 8][4],
                                            const float (&m)[2], float l0,
                                            float l1, int rows, int dh,
                                            float sl2, float* po, float* pml,
                                            char* smem) {
  constexpr int kDT = DH / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float l[2] = {l0, l1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();
  float* ow = reinterpret_cast<float*>(smem);        // [warp][row][DH]
  float* mw = ow + kMmaWarps * kRows * DH;           // [warp][row]
  float* lw = mw + kMmaWarps * kRows;                // [warp][row]
  float* ww = lw + kMmaWarps * kRows;                // [row][warp] weights
  const int r_lo = lane >> 2, c_lo = 2 * (lane & 3);
  float* myo = ow + warp * kRows * DH;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    *reinterpret_cast<float2*>(myo + r_lo * DH + j * 8 + c_lo) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(myo + (r_lo + 8) * DH + j * 8 + c_lo) =
        make_float2(o[j][2], o[j][3]);
  }
  if ((lane & 3) == 0) {
    mw[warp * kRows + r_lo] = m[0];
    mw[warp * kRows + r_lo + 8] = m[1];
    lw[warp * kRows + r_lo] = l[0];
    lw[warp * kRows + r_lo + 8] = l[1];
  }
  __syncthreads();
  // per row the largest m of the warps that saw a valid token, and each
  // warp's weight against it
  if (tid < kRows) {
    float M = kNegInf;
    for (int w = 0; w < kMmaWarps; ++w)
      if (lw[w * kRows + tid] > 0.f) M = fmaxf(M, mw[w * kRows + tid]);
    float L = 0.f;
    for (int w = 0; w < kMmaWarps; ++w) {
      const float lv = lw[w * kRows + tid];
      const float x = lv > 0.f ? exp2f((mw[w * kRows + tid] - M) * sl2) : 0.f;
      ww[tid * kMmaWarps + w] = x;
      L = fmaf(x, lv, L);
    }
    if (tid < rows) {
      pml[2 * tid] = M * sl2;
      pml[2 * tid + 1] = L;
    }
  }
  __syncthreads();
  for (int x = tid; x < rows * dh; x += kMmaThreads) {
    const int r = x / dh, c = x % dh;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w)
      acc = fmaf(ww[r * kMmaWarps + w], ow[(w * kRows + r) * DH + c], acc);
    po[x] = acc;
  }
}

// ------------------------------------------------------------ bf16 walk
// Issue one warp's cp.async loads of the 16-key K and V tile at t0 into
// the stage at `dst` (K, then V kKeys·DH·2 bytes on): masked rows and
// columns past dh are zero-filled and read nothing.  Returns the tile's
// validity mask (bit j: token t0 + j); 0 issues nothing.
template <int DH, typename Walk>
__device__ __forceinline__ uint32_t load_kv(uint32_t dst, const Walk& walk,
                                            int t0,
                                            const __nv_bfloat16* kbase,
                                            const __nv_bfloat16* vbase,
                                            int dh, long long row_stride) {
  constexpr int kChunks = DH / 8;    // 16-byte chunks of a row
  constexpr uint32_t kTileBytes = kKeys * DH * 2;
  const int lane = threadIdx.x & 31;
  const long long r = lane < kKeys ? walk.row(t0 + lane) : -1;
  const uint32_t valid = __ballot_sync(0xffffffffu, r >= 0);
  if (!valid) return 0;
#pragma unroll
  for (int it = 0; it < kKeys * kChunks / 32; ++it) {
    const int i = lane + 32 * it;
    const int j = i / kChunks, c = i % kChunks;
    const long long rj = __shfl_sync(0xffffffffu, r, j);
    const bool ok = rj >= 0 && c * 8 < dh;
    const long long off = ok ? rj * row_stride + c * 8 : 0;
    cp_async16(dst + swz<DH>(j, c), kbase + off, ok ? 16 : 0);
    cp_async16(dst + kTileBytes + swz<DH>(j, c), vbase + off, ok ? 16 : 0);
  }
  return valid;
}

// The bf16 walk of `rows` (<= kRows) query heads q (rows × dh) over the
// CTA's share; writes the CTA's partial rows to po (rows × dh) and pml
// (rows × 2: m in log2 units, l).  sl2 = scale · log2 e.
template <int DH, typename Walk>
__device__ __forceinline__ void attend_mma(const Walk& walk,
                                           const __nv_bfloat16* q,
                                           const __nv_bfloat16* kbase,
                                           const __nv_bfloat16* vbase,
                                           int rows, int dh,
                                           long long row_stride, float sl2,
                                           float* po, float* pml,
                                           char* smem) {
  constexpr int kChunks = DH / 8;
  constexpr uint32_t kTileBytes = kKeys * DH * 2;
  constexpr int kDT = DH / 8;        // 8-column tiles of the output
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t s_q = smem_addr(smem);
  // this warp's ring: stage st holds K at 2·st·kTileBytes, then V
  const uint32_t ring = s_q + kRows * DH * 2 + warp * 4 * kTileBytes;

  for (int i = tid; i < kRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < rows && c * 8 < dh;
    cp_async16(s_q + swz<DH>(r, c), ok ? q + (long long)r * dh + c * 8 : q,
               ok ? 16 : 0);
  }
  cp_async_commit();
  // the warp's first K/V tile in flight with Q
  const int n_tiles = walk.end > walk.begin
                          ? (walk.end - walk.begin + kKeys - 1) / kKeys : 0;
  int st = 0;
  uint32_t cur = 0;
  if (warp < n_tiles)
    cur = load_kv<DH>(ring, walk, walk.begin + warp * kKeys, kbase, vbase, dh,
                      row_stride);
  cp_async_commit();
  cp_async_wait_1();                 // Q
  __syncthreads();

  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int c_lo = 2 * (lane & 3);
  for (int i = warp; i < n_tiles; i += kMmaWarps) {
    const int in = i + kMmaWarps;
    const uint32_t nxt =
        in < n_tiles ? load_kv<DH>(ring + (st ^ 1) * 2 * kTileBytes, walk,
                                   walk.begin + in * kKeys, kbase, vbase, dh,
                                   row_stride)
                     : 0u;
    cp_async_commit();
    cp_async_wait_1();
    __syncwarp();
    if (cur) {
      const uint32_t s_k = ring + st * 2 * kTileBytes;
      const uint32_t s_v = s_k + kTileBytes;
      // S = Q·Kᵀ: 16 query rows × 16 keys (two 8-key tiles)
      float sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4], bb[4];
        ldsm_x4(a, s_q + swz<DH>(lane & 15, 2 * kk + (lane >> 4)));
        ldsm_x4(bb, s_k + swz<DH>((lane & 7) + ((lane >> 4) << 3),
                                  2 * kk + ((lane >> 3) & 1)));
        mma16816(sc[0], a, bb[0], bb[1]);
        mma16816(sc[1], a, bb[2], bb[3]);
      }
      // online softmax on rows lane/4 (i = 0) and lane/4 + 8 (i = 1),
      // reduced over the quad that shares them; masked keys get p = 0
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!((cur >> (n * 8 + c_lo + (e & 1))) & 1u)) sc[n][e] = kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        }
      float corr[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f((m[r] - mx[r]) * sl2);
        m[r] = mx[r];
        mc[r] = mx[r] * sl2;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (cur >> (n * 8 + c_lo + (e & 1))) & 1u;
          const float p = ok ? exp2f(fmaf(sc[n][e], sl2, -mc[e >> 1])) : 0.f;
          sc[n][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
      // O += P·V: P rounded to bf16 in registers is the A fragment
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                              pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]),
                              pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int j = 0; j < kDT; j += 2) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
        o[j + 1][0] *= corr[0];
        o[j + 1][1] *= corr[0];
        o[j + 1][2] *= corr[1];
        o[j + 1][3] *= corr[1];
        uint32_t bb[4];
        ldsm_x4_trans(bb, s_v + swz<DH>(lane & 15, j + (lane >> 4)));
        mma16816(o[j], pa, bb[0], bb[1]);
        mma16816(o[j + 1], pa, bb[2], bb[3]);
      }
    }
    __syncwarp();                    // stage st is refilled next iteration
    st ^= 1;
    cur = nxt;
  }
  cp_async_wait_all();
  merge_warps<DH>(o, m, l[0], l[1], rows, dh, sl2, po, pml, smem);
}

// ------------------------------------------------------------ fp32 walk
// Issue one warp's cp.async loads of the 8-key fp32 K and V tile at t0
// into the stage at `dst` (K rows of ld_qk(DH) floats, then V rows of
// ld_v(DH)): masked rows and columns past dh are zero-filled and read
// nothing.  Returns the tile's validity mask (bit j: token t0 + j); 0
// issues nothing.
template <int DH, typename Walk>
__device__ __forceinline__ uint32_t load_kv_f32(float* dst, const Walk& walk,
                                                int t0, const float* kbase,
                                                const float* vbase, int dh,
                                                long long row_stride) {
  constexpr int kChunks = DH / 4;    // 16-byte chunks of a row
  const int lane = threadIdx.x & 31;
  const long long r = lane < kKeysF ? walk.row(t0 + lane) : -1;
  const uint32_t valid = __ballot_sync(0xffffffffu, r >= 0);
  if (!valid) return 0;
  float* vdst = dst + kKeysF * ld_qk(DH);
#pragma unroll
  for (int it = 0; it < kKeysF * kChunks / 32; ++it) {
    const int i = lane + 32 * it;
    const int j = i / kChunks, c = i % kChunks;
    const long long rj = __shfl_sync(0xffffffffu, r, j);
    const bool ok = rj >= 0 && c * 4 < dh;
    const long long off = ok ? rj * row_stride + c * 4 : 0;
    cp_async16(smem_addr(dst + j * ld_qk(DH) + c * 4), kbase + off,
               ok ? 16 : 0);
    cp_async16(smem_addr(vdst + j * ld_v(DH) + c * 4), vbase + off,
               ok ? 16 : 0);
  }
  return valid;
}

// The fp32 walk of `rows` (<= kRows) query heads q (rows × dh) over the
// CTA's share, as 3xTF32 (see the header); writes the CTA's partial rows
// to po (rows × dh) and pml (rows × 2: m in log2 units, l).  sl2 = scale ·
// log2 e.  Thread (warp, lane; g = lane/4, t = lane%4) holds rows g and
// g + 8 of every accumulator tile, columns 2t and 2t + 1; in every 8-deep
// k-step its k columns are 2t (the mma's k = t) and 2t + 1 (k = t + 4).
template <int DH, typename Walk>
__device__ __forceinline__ void attend_tf32(const Walk& walk, const float* q,
                                            const float* kbase,
                                            const float* vbase, int rows,
                                            int dh, long long row_stride,
                                            float sl2, float* po, float* pml,
                                            char* smem) {
  constexpr int kChunks = DH / 4;
  constexpr int kLQ = ld_qk(DH), kLV = ld_v(DH);
  constexpr int kStage = kKeysF * (kLQ + kLV);   // floats: K, then V
  constexpr int kDT = DH / 8;        // Q·Kᵀ k-steps, 8-column output tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* q_s = reinterpret_cast<float*>(smem);
  float* ring = q_s + kRows * kLQ + warp * kStagesF * kStage;   // this warp's

  for (int i = tid; i < kRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < rows && c * 4 < dh;
    cp_async16(smem_addr(q_s + r * kLQ + c * 4),
               ok ? q + (long long)r * dh + c * 4 : q, ok ? 16 : 0);
  }
  cp_async_commit();
  // the warp's first two K/V tiles in flight with Q (one group each)
  const int n_tiles = walk.end > walk.begin
                          ? (walk.end - walk.begin + kKeysF - 1) / kKeysF : 0;
  uint32_t cur = 0, next = 0;
  if (warp < n_tiles)
    cur = load_kv_f32<DH>(ring, walk, walk.begin + warp * kKeysF, kbase,
                          vbase, dh, row_stride);
  cp_async_commit();
  if (warp + kMmaWarps < n_tiles)
    next = load_kv_f32<DH>(ring + kStage, walk,
                           walk.begin + (warp + kMmaWarps) * kKeysF, kbase,
                           vbase, dh, row_stride);
  cp_async_commit();
  cp_async_wait<2>();                // Q
  __syncthreads();

  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // this thread's fragments: Q rows g (and g + 8) and K row g at columns
  // 2t of each 8-column step; V rows 2t (and 2t + 1) at column g
  const float* qa = q_s + g * kLQ + 2 * t;
  int st = 0;
  for (int i = warp; i < n_tiles; i += kMmaWarps) {
    // the tile two ahead into the stage the last tile used
    const int in = i + 2 * kMmaWarps;
    const int s2 = st == 0 ? kStagesF - 1 : st - 1;
    const uint32_t after =
        in < n_tiles ? load_kv_f32<DH>(ring + s2 * kStage, walk,
                                       walk.begin + in * kKeysF, kbase, vbase,
                                       dh, row_stride)
                     : 0u;
    cp_async_commit();
    cp_async_wait<2>();              // this tile's group has landed
    __syncwarp();
    if (cur) {
      const float* kf = ring + st * kStage + g * kLQ + 2 * t;
      const float* vf = ring + st * kStage + kKeysF * kLQ + 2 * t * kLV + g;
      // S = Q·Kᵀ: 16 query rows × 8 keys; big·big and the two small terms
      // in separate accumulators, each as four (k-steps mod 4: short mma
      // chains, as one warp is all its scheduler has at dh 256)
      float s_bb[4][4], s_sm[4][4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_bb[h][e] = s_sm[h][e] = 0.f;
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
        const float2 y = *reinterpret_cast<const float2*>(kf + kk * 8);
        uint32_t b_big0, b_small0, b_big1, b_small1;
        split_tf32(y.x, b_big0, b_small0);
        split_tf32(y.y, b_big1, b_small1);
        mma1688_tf32(s_sm[kk & 3], a_small, b_big0, b_big1);
        mma1688_tf32(s_sm[kk & 3], a_big, b_small0, b_small1);
        mma1688_tf32(s_bb[kk & 3], a_big, b_big0, b_big1);
      }
      // online softmax on rows g (i = 0) and g + 8 (i = 1), reduced over
      // the quad that shares them; masked keys get p = 0
      float sc[4], mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[e] = ((s_bb[0][e] + s_bb[1][e]) + (s_bb[2][e] + s_bb[3][e]))
                + ((s_sm[0][e] + s_sm[1][e]) + (s_sm[2][e] + s_sm[3][e]));
        if (!((cur >> (2 * t + (e & 1))) & 1u)) sc[e] = kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[e]);
      }
      float corr[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f((m[r] - mx[r]) * sl2);
        m[r] = mx[r];
        mc[r] = mx[r] * sl2;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (cur >> (2 * t + (e & 1))) & 1u;
        const float p = ok ? exp2f(fmaf(sc[e], sl2, -mc[e >> 1])) : 0.f;
        sc[e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
      // O = O·corr + P·V: the score accumulator (g, 2t), (g, 2t+1),
      // (g+8, 2t), (g+8, 2t+1) is P's A fragment (g, k t), (g, k t+4),
      // (g+8, k t), (g+8, k t+4) in the permuted k
      uint32_t p_big[4], p_small[4];
      split_tf32(sc[0], p_big[0], p_small[0]);
      split_tf32(sc[2], p_big[1], p_small[1]);
      split_tf32(sc[1], p_big[2], p_small[2]);
      split_tf32(sc[3], p_big[3], p_small[3]);
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        uint32_t b_big0, b_small0, b_big1, b_small1;
        split_tf32(vf[j * 8], b_big0, b_small0);
        split_tf32(vf[kLV + j * 8], b_big1, b_small1);
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        mma1688_tf32(pv, p_small, b_big0, b_big1);
        mma1688_tf32(pv, p_big, b_small0, b_small1);
        mma1688_tf32(pv, p_big, b_big0, b_big1);
        o[j][0] = fmaf(o[j][0], corr[0], pv[0]);
        o[j][1] = fmaf(o[j][1], corr[0], pv[1]);
        o[j][2] = fmaf(o[j][2], corr[1], pv[2]);
        o[j][3] = fmaf(o[j][3], corr[1], pv[3]);
      }
    }
    __syncwarp();                    // stage st is refilled next iteration
    st = st == kStagesF - 1 ? 0 : st + 1;
    cur = next;
    next = after;
  }
  cp_async_wait_all();
  merge_warps<DH>(o, m, l[0], l[1], rows, dh, sl2, po, pml, smem);
}

// ------------------------------------------------------------ both
// This CTA's share of the walk for `rows` query heads q (rows × dh),
// written as its partial: po (rows × dh, unnormalised), pml (rows × 2: m
// in log2 units, l).  DH: the head-dim bucket; T picks the walk.
template <typename T, int DH, typename Walk>
__device__ __forceinline__ void walk_share(const Walk& walk, const T* q,
                                           const T* kbase, const T* vbase,
                                           int rows, int dh,
                                           long long row_stride, float scale,
                                           float* po, float* pml,
                                           void* smem) {
  if constexpr (sizeof(T) == 4)
    attend_tf32<DH>(walk, q, kbase, vbase, rows, dh, row_stride,
                    scale * kLog2e, po, pml, static_cast<char*>(smem));
  else
    attend_mma<DH>(walk, q, kbase, vbase, rows, dh, row_stride,
                   scale * kLog2e, po, pml, static_cast<char*>(smem));
}

// The uniform mean of V over every entry t < n_all, valid or not, into
// the `rows` output rows (out points at the first): what the plain
// version's softmax over an all-masked row gives.
template <typename T, typename Walk>
__device__ __forceinline__ void uniform_mean(const Walk& walk, T* out,
                                             const T* vbase, int rows, int dh,
                                             long long row_stride) {
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float sum = 0.f;
    for (int t = 0; t < walk.n_all; ++t)
      sum += to_f(vbase[walk.any_row(t) * row_stride + d]);
    const float mean = sum / (float)walk.n_all;
    for (int r = 0; r < rows; ++r) out[(long long)r * dh + d] = from_f<T>(mean);
  }
}

// Count this CTA's arrival at its pair's counter (after its partial is
// written); true in the last of the n CTAs to arrive, which then sees
// every partial.
__device__ __forceinline__ bool last_to_arrive(int* counter, int n) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == n - 1;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  return true;
}

// The fused step's new token as one more partial of its pair: rows
// scores q·kn (m, log2 units), l = 1, and acc = vn in every row; by the CTA
// that appends it.  The token is always attended (distance 0).
template <typename T>
__device__ __forceinline__ void new_token_partial(const T* q, const T* kn,
                                                  const T* vn, int rows,
                                                  int dh, float sl2,
                                                  float* po, float* pml) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    float d = 0.f;
    for (int c = lane; c < dh; c += 32)
      d = fmaf(to_f(q[(long long)r * dh + c]), to_f(kn[c]), d);
    d = warp_sum(d);
    if (lane == 0) {
      pml[2 * r] = d * sl2;
      pml[2 * r + 1] = 1.f;
    }
  }
  for (int i = threadIdx.x; i < rows * dh; i += blockDim.x)
    po[i] = to_f(vn[i % dh]);
}

// In the last CTA of a pair to arrive: merge the pair's n partials of
// `rows` query heads (po, pml at entry 0 and row r0 of the pair; an entry
// is g·dh and g·2 floats on), normalise into out (rows × dh), and reset
// the counter to 0 for the next call (n_arrive CTAs arrive at it).  A pair
// with no valid token gives the uniform mean.  Every (m, l) is read in one
// pass; the partials come in by bulk copies of the Tensor Memory
// Accelerator (one per entry, all in flight together), in batches of as
// many entries as the CTA's dynamic shared memory holds (at least
// merge_smem_bytes(rows, n, dh)), every thread on the output elements.
// One SM reads them all (up to 160 KB at the serving shapes), which sets
// the merge's time.
template <typename T, typename Walk>
__device__ __forceinline__ void merge_pair(int* counter, int n_arrive,
                                           const float* po, const float* pml,
                                           int n, int g, int rows, int dh,
                                           const Walk& walk, const T* vbase,
                                           long long row_stride, T* out,
                                           float* smem) {
  if (!last_to_arrive(counter, n_arrive)) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x;
  const long long so = (long long)g * dh, sm = 2LL * g;   // entry strides
  const int part = rows * dh;                               // one entry
  float* ml = smem;                  // [entry][row][m, l]
  float* wts = ml + 2 * rows * n;    // [row][entry]
  float* inv = wts + rows * n;       // 1 / the denominator (0: none)
  float* acc = smem + merge_head_floats(rows, n);           // rows × dh
  float* stage = acc + part;
  uint32_t smem_bytes;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(smem_bytes));
  const int fit = (int)((smem_bytes / sizeof(float)
                         - (uint32_t)(stage - smem)) / part);
  const int batch = fit < 1 ? 1 : fit < n ? fit : n;   // >= 1 by launch_smem

  // the partials come in by bulk copies (thread 0), a batch at a time,
  // the first one while the weights are worked out
  __shared__ alignas(8) uint64_t bar_word;
  const uint32_t bar = smem_addr(&bar_word);
  const uint32_t s_stage = smem_addr(stage);
  auto issue = [&](int z0) {         // by thread 0
    const int nz = n - z0 < batch ? n - z0 : batch;
    proxy_fence();
    mbar_expect_tx(bar, (uint32_t)(nz * part * sizeof(float)));
    for (int zz = 0; zz < nz; ++zz)
      bulk_copy(s_stage + zz * part * sizeof(float), po + (z0 + zz) * so,
                part * sizeof(float), bar);
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    issue(0);
  }
  for (int i = tid; i < 2 * rows * n; i += nt)
    ml[i] = __ldcg(pml + (i / (2 * rows)) * sm + i % (2 * rows));
  __syncthreads();
  // per row, a warp: the largest m of the entries with a valid token and
  // each entry's weight against it
  for (int r = warp; r < rows; r += nt >> 5) {
    float M = kNegInf;
    for (int z = lane; z < n; z += 32)
      if (ml[(z * rows + r) * 2 + 1] > 0.f)
        M = fmaxf(M, ml[(z * rows + r) * 2]);
    M = warp_max(M);
    float den = 0.f;
    for (int z = lane; z < n; z += 32) {
      const float lz = ml[(z * rows + r) * 2 + 1];
      const float w = lz > 0.f ? exp2f(ml[(z * rows + r) * 2] - M) : 0.f;
      wts[r * n + z] = w;
      den = fmaf(w, lz, den);
    }
    den = warp_sum(den);
    if (lane == 0) inv[r] = den > 0.f ? 1.f / den : 0.f;
  }
  __syncthreads();
  if (inv[0] == 0.f) {               // validity is shared by the rows
    mbar_wait(bar, 0);
    uniform_mean<T>(walk, out, vbase, rows, dh, row_stride);
  } else {
    for (int z0 = 0, phase = 0; z0 < n; z0 += batch, phase ^= 1) {
      mbar_wait(bar, phase);
      const int nz = n - z0 < batch ? n - z0 : batch;
      for (int x = tid; x < part / 4; x += nt) {
        const float* w = wts + (4 * x / dh) * n + z0;
        float4 a = z0 ? reinterpret_cast<float4*>(acc)[x]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        for (int zz = 0; zz < nz; ++zz) {
          const float4 v =
              reinterpret_cast<const float4*>(stage)[zz * (part / 4) + x];
          a.x = fmaf(w[zz], v.x, a.x);
          a.y = fmaf(w[zz], v.y, a.y);
          a.z = fmaf(w[zz], v.z, a.z);
          a.w = fmaf(w[zz], v.w, a.w);
        }
        reinterpret_cast<float4*>(acc)[x] = a;
      }
      __syncthreads();               // the stage is refilled next
      if (z0 + batch < n && tid == 0) issue(z0 + batch);
    }
    for (int x = tid; x < part; x += nt)
      out[x] = from_f<T>(acc[x] * inv[x / dh]);
  }
  if (tid == 0) *counter = 0;        // ready for the next call
}

}  // namespace
