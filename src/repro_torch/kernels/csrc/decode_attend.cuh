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
// Two walks, chosen by the storage type (a fixed dispatch, not a
// fallback):
// fp32 `attend`, on the CUDA cores (a tensor-core product in fp32 is TF32,
// which cannot meet 2e-5): 256 threads hold all g query heads, q pre-scaled
// in fp32 shared memory; 32-token K/V tiles are loaded as 16-byte vectors
// into registers one tile ahead and converted to fp32 in shared memory;
// warp w scores heads w, w+8, ... (a lane per token), then every thread
// accumulates P·V.
// bf16 `attend_mma`, on mma.sync.m16n8k16: the CTA's query heads (at most
// kRows = 16: a pair with g > 16 takes ceil(g/16) row tiles, each its own
// CTAs) are the A rows, zero-padded to 16, in swizzled shared memory.  Each
// of the 4 warps walks 16-key tiles of the CTA's share (warp w takes tiles
// w, w+4, ...) on its own: a private 2-stage ring of bf16 K and V tiles
// loaded by cp.async one tile ahead (masked rows and padded head
// dimensions zero-filled with a source size of 0), S = Q·Kᵀ and O += P·V
// on mma with ldmatrix / ldmatrix.trans, the online softmax on the
// accumulator fragments in fp32 with scale·log2 e folded into exp2f (the
// scores are never rounded; only P is rounded to bf16, as the A operand of
// P·V).  No barrier in the loop: the warps meet once at the end, when
// their four partials are merged in shared memory into the CTA's.  Head
// dims are compile-time buckets 64, 128, 256 (any dh, a multiple of 8,
// is zero-padded to the next).
#pragma once
#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // the fp32 walk
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // fp32 tile; the unit of split shares
constexpr int kMaxVec = 8;           // 16-byte vectors per thread per tile
constexpr float kNegInf = -1e30f;    // finite sentinel, as the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMmaWarps = 4;         // the bf16 walk
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kKeys = 16;            // keys of one warp tile
constexpr int kRows = 16;            // query heads of one mma row tile
constexpr int kMaxHeadDim = 256;
// dynamic shared memory a CTA may use, less the static is_last
constexpr size_t kMaxSmem = 232448 - 16;

// DH: 0 for the fp32 walk, else the bf16 head-dim bucket
__host__ __device__ constexpr int walk_threads(int DH) {
  return DH ? kMmaThreads : kThreads;
}
__host__ __device__ constexpr int walk_min_blocks(int DH) {
  return DH == 256 ? 1 : DH ? 3 : 2;
}
inline int dh_bucket(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 128 : 256; }
inline bool decode_dh_ok(int dh) {
  return dh > 0 && dh % 8 == 0 && dh <= kMaxHeadDim;
}

// dynamic shared memory of the fp32 walk, in floats
inline size_t attend_smem_floats(int g, int dh) {
  return (size_t)kTile * (dh + 4) + (size_t)kTile * dh + 2 * (size_t)g * dh
         + (size_t)g * kTile + 3 * (size_t)g;
}

// bytes of the bf16 walk: the Q tile and each warp's 2-stage K/V ring (the
// warps' merge reuses it: kMmaWarps · (kRows·DH + 3·kRows) floats)
__host__ __device__ constexpr size_t mma_smem_bytes(int DH) {
  return (size_t)kRows * DH * 2 + (size_t)kMmaWarps * 4 * kKeys * DH * 2;
}

inline size_t walk_smem_bytes(int DH, int g, int dh) {
  return DH ? mma_smem_bytes(DH) : sizeof(float) * attend_smem_floats(g, dh);
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
inline int cta_rows(int DH, int g) { return DH && g > kRows ? kRows : g; }
inline int row_tiles(int DH, int g) { return DH ? (g + kRows - 1) / kRows : 1; }

// n cut where the merge's shared memory would not fit a CTA's
inline int fit_splits(int rows, int dh, int n) {
  while (n > 1 && merge_smem_bytes(rows, n, dh) > kMaxSmem) --n;
  return n;
}

// The launch's dynamic shared memory, with n_split cut to what the
// merge's shared memory admits (n_split + extra entries a pair).
template <int DH>
size_t launch_smem(int g, int dh, int& n_split, int extra) {
  const int rows = cta_rows(DH, g);
  const int n = fit_splits(rows, dh, n_split + extra);
  n_split = n - extra > 1 ? n - extra : 1;
  const size_t walk = walk_smem_bytes(DH, g, dh);
  const size_t merge = merge_smem_bytes(rows, n_split + extra, dh);
  return walk > merge ? walk : merge;
}

// How many CTAs share one (slot, KV head) walk: enough for `pairs` walks
// (pairs · row tiles CTAs per split) to fill half the CTAs of `kernel`
// that `device`'s SMs hold at once (by its registers, `threads` and
// `smem`): the merge reads every partial in one CTA, and half beat all of
// them at every serving shape on an H100.  n_tokens is the longest walk a
// pair can have (a paged slot's walk ends at its lens, so its later
// shares may be empty); a walk that long leaves no share empty.  Returns
// n >= 1, or -cudaError_t.
template <typename K>
inline int split_count(K* kernel, int threads, size_t smem, int pairs,
                       int n_tokens, int device) {
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
  const int slots = (per_sm > 1 ? per_sm : 1) * sms / 2;
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

// `return fn<T, DH>(args...)` for the storage type `dtype` (0 = float32:
// the fp32 walk, DH 0; 1 = bfloat16: the bf16 walk at dh's bucket)
#define DISPATCH(fn, ...)                                                \
  do {                                                                   \
    if (dtype == 0) return fn<float, 0>(__VA_ARGS__);                    \
    if (dtype != 1) return (int)cudaErrorInvalidValue;                   \
    switch (dh_bucket(dh)) {                                             \
      case 64: return fn<__nv_bfloat16, 64>(__VA_ARGS__);                \
      case 128: return fn<__nv_bfloat16, 128>(__VA_ARGS__);              \
      default: return fn<__nv_bfloat16, 256>(__VA_ARGS__);              \
    }                                                                    \
  } while (0)

// The CTA's place: (b, KV head, first query row r0 and rows) from the grid
// (B, KVH · row tiles, n_split), its pair's partials at entry 0 (po, pml;
// `entries` per pair: the n_split CTAs' and, in the fused step, the new
// token's) and its pair's arrival counter.
struct Place {
  int b, kvh, r0, rows, entries;
  long long pair;
  __device__ __forceinline__ Place(int KVH, int g, bool mma, int extra) {
    b = blockIdx.x;
    const int n_rt = gridDim.y / KVH;
    kvh = blockIdx.y / n_rt;
    r0 = (blockIdx.y % n_rt) * kRows;
    rows = !mma || g - r0 < kRows ? g - r0 : kRows;
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

// ------------------------------------------------------------ fp32 walk
struct Smem {
  float* k;      // kTile * (dh+4): padded rows, conflict-free float4 reads
  float* v;      // kTile * dh
  float* q;      // g * dh, pre-scaled
  float* acc;    // g * dh
  float* p;      // g * kTile
  float* m;      // g
  float* l;      // g
  float* c;      // g: per-tile rescale factors
};

__device__ __forceinline__ Smem carve(float* smem, int g, int dh) {
  Smem s;
  s.k = smem;
  s.v = s.k + kTile * (dh + 4);
  s.q = s.v + kTile * dh;
  s.acc = s.q + g * dh;
  s.p = s.acc + g * dh;
  s.m = s.p + g * kTile;
  s.l = s.m + g;
  s.c = s.l + g;
  return s;
}

// q rows of the CTA's g heads (contiguous, dh each) into shared memory,
// scaled; zero accumulators.  Followed by a barrier inside attend().
template <typename T>
__device__ __forceinline__ void load_q(const Smem& s, const T* q, int g,
                                       int dh, float scale) {
  for (int i = threadIdx.x; i < g * dh; i += kThreads) {
    s.q[i] = to_f(q[i]) * scale;
    s.acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < g; i += kThreads) {
    s.m[i] = kNegInf;
    s.l[i] = 0.f;
  }
}

// Issue this thread's 16-byte loads of the K/V tile at t0 into registers
// (masked tokens: zeros, never loaded).  Returns 1 if any was valid.
template <typename T, typename Walk>
__device__ __forceinline__ int prefetch(uint4 (&rk)[kMaxVec],
                                        uint4 (&rv)[kMaxVec], const T* kbase,
                                        const T* vbase, const Walk& walk,
                                        int t0, int n_vec, int vpr,
                                        long long row_stride) {
  constexpr int kVec = 16 / sizeof(T);
  int any = 0;
#pragma unroll
  for (int v = 0; v < kMaxVec; ++v) {
    const int idx = threadIdx.x + v * kThreads;
    rk[v] = make_uint4(0, 0, 0, 0);
    rv[v] = make_uint4(0, 0, 0, 0);
    if (idx < n_vec) {
      const long long r = walk.row(t0 + idx / vpr);
      if (r >= 0) {
        const long long off = r * row_stride + (idx % vpr) * kVec;
        rk[v] = *reinterpret_cast<const uint4*>(kbase + off);
        rv[v] = *reinterpret_cast<const uint4*>(vbase + off);
        any = 1;
      }
    }
  }
  return any;
}

// Online softmax over the walk; leaves m, l and the unnormalised acc in
// shared memory, visible to every thread on return.
template <typename T, typename Walk>
__device__ __forceinline__ void attend(const Smem& s, const Walk& walk,
                                       const T* kbase, const T* vbase, int g,
                                       int dh, long long row_stride) {
  constexpr int kVec = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kd = dh + 4;
  const int vpr = dh / kVec;         // vectors per token row
  const int n_vec = kTile * vpr;     // vectors per tile (K or V)

  uint4 rk[kMaxVec], rv[kMaxVec];
  int any = 0;
  int t0 = walk.begin;
  if (t0 < walk.end)
    any = prefetch<T>(rk, rv, kbase, vbase, walk, t0, n_vec, vpr, row_stride);
  __syncthreads();
  while (t0 < walk.end) {
    // registers -> shared memory (fp32)
#pragma unroll
    for (int v = 0; v < kMaxVec; ++v) {
      const int idx = tid + v * kThreads;
      if (idx < n_vec) {
        const int j = idx / vpr, c = (idx % vpr) * kVec;
        float f[kVec];
        unpack(rk[v], f, T());
#pragma unroll
        for (int e = 0; e < kVec; e += 4)
          *reinterpret_cast<float4*>(s.k + j * kd + c + e) =
              make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
        unpack(rv[v], f, T());
#pragma unroll
        for (int e = 0; e < kVec; e += 4)
          *reinterpret_cast<float4*>(s.v + j * dh + c + e) =
              make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
    }
    const int tile = t0;
    const int live = __syncthreads_or(any);
    t0 += kTile;
    if (t0 < walk.end)                      // in flight during the math
      any = prefetch<T>(rk, rv, kbase, vbase, walk, t0, n_vec, vpr,
                        row_stride);
    if (!live) continue;                    // whole tile masked

    // scores: warp w takes heads w, w+kWarps, ...; lane j takes token j
    const bool ok = walk.row(tile + lane) >= 0;
    for (int gi = warp; gi < g; gi += kWarps) {
      const float4* qr = reinterpret_cast<const float4*>(s.q + gi * dh);
      const float4* kr = reinterpret_cast<const float4*>(s.k + lane * kd);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;   // 4 FMA chains
      for (int d = 0; d < dh / 4; ++d) {
        const float4 a = qr[d], c = kr[d];
        s0 = fmaf(a.x, c.x, s0);
        s1 = fmaf(a.y, c.y, s1);
        s2 = fmaf(a.z, c.z, s2);
        s3 = fmaf(a.w, c.w, s3);
      }
      const float sc = (s0 + s1) + (s2 + s3);
      const float m_old = s.m[gi];
      const float m_new = fmaxf(m_old, warp_max(ok ? sc : kNegInf));
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float tot = warp_sum(p);
      s.p[gi * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s.c[gi] = corr;
        s.l[gi] = s.l[gi] * corr + tot;
        s.m[gi] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * dh; i += kThreads) {
      const int gi = i / dh, d = i % dh;
      const float* pr = s.p + gi * kTile;
      float a = s.acc[i] * s.c[gi];
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) a = fmaf(pr[j], s.v[j * dh + d], a);
      s.acc[i] = a;
    }
    __syncthreads();
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // the four warps' partials into shared memory (the rings are done) ...
  __syncthreads();
  float* ow = reinterpret_cast<float*>(smem);        // [warp][row][DH]
  float* mw = ow + kMmaWarps * kRows * DH;           // [warp][row]
  float* lw = mw + kMmaWarps * kRows;                // [warp][row]
  float* ww = lw + kMmaWarps * kRows;                // [row][warp] weights
  const int r_lo = lane >> 2;
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
  // ... merged into the CTA's partial: per row the largest m of the warps
  // that saw a valid token, and each warp's weight against it
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

// ------------------------------------------------------------ both
// This CTA's share of the walk for `rows` query heads q (rows × dh),
// written as its partial: po (rows × dh, unnormalised), pml (rows × 2: m
// in log2 units, l).  DH: 0 for the fp32 walk, else the bf16 bucket.
template <typename T, int DH, typename Walk>
__device__ __forceinline__ void walk_share(const Walk& walk, const T* q,
                                           const T* kbase, const T* vbase,
                                           int rows, int dh,
                                           long long row_stride, float scale,
                                           float* po, float* pml,
                                           void* smem) {
  if constexpr (DH == 0) {
    const Smem s = carve(static_cast<float*>(smem), rows, dh);
    load_q(s, q, rows, dh, scale);
    attend<T>(s, walk, kbase, vbase, rows, dh, row_stride);
    for (int i = threadIdx.x; i < rows * dh; i += kThreads) po[i] = s.acc[i];
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      pml[2 * r] = s.m[r] * kLog2e;
      pml[2 * r + 1] = s.l[r];
    }
  } else {
    attend_mma<DH>(walk, q, kbase, vbase, rows, dh, row_stride,
                   scale * kLog2e, po, pml, static_cast<char*>(smem));
  }
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
