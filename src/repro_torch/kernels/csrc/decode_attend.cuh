// One query token per query head against a stored K/V sequence: the
// tile walk and online softmax shared by the decode kernels
// (paged_decode_step.cu: the fused step and the read-only paged form;
// decode_attention.cu: the ring cache).
//
// A CTA of kThreads threads owns one (slot, KV head) and its g query heads,
// so each K/V row is read from device memory once and used by all g heads.
// It walks token indices [walk.begin, walk.end) in tiles of kTile (one
// warp's lanes).  A `Walk` maps token index t to the row of the K/V array
// that stores it, or -1 when t is masked:
//   long long row(int t) const;      // masked: -1
//   long long any_row(int t) const;  // every t < n_all, masked or not
//   int begin, end, n_all;
// Each thread loads its share of a tile as 16-byte vectors into registers,
// and the loads of tile t+1 are issued before tile t is computed.  Masked
// tokens are never loaded and their probabilities are 0 (not garbage times
// 0), so NaN or Inf garbage in a masked row cannot reach the accumulator;
// a tile with no valid token is skipped.  Scores and the softmax are fp32.
//
// The read-only kernels split the walk over n CTAs per (slot, KV head)
// (split_walk), as flash-decoding does: with few slots, one CTA each would
// leave most of the 132 SMs idle.  Each CTA writes its unnormalised
// partial (acc, m, l); a combine kernel merges the n partials (combine).
#pragma once
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // tokens per tile == warp size
constexpr int kMaxVec = 8;           // 16-byte vectors per thread per tile
constexpr float kNegInf = -1e30f;    // finite sentinel, as the TPU kernels

// dynamic shared memory of one CTA, in floats
inline size_t attend_smem_floats(int g, int dh) {
  return (size_t)kTile * (dh + 4) + (size_t)kTile * dh + 2 * (size_t)g * dh
         + (size_t)g * kTile + 3 * (size_t)g;
}

// How many CTAs share one (slot, KV head)'s walk in the read-only kernels:
// enough for `pairs` such pairs to put two CTAs on every SM of `device`.
// n_tokens is the longest walk a pair can have (a paged slot's walk ends at
// its lens, so its later shares may be empty); a walk that long leaves no
// share empty.  Returns n >= 1, or -cudaError_t when the device is unknown.
inline int split_count(int pairs, int n_tokens, int device) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  const int tiles = n_tokens > kTile ? (n_tokens + kTile - 1) / kTile : 1;
  const int p = pairs > 1 ? pairs : 1;
  int want = (2 * sms + p - 1) / p;
  want = want < tiles ? want : tiles;
  want = want > 1 ? want : 1;
  const int per = (tiles + want - 1) / want;
  return (tiles + per - 1) / per;
}

// dh is a multiple of 8 whose K (or V) tile fits the register budget
template <typename T>
inline bool attend_dh_ok(int dh) {
  constexpr int kVec = 16 / sizeof(T);
  return dh > 0 && dh % 8 == 0 && kTile * (dh / kVec) <= kMaxVec * kThreads;
}

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

// The uniform mean of V over every entry t < n_all, valid or not, into
// the g output rows (out points at the first): what the plain version's
// softmax over an all-masked row gives.
template <typename T, typename Walk>
__device__ __forceinline__ void uniform_mean(const Walk& walk, T* out,
                                             const T* vbase, int g, int dh,
                                             long long row_stride) {
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float sum = 0.f;
    for (int t = 0; t < walk.n_all; ++t)
      sum += to_f(vbase[walk.any_row(t) * row_stride + d]);
    const float mean = sum / (float)walk.n_all;
    for (int gi = 0; gi < g; ++gi) out[(long long)gi * dh + d] = from_f<T>(mean);
  }
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

// This CTA's partial: g blocks of (dh + 2) floats, acc then m and l.
__device__ __forceinline__ void write_partial(const Smem& s, float* part,
                                              int g, int dh) {
  for (int i = threadIdx.x; i < g * dh; i += kThreads)
    part[(i / dh) * (dh + 2) + i % dh] = s.acc[i];
  for (int gi = threadIdx.x; gi < g; gi += kThreads) {
    part[gi * (dh + 2) + dh] = s.m[gi];
    part[gi * (dh + 2) + dh + 1] = s.l[gi];
  }
}

// Merge the n partials of one (slot, KV head) (part: n blocks of g·(dh+2)
// floats) into its g normalised output rows.  A split with no valid token
// has l == 0 and weighs nothing; when no split has one (validity is
// shared by the g heads, so head 0 tells), the rows are the uniform mean.
template <typename T, typename Walk>
__device__ __forceinline__ void combine(const float* part, int n,
                                        const Walk& walk, T* out,
                                        const T* vbase, int g, int dh,
                                        long long row_stride) {
  const int stride = g * (dh + 2);
  bool any = false;
  for (int z = 0; z < n; ++z) any |= part[z * stride + dh + 1] > 0.f;
  if (!any) {
    uniform_mean<T>(walk, out, vbase, g, dh, row_stride);
    return;
  }
  for (int i = threadIdx.x; i < g * dh; i += kThreads) {
    const int gi = i / dh, d = i % dh;
    const float* p = part + gi * (dh + 2);
    float m = kNegInf;
    for (int z = 0; z < n; ++z)
      if (p[z * stride + dh + 1] > 0.f) m = fmaxf(m, p[z * stride + dh]);
    float num = 0.f, den = 0.f;
    for (int z = 0; z < n; ++z) {
      const float l = p[z * stride + dh + 1];
      if (l > 0.f) {
        const float w = expf(p[z * stride + dh] - m);
        num = fmaf(w, p[z * stride + d], num);
        den = fmaf(w, l, den);
      }
    }
    out[i] = from_f<T>(num / den);
  }
}

}  // namespace
