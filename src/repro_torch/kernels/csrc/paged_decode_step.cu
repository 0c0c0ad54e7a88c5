// Fused paged decode step for Hopper (sm_90a): append the new token's K/V
// into its page, then attend over the slot's stored tokens plus the new
// token, in one launch.
//
// Replaces the TPU kernel `paged_decode_step` (src/repro/kernels/
// paged_attention.py, body `_step_kernel`).  Layouts are the JAX package's:
//   q (B,H,dh); k_new/v_new (B,KVH,dh); k/v pools (P,ps,KVH,dh), the last
//   page P-1 is the trash page; table (B,MP) int32 (-1 = unallocated);
//   lens (B,) int32 token counts INCLUDING the new token; out (B,H,dh).
//   dh is a multiple of 8 and at most 256.
//
// What bounds it on the H100: bytes.  Each (slot, KV head) reads
// lens-1 stored K and V rows of dh elements and does 4·g·dh flops per row
// (g = H/KVH query heads), far below the ~295 flop/byte ridge, so the
// floor is the K/V bytes over 3.35 TB/s.
//
// Design: one CTA of 256 threads per (slot b, KV head h) holds the g query
// heads of that KV head, so each K/V row is read from device memory once
// and used by all g heads.  The CTA walks the slot's page table itself,
// 32 tokens per tile (one warp's lanes), bounded by lens[b] rather than by
// the table's full width as the TPU grid was.  Each thread loads its share
// of a tile as 16-byte vectors into registers, and the loads of tile t+1
// are issued before tile t is computed, so memory latency overlaps the
// math.  A tile whose pages are all unallocated is skipped.  Scores and the
// online softmax are fp32; storage is fp32 or bf16.  Masked tokens are
// never loaded and their probabilities are 0 (not garbage times 0), so
// NaN or Inf garbage in the trash page cannot reach the accumulator.  The
// new token is merged analytically at the end from the operand, as the
// TPU kernel does.  Still a simple kernel: no TMA, no wgmma, and no split
// over the sequence, so with few slots most SMs stay idle.
//
// Trash page race: every FREE slot (table row all -1) appends to the trash
// page, possibly at the same row, from different CTAs in no order.  That
// is harmless only because the trash page is never read unmasked: table
// entries are -1 there, and the walk skips those tokens.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // tokens per tile == warp size
constexpr int kMaxVec = 8;           // 16-byte vectors per thread per tile
constexpr float kNegInf = -1e30f;    // finite sentinel, as the TPU kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// a 16-byte vector of T as floats: 4 for float, 8 for bf16
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Walk {                        // the slot's view of the page table
  const int* row;                    // table row of slot b
  int ps, n_stored, n1, window;
  // pool row (page*ps + offset) of stored token t, or -1 when masked
  __device__ __forceinline__ int pool_row(int t) const {
    if (t >= n_stored) return -1;
    if (window > 0 && n1 - t >= window) return -1;
    const int pg = row[t / ps];
    return pg >= 0 ? pg * ps + t % ps : -1;
  }
};

// Issue this thread's 16-byte loads of the K/V tile at t0 into registers
// (masked tokens: zeros, never loaded).  Returns 1 if any was valid.
template <typename T>
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
      const int pr = walk.pool_row(t0 + idx / vpr);
      if (pr >= 0) {
        const long long off = (long long)pr * row_stride + (idx % vpr) * kVec;
        rk[v] = *reinterpret_cast<const uint4*>(kbase + off);
        rv[v] = *reinterpret_cast<const uint4*>(vbase + off);
        any = 1;
      }
    }
  }
  return any;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_step_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                         const T* __restrict__ v_new, T* k_pages, T* v_pages,
                         const int* __restrict__ table,
                         const int* __restrict__ lens, T* __restrict__ out,
                         int H, int KVH, int dh, int P, int ps, int MP,
                         int window, float scale) {
  constexpr int kVec = 16 / sizeof(T);           // elements per vector
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kd = dh + 4;             // padded K row: conflict-free float4
  const int vpr = dh / kVec;         // vectors per token row
  const int n_vec = kTile * vpr;     // vectors per tile (K or V)

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* k_s = smem;                 // kTile*kd
  float* v_s = k_s + kTile * kd;     // kTile*dh
  float* q_s = v_s + kTile * dh;     // g*dh, pre-scaled
  float* acc_s = q_s + g * dh;       // g*dh
  float* p_s = acc_s + g * dh;       // g*kTile
  float* m_s = p_s + g * kTile;      // g
  float* l_s = m_s + g;              // g
  float* c_s = l_s + g;              // g: per-tile rescale factors

  const int n = lens[b];
  const int n1 = n - 1 > 0 ? n - 1 : 0;   // stored tokens; append position
  const long long row_stride = (long long)KVH * dh;   // one token row
  const T* kn = k_new + ((long long)b * KVH + kvh) * dh;
  const T* vn = v_new + ((long long)b * KVH + kvh) * dh;

  // ---- append: write the new token at position n1 of its page (FREE -> trash)
  {
    int col = n1 / ps;
    if (col > MP - 1) col = MP - 1;
    int pg = table[(long long)b * MP + col];
    if (pg < 0) pg = P - 1;
    const long long off = ((long long)pg * ps + n1 % ps) * row_stride
                          + (long long)kvh * dh;
    for (int d = tid; d < dh; d += kThreads) {
      k_pages[off + d] = kn[d];
      v_pages[off + d] = vn[d];
    }
  }

  for (int i = tid; i < g * dh; i += kThreads) {
    const int gi = i / dh, d = i % dh;
    q_s[i] = to_f(q[((long long)b * H + kvh * g + gi) * dh + d]) * scale;
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  // stored tokens the walk may read: the table covers MP*ps positions (a
  // FREE slot's stale lens can run past them)
  Walk walk{table + (long long)b * MP, ps, n1 < MP * ps ? n1 : MP * ps, n1,
            window};
  int t_lo = 0;
  if (window > 0 && n1 - window + 1 > 0) t_lo = n1 - window + 1;
  t_lo -= t_lo % kTile;

  const T* kbase = k_pages + (long long)kvh * dh;
  const T* vbase = v_pages + (long long)kvh * dh;
  uint4 rk[kMaxVec], rv[kMaxVec];
  int any = 0;
  int t0 = t_lo;
  if (t0 < walk.n_stored)
    any = prefetch<T>(rk, rv, kbase, vbase, walk, t0, n_vec, vpr, row_stride);
  __syncthreads();
  while (t0 < walk.n_stored) {
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
          *reinterpret_cast<float4*>(k_s + j * kd + c + e) =
              make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
        unpack(rv[v], f, T());
#pragma unroll
        for (int e = 0; e < kVec; e += 4)
          *reinterpret_cast<float4*>(v_s + j * dh + c + e) =
              make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
    }
    const int tile = t0;
    const int live = __syncthreads_or(any);
    t0 += kTile;
    if (t0 < walk.n_stored)                 // in flight during the math
      any = prefetch<T>(rk, rv, kbase, vbase, walk, t0, n_vec, vpr,
                        row_stride);
    if (!live) continue;                    // whole tile unallocated/masked

    // scores: warp w takes heads w, w+kWarps, ...; lane j takes token j
    const bool ok = walk.pool_row(tile + lane) >= 0;
    for (int gi = warp; gi < g; gi += kWarps) {
      const float4* qr = reinterpret_cast<const float4*>(q_s + gi * dh);
      const float4* kr = reinterpret_cast<const float4*>(k_s + lane * kd);
      float s = 0.f;
      for (int d = 0; d < dh / 4; ++d) {
        const float4 a = qr[d], c = kr[d];
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, warp_max(ok ? s : kNegInf));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float tot = warp_sum(p);
      p_s[gi * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[gi] = corr;
        l_s[gi] = l_s[gi] * corr + tot;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * dh; i += kThreads) {
      const int gi = i / dh, d = i % dh;
      const float* pr = p_s + gi * kTile;
      float a = acc_s[i] * c_s[gi];
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) a = fmaf(pr[j], v_s[j * dh + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  // ---- merge the new token (always attended: distance 0) and normalise
  for (int gi = warp; gi < g; gi += kWarps) {
    float s = 0.f;
    for (int d = lane; d < dh; d += 32) s = fmaf(q_s[gi * dh + d], to_f(kn[d]), s);
    s = warp_sum(s);
    const float m_old = m_s[gi];
    const float m_new = fmaxf(m_old, s);
    const float pn = expf(s - m_new);
    const float corr = expf(m_old - m_new);
    const float l = l_s[gi] * corr + pn;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + ((long long)b * H + kvh * g + gi) * dh;
    for (int d = lane; d < dh; d += 32) {
      const float a = acc_s[gi * dh + d] * corr + pn * to_f(vn[d]);
      o[d] = from_f<T>(a * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new,
           void* k_pages, void* v_pages, const int* table, const int* lens,
           void* out, int B, int H, int KVH, int dh, int P, int ps, int MP,
           int window, float scale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (dh % 8 || kTile * (dh / kVec) > kMaxVec * kThreads)
    return (int)cudaErrorInvalidValue;
  const int g = H / KVH;
  const size_t smem = sizeof(float) * (kTile * (dh + 4) + kTile * dh
                                       + 2 * g * dh + g * kTile + 3 * g);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_step_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KVH);
  paged_decode_step_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_pages),
      static_cast<T*>(v_pages), table, lens, static_cast<T*>(out), H, KVH,
      dh, P, ps, MP, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_decode_step_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* table, const void* lens, void* out, int B,
    int H, int KVH, int dh, int P, int ps, int MP, int window, float scale,
    int dtype, void* stream) {
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_new, v_new, k_pages, v_pages, tb, ln, out, B,
                         H, KVH, dh, P, ps, MP, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_pages, v_pages, tb, ln,
                                 out, B, H, KVH, dh, P, ps, MP, window, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}
