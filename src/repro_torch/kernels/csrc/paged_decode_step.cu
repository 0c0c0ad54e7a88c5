// Paged decode attention for Hopper (sm_90a), two entry points over one
// page walk:
//   paged_decode_step_launch       append the new token's K/V into its
//                                  page, then attend over the slot's stored
//                                  tokens plus the new token, in one launch;
//   paged_decode_attention_launch  read-only: attend over the slot's `lens`
//                                  live tokens.
//
// Replaces the TPU kernels `paged_decode_step` and `paged_decode_attention`
// (src/repro/kernels/paged_attention.py, bodies `_step_kernel` and
// `_attn_kernel`).  Layouts are the JAX package's:
//   q (B,H,dh); k_new/v_new (B,KVH,dh); k/v pools (P,ps,KVH,dh), the last
//   page P-1 is the trash page; table (B,MP) int32 (-1 = unallocated);
//   lens (B,) int32: for the step, token counts INCLUDING the new token;
//   for the read-only form, live token counts.  out (B,H,dh).  dh is a
//   multiple of 8 and at most 256.
//
// What bounds it on the H100: bytes.  Each (slot, KV head) reads the
// slot's stored K and V rows of dh elements and does 4·g·dh flops per row
// (g = H/KVH query heads), far below the ~295 flop/byte ridge, so the
// floor is the K/V bytes over 3.35 TB/s.
//
// Design: CTAs of 256 threads, each holding the g query heads of one KV
// head, walk the slot's page table themselves (decode_attend.cuh),
// bounded by lens[b] rather than by the table's full width as the TPU
// grid was; a tile whose pages are all unallocated is skipped.  Both
// entry points split each (slot b, KV head) walk over n_split CTAs
// (split_walk), as flash-decoding does: with few slots, one CTA each
// would leave most of the 132 SMs idle.  Each CTA writes its unnormalised
// fp32 partial (acc, m, l).
//   The fused step merges in the same launch: each CTA fences its partial
//   and bumps the pair's arrival counter; the CTA that arrives last merges
//   the n_split partials, merges the new token analytically from the
//   operand (as the TPU kernel does), normalises, and resets the counter
//   to 0 for the next call.  One launch per layer and tick, as before the
//   split: a second launch would add host work to a host-bound path.
//   Split 0 appends the new token; the walk reads [begin, n1) and the
//   append writes position n1, so the splits never race it.  (A stale
//   lens past the table's MP·ps positions clamps the append into the last
//   table column, inside the walk: the split whose share holds that row
//   appends it and reads it back after a barrier, as the plain version
//   writes the pool before reading it.)
//   The read-only form merges in a second kernel (combine), and keeps the
//   TPU kernel's semantics for a row with no valid token (lens == 0): the
//   uniform mean of V over all MP·ps table entries, unallocated ones read
//   from the trash page.  The step always attends the new token, so that
//   case cannot arise there.
// Still simple: the per-CTA walk converts K/V tiles to fp32 in shared
// memory and runs on the CUDA cores; no TMA, no mma.
//
// Trash page race: every FREE slot (table row all -1) appends to the trash
// page, possibly at the same row, from different CTAs in no order.  That
// is harmless only because the trash page is never read unmasked: table
// entries are -1 there, and the walk skips those tokens.
#include "decode_attend.cuh"

namespace {

struct PagedWalk {                   // the slot's view of the page table
  const int* row_;                   // table row of slot b
  int ps;
  int last;                          // position the window is measured from
  int window;                        // <= 0: none
  int P;
  int begin, end, n_all;             // end = stored tokens the walk may read
  __device__ __forceinline__ long long row(int t) const {
    if (t >= end) return -1;
    if (window > 0 && last - t >= window) return -1;
    const int pg = row_[t / ps];
    return pg >= 0 ? (long long)pg * ps + t % ps : -1;
  }
  __device__ __forceinline__ long long any_row(int t) const {
    const int pg = row_[t / ps];
    return (long long)(pg >= 0 ? pg : P - 1) * ps + t % ps;
  }
};

// the walk over slot b's first n_stored tokens; the table covers MP*ps
// positions (a FREE slot's stale lens can run past them)
__device__ __forceinline__ PagedWalk paged_walk(const int* table, int b,
                                                int ps, int MP, int P,
                                                int n_stored, int last,
                                                int window) {
  const int n_all = MP * ps;
  const int end = n_stored < n_all ? n_stored : n_all;
  int t_lo = 0;
  if (window > 0 && last - window + 1 > 0) t_lo = last - window + 1;
  t_lo -= t_lo % kTile;
  return PagedWalk{table + (long long)b * MP, ps, last, window, P, t_lo, end,
                   n_all};
}

// grid (B, KVH, n_split): split z of (b, h) walks its share and writes its
// partial; the last of the pair's n_split CTAs to arrive merges them with
// the new token.  Dynamic shared memory: attend_smem_floats(g, dh) +
// g·n_split floats (the merge weights).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_step_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                         const T* __restrict__ v_new, T* k_pages, T* v_pages,
                         const int* __restrict__ table,
                         const int* __restrict__ lens, T* __restrict__ out,
                         float* part, int* arrived, int H, int KVH, int dh,
                         int P, int ps, int MP, int window, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int z = blockIdx.z;
  const int n_split = gridDim.z;
  const int g = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), g, dh);
  __shared__ int is_last;

  const int n = lens[b];
  const int n1 = n - 1 > 0 ? n - 1 : 0;   // stored tokens; append position
  const long long row_stride = (long long)KVH * dh;   // one token row
  const T* kn = k_new + ((long long)b * KVH + kvh) * dh;
  const T* vn = v_new + ((long long)b * KVH + kvh) * dh;
  const PagedWalk whole = paged_walk(table, b, ps, MP, P, n1, n1, window);
  const PagedWalk walk = split_walk(whole, z, n_split);

  // ---- append: the new token at position n1 of its page (FREE -> trash)
  int col = n1 / ps;
  if (col > MP - 1) col = MP - 1;
  const int t_app = col * ps + n1 % ps;   // == n1 unless lens is stale
  const bool in_walk = t_app >= whole.begin && t_app < whole.end;
  if (in_walk ? t_app >= walk.begin && t_app < walk.end : z == 0) {
    int pg = table[(long long)b * MP + col];
    if (pg < 0) pg = P - 1;
    const long long off = ((long long)pg * ps + n1 % ps) * row_stride
                          + (long long)kvh * dh;
    for (int d = tid; d < dh; d += kThreads) {
      k_pages[off + d] = kn[d];
      v_pages[off + d] = vn[d];
    }
  }
  __syncthreads();                        // the appender reads its row back

  load_q(s, q + ((long long)b * H + kvh * g) * dh, g, dh, scale);
  attend<T>(s, walk, k_pages + (long long)kvh * dh,
            v_pages + (long long)kvh * dh, g, dh, row_stride);
  const int pair = b * KVH + kvh;
  const int stride = g * (dh + 2);        // floats of one partial
  float* pp = part + (long long)pair * n_split * stride;
  write_partial(s, pp + (long long)z * stride, g, dh);

  // ---- arrival: the last CTA of the pair merges
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(arrived + pair, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // per head: the new token's score (always attended: distance 0), the
  // merged max m, each split's weight e^{m_z - m} and 1 / the denominator.
  // Partials of other CTAs are read through L2 (__ldcg), never a stale L1.
  float* wts = s.c + g;      // past carve()'s arrays: g × n_split floats
  for (int gi = warp; gi < g; gi += kWarps) {
    float sc = 0.f;
    for (int d = lane; d < dh; d += 32) sc = fmaf(s.q[gi * dh + d], to_f(kn[d]), sc);
    sc = warp_sum(sc);
    const float* ph = pp + gi * (dh + 2);
    float m = sc;
    for (int zz = lane; zz < n_split; zz += 32)
      if (__ldcg(ph + zz * stride + dh + 1) > 0.f)
        m = fmaxf(m, __ldcg(ph + zz * stride + dh));
    m = warp_max(m);
    float den = 0.f;
    for (int zz = lane; zz < n_split; zz += 32) {
      const float l = __ldcg(ph + zz * stride + dh + 1);
      const float w = l > 0.f ? expf(__ldcg(ph + zz * stride + dh) - m) : 0.f;
      wts[gi * n_split + zz] = w;
      den = fmaf(w, l, den);
    }
    den = warp_sum(den);
    if (lane == 0) {
      const float pn = expf(sc - m);
      s.c[gi] = pn;
      s.l[gi] = 1.f / (den + pn);
    }
  }
  __syncthreads();
  for (int i = tid; i < g * dh; i += kThreads) {
    const int gi = i / dh, d = i % dh;
    const float* ph = pp + gi * (dh + 2) + d;
    const float* wg = wts + gi * n_split;
    float num = s.c[gi] * to_f(vn[d]);
    for (int zz = 0; zz < n_split; ++zz)
      if (wg[zz] > 0.f) num = fmaf(wg[zz], __ldcg(ph + zz * stride), num);
    out[((long long)b * H + kvh * g) * dh + i] = from_f<T>(num * s.l[gi]);
  }
  if (tid == 0) arrived[pair] = 0;        // ready for the next call
}

// grid (B, KVH, n_split): split z of (b, h) writes its partial
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ table,
                              const int* __restrict__ lens,
                              float* __restrict__ part, int H, int KVH,
                              int dh, int P, int ps, int MP, int window,
                              float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = H / KVH;
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), g, dh);
  const int n = lens[b] > 0 ? lens[b] : 0;

  load_q(s, q + ((long long)b * H + kvh * g) * dh, g, dh, scale);
  const PagedWalk walk = split_walk(
      paged_walk(table, b, ps, MP, P, n, n - 1, window), blockIdx.z,
      gridDim.z);
  attend<T>(s, walk, k_pages + (long long)kvh * dh,
            v_pages + (long long)kvh * dh, g, dh, (long long)KVH * dh);
  write_partial(s, part + (((long long)b * KVH + kvh) * gridDim.z
                           + blockIdx.z) * g * (dh + 2), g, dh);
}

// grid (B, KVH): merge the n_split partials of (b, h)
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_combine(const float* __restrict__ part,
                               const T* __restrict__ v_pages,
                               const int* __restrict__ table,
                               const int* __restrict__ lens,
                               T* __restrict__ out, int H, int KVH, int dh,
                               int P, int ps, int MP, int window,
                               int n_split) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = H / KVH;
  const int n = lens[b] > 0 ? lens[b] : 0;
  combine<T>(part + ((long long)b * KVH + kvh) * n_split * g * (dh + 2),
             n_split, paged_walk(table, b, ps, MP, P, n, n - 1, window),
             out + ((long long)b * H + kvh * g) * dh,
             v_pages + (long long)kvh * dh, g, dh, (long long)KVH * dh);
}

inline int set_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The step's n_split, cut where the merge weights would not fit the
// shared memory a CTA may use (227 KB, less the kernel's static is_last).
inline int step_splits(int g, int dh, int n_split) {
  constexpr size_t kMaxSmemFloats = (232448 - 16) / sizeof(float);
  const size_t base = attend_smem_floats(g, dh);
  if (base >= kMaxSmemFloats) return 1;
  const size_t fit = (kMaxSmemFloats - base) / g;
  return (size_t)n_split < fit ? n_split : (fit > 1 ? (int)fit : 1);
}

template <typename T>
int launch_step(const void* q, const void* k_new, const void* v_new,
                void* k_pages, void* v_pages, const int* table,
                const int* lens, void* out, float* part, int* arrived, int B,
                int H, int KVH, int dh, int P, int ps, int MP, int window,
                int n_split, float scale, cudaStream_t stream) {
  if (!attend_dh_ok<T>(dh) || KVH <= 0 || H % KVH || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int g = H / KVH;
  n_split = step_splits(g, dh, n_split);
  const size_t smem = sizeof(float) * (attend_smem_floats(g, dh)
                                       + (size_t)g * n_split);
  const int err = set_smem((const void*)paged_decode_step_kernel<T>, smem);
  if (err) return err;
  paged_decode_step_kernel<T><<<dim3(B, KVH, n_split), kThreads, smem,
                                stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_pages),
      static_cast<T*>(v_pages), table, lens, static_cast<T*>(out), part,
      arrived, H, KVH, dh, P, ps, MP, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_attn(const void* q, const void* k_pages, const void* v_pages,
                const int* table, const int* lens, void* out, float* part,
                int B, int H, int KVH, int dh, int P, int ps, int MP,
                int window, int n_split, float scale, cudaStream_t stream) {
  if (!attend_dh_ok<T>(dh) || KVH <= 0 || H % KVH || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * attend_smem_floats(H / KVH, dh);
  int err = set_smem((const void*)paged_decode_attention_kernel<T>, smem);
  if (err) return err;
  paged_decode_attention_kernel<T><<<dim3(B, KVH, n_split), kThreads, smem,
                                     stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), table, lens, part, H, KVH, dh, P, ps,
      MP, window, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  paged_decode_attention_combine<T><<<dim3(B, KVH), kThreads, 0, stream>>>(
      part, static_cast<const T*>(v_pages), table, lens,
      static_cast<T*>(out), H, KVH, dh, P, ps, MP, window, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Both return the cudaError_t of the launch (0 = launched).
// part: fp32 scratch of B·KVH·n_split·(H/KVH)·(dh+2) floats; arrived: B·KVH
// int32 arrival counters, zero on entry and left zero by the launch (calls
// sharing them must be ordered, e.g. on one stream).
extern "C" int paged_decode_step_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* table, const void* lens, void* out,
    void* part, void* arrived, int B, int H, int KVH, int dh, int P, int ps,
    int MP, int window, int n_split, float scale, int dtype, void* stream) {
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  float* pt = static_cast<float*>(part);
  int* ar = static_cast<int*>(arrived);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_step<float>(q, k_new, v_new, k_pages, v_pages, tb, ln, out,
                              pt, ar, B, H, KVH, dh, P, ps, MP, window,
                              n_split, scale, s);
  if (dtype == 1)
    return launch_step<__nv_bfloat16>(q, k_new, v_new, k_pages, v_pages, tb,
                                      ln, out, pt, ar, B, H, KVH, dh, P, ps,
                                      MP, window, n_split, scale, s);
  return (int)cudaErrorInvalidValue;
}

// part: fp32 scratch of B·KVH·n_split·(H/KVH)·(dh+2) floats.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* lens, void* out, void* part, int B, int H,
    int KVH, int dh, int P, int ps, int MP, int window, int n_split,
    float scale, int dtype, void* stream) {
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (dtype == 0)
    return launch_attn<float>(q, k_pages, v_pages, tb, ln, out, pt, B, H,
                              KVH, dh, P, ps, MP, window, n_split, scale, s);
  if (dtype == 1)
    return launch_attn<__nv_bfloat16>(q, k_pages, v_pages, tb, ln, out, pt, B,
                                      H, KVH, dh, P, ps, MP, window, n_split,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}

// n_split for decode_attention_launch, paged_decode_attention_launch and
// paged_decode_step_launch (split_count in decode_attend.cuh); device is
// the CUDA device ordinal.
extern "C" int decode_split_count(int pairs, int n_tokens, int device) {
  return split_count(pairs, n_tokens, device);
}
