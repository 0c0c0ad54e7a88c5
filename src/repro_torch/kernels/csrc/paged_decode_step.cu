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
// Design: one CTA of 256 threads per (slot b, KV head h) holds the g query
// heads of that KV head and walks the slot's page table itself
// (decode_attend.cuh), bounded by lens[b] rather than by the table's full
// width as the TPU grid was; a tile whose pages are all unallocated is
// skipped.  The step merges the new token analytically at the end from the
// operand, as the TPU kernel does.  The read-only form splits each slot's
// walk over n_split CTAs and merges their fp32 partials in a second kernel
// (decode_attend.cuh), and keeps the TPU kernel's semantics for a row with
// no valid token (lens == 0): the uniform mean of V over all MP·ps table
// entries, unallocated ones read from the trash page.  Still simple: no
// TMA, no wgmma, and the fused step does not split the walk yet, so with
// few slots most SMs stay idle there.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_step_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                         const T* __restrict__ v_new, T* k_pages, T* v_pages,
                         const int* __restrict__ table,
                         const int* __restrict__ lens, T* __restrict__ out,
                         int H, int KVH, int dh, int P, int ps, int MP,
                         int window, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), g, dh);

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

  load_q(s, q + ((long long)b * H + kvh * g) * dh, g, dh, scale);
  const PagedWalk walk = paged_walk(table, b, ps, MP, P, n1, n1, window);
  attend<T>(s, walk, k_pages + (long long)kvh * dh,
            v_pages + (long long)kvh * dh, g, dh, row_stride);

  // ---- merge the new token (always attended: distance 0) and normalise
  for (int gi = warp; gi < g; gi += kWarps) {
    float sc = 0.f;
    for (int d = lane; d < dh; d += 32) sc = fmaf(s.q[gi * dh + d], to_f(kn[d]), sc);
    sc = warp_sum(sc);
    const float m_old = s.m[gi];
    const float m_new = fmaxf(m_old, sc);
    const float pn = expf(sc - m_new);
    const float corr = expf(m_old - m_new);
    const float l = s.l[gi] * corr + pn;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + ((long long)b * H + kvh * g + gi) * dh;
    for (int d = lane; d < dh; d += 32) {
      const float a = s.acc[gi * dh + d] * corr + pn * to_f(vn[d]);
      o[d] = from_f<T>(a * inv);
    }
  }
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

template <typename T>
int launch_step(const void* q, const void* k_new, const void* v_new,
                void* k_pages, void* v_pages, const int* table,
                const int* lens, void* out, int B, int H, int KVH, int dh,
                int P, int ps, int MP, int window, float scale,
                cudaStream_t stream) {
  if (!attend_dh_ok<T>(dh) || KVH <= 0 || H % KVH)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * attend_smem_floats(H / KVH, dh);
  const int err = set_smem((const void*)paged_decode_step_kernel<T>, smem);
  if (err) return err;
  paged_decode_step_kernel<T><<<dim3(B, KVH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_pages),
      static_cast<T*>(v_pages), table, lens, static_cast<T*>(out), H, KVH,
      dh, P, ps, MP, window, scale);
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
extern "C" int paged_decode_step_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* table, const void* lens, void* out, int B,
    int H, int KVH, int dh, int P, int ps, int MP, int window, float scale,
    int dtype, void* stream) {
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_step<float>(q, k_new, v_new, k_pages, v_pages, tb, ln, out,
                              B, H, KVH, dh, P, ps, MP, window, scale, s);
  if (dtype == 1)
    return launch_step<__nv_bfloat16>(q, k_new, v_new, k_pages, v_pages, tb,
                                      ln, out, B, H, KVH, dh, P, ps, MP,
                                      window, scale, s);
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

// n_split for decode_attention_launch / paged_decode_attention_launch
// (split_count in decode_attend.cuh); device is the CUDA device ordinal.
extern "C" int decode_split_count(int pairs, int n_tokens, int device) {
  return split_count(pairs, n_tokens, device);
}
