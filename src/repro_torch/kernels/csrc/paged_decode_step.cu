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
// Design: CTAs, each holding query heads of one KV head, walk the slot's
// page table themselves (decode_attend.cuh), bounded by lens[b] rather
// than by the table's full width as the TPU grid was; a tile whose pages
// are all unallocated is skipped.  bf16 runs the tensor-core walk
// (mma.sync), fp32 the CUDA-core one.  Both entry points split each (slot
// b, KV head) walk over n_split CTAs (split_walk), as flash-decoding does:
// with few slots, one CTA each would leave most of the 132 SMs idle.  Each
// CTA writes its unnormalised fp32 partial and the last to arrive merges
// them in the same launch (merge_pair): one launch per layer and tick, as
// a second launch would add host work to a host-bound path.
//   The fused step attends the new token from the operand (as the TPU
//   kernel does): the CTA that appends it also writes it as one more
//   partial of its pair (score q·k_new, l = 1, value v_new), so the merge
//   is the read-only form's.  Split 0 appends the new token; the walk reads
//   [begin, n1) and the append writes position n1, so the splits never
//   race it.  (A stale lens past the table's MP·ps positions clamps the
//   append into the last table column, inside the walk: the split whose
//   share holds that row appends it and reads it back after a barrier, as
//   the plain version writes the pool before reading it.  With g > 16
//   heads in bf16, each row tile's CTAs append the same bytes.)
//   The read-only form keeps the TPU kernel's semantics for a row with no
//   valid token (lens == 0): the uniform mean of V over all MP·ps table
//   entries, unallocated ones read from the trash page.  The step always
//   attends the new token, so that case cannot arise there.
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

// grid (B, KVH · row tiles, n_split): split z of (b, h, row tile) walks its
// share and writes its partial; the last of the n_split CTAs to arrive
// merges them with the new token.  DH: 0 for the fp32 walk, else the bf16
// bucket.
template <typename T, int DH>
__global__ void __launch_bounds__(walk_threads(DH), walk_min_blocks(DH))
paged_decode_step_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                         const T* __restrict__ v_new, T* k_pages, T* v_pages,
                         const int* __restrict__ table,
                         const int* __restrict__ lens, T* __restrict__ out,
                         float* part, int* arrived, int H, int KVH, int dh,
                         int P, int ps, int MP, int window, float scale) {
  const int g = H / KVH;
  const Place at(KVH, g, DH != 0, 1);
  const int b = at.b, z = blockIdx.z, n_split = gridDim.z;
  extern __shared__ float4 smem4[];

  const int n = lens[b];
  const int n1 = n - 1 > 0 ? n - 1 : 0;   // stored tokens; append position
  const long long row_stride = (long long)KVH * dh;   // one token row
  const T* kn = k_new + at.pair * dh;
  const T* vn = v_new + at.pair * dh;
  const PagedWalk whole = paged_walk(table, b, ps, MP, P, n1, n1, window);
  const PagedWalk walk = split_walk(whole, z, n_split);

  float* po = at.po(part, g, dh);
  float* pml = at.pml(part, KVH, g, dh);
  const T* qr = q + ((long long)b * H + at.kvh * g + at.r0) * dh;

  // ---- append: the new token at position n1 of its page (FREE -> trash),
  // and its partial (entry n_split)
  int col = n1 / ps;
  if (col > MP - 1) col = MP - 1;
  const int t_app = col * ps + n1 % ps;   // == n1 unless lens is stale
  const bool in_walk = t_app >= whole.begin && t_app < whole.end;
  if (in_walk ? t_app >= walk.begin && t_app < walk.end : z == 0) {
    int pg = table[(long long)b * MP + col];
    if (pg < 0) pg = P - 1;
    const long long off = ((long long)pg * ps + n1 % ps) * row_stride
                          + (long long)at.kvh * dh;
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
      k_pages[off + d] = kn[d];
      v_pages[off + d] = vn[d];
    }
    new_token_partial(qr, kn, vn, at.rows, dh, scale * kLog2e,
                      po + (long long)n_split * g * dh,
                      pml + 2LL * n_split * g);
  }
  __syncthreads();                        // the appender reads its row back

  const T* vb = v_pages + (long long)at.kvh * dh;
  walk_share<T, DH>(walk, qr, k_pages + (long long)at.kvh * dh, vb, at.rows,
                    dh, row_stride, scale, po + (long long)z * g * dh,
                    pml + 2LL * z * g, smem4);
  merge_pair<T>(at.counter(arrived), n_split, po, pml, n_split + 1, g,
                at.rows, dh, whole, vb, row_stride,
                out + ((long long)b * H + at.kvh * g + at.r0) * dh,
                reinterpret_cast<float*>(smem4));
}

// grid (B, KVH · row tiles, n_split): the read-only form of the above
template <typename T, int DH>
__global__ void __launch_bounds__(walk_threads(DH), walk_min_blocks(DH))
paged_decode_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ table,
                              const int* __restrict__ lens,
                              T* __restrict__ out, float* part, int* arrived,
                              int H, int KVH, int dh, int P, int ps, int MP,
                              int window, float scale) {
  const int g = H / KVH;
  const Place at(KVH, g, DH != 0, 0);
  const int n = lens[at.b] > 0 ? lens[at.b] : 0;
  extern __shared__ float4 smem4[];
  const PagedWalk whole = paged_walk(table, at.b, ps, MP, P, n, n - 1,
                                     window);
  float* po = at.po(part, g, dh);
  float* pml = at.pml(part, KVH, g, dh);
  const T* qr = q + ((long long)at.b * H + at.kvh * g + at.r0) * dh;
  const T* vb = v_pages + (long long)at.kvh * dh;
  const long long row_stride = (long long)KVH * dh;
  walk_share<T, DH>(split_walk(whole, blockIdx.z, gridDim.z), qr,
                    k_pages + (long long)at.kvh * dh, vb, at.rows, dh,
                    row_stride, scale, po + (long long)blockIdx.z * g * dh,
                    pml + 2LL * blockIdx.z * g, smem4);
  merge_pair<T>(at.counter(arrived), gridDim.z, po, pml, gridDim.z, g,
                at.rows, dh, whole, vb, row_stride,
                out + ((long long)at.b * H + at.kvh * g + at.r0) * dh,
                reinterpret_cast<float*>(smem4));
}

template <typename T, int DH>
int launch_step(const void* q, const void* k_new, const void* v_new,
                void* k_pages, void* v_pages, const int* table,
                const int* lens, void* out, float* part, int* arrived, int B,
                int H, int KVH, int dh, int P, int ps, int MP, int window,
                int n_split, float scale, cudaStream_t stream) {
  const int g = H / KVH;
  const size_t smem = launch_smem<DH>(g, dh, n_split, 1);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_step_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_step_kernel<T, DH><<<dim3(B, KVH * row_tiles(DH, g),
                                         n_split),
                                    walk_threads(DH), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_pages),
      static_cast<T*>(v_pages), table, lens, static_cast<T*>(out), part,
      arrived, H, KVH, dh, P, ps, MP, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_attn(const void* q, const void* k_pages, const void* v_pages,
                const int* table, const int* lens, void* out, float* part,
                int* arrived, int B, int H, int KVH, int dh, int P, int ps,
                int MP, int window, int n_split, float scale,
                cudaStream_t stream) {
  const int g = H / KVH;
  const size_t smem = launch_smem<DH>(g, dh, n_split, 0);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_attention_kernel<T, DH><<<dim3(B, KVH * row_tiles(DH, g),
                                              n_split),
                                         walk_threads(DH), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), table, lens, static_cast<T*>(out),
      part, arrived, H, KVH, dh, P, ps, MP, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int splits(int pairs, int n_tokens, int g, int dh, int device) {
  return split_count(paged_decode_step_kernel<T, DH>, walk_threads(DH),
                     walk_smem_bytes(DH, g, dh), pairs * row_tiles(DH, g),
                     n_tokens, device);
}

inline bool args_ok(int H, int KVH, int dh, int n_split) {
  return decode_dh_ok(dh) && KVH > 0 && H % KVH == 0 && n_split > 0;
}

}  // namespace

// dtype: 0 = float32 (CUDA-core walk), 1 = bfloat16 (tensor-core walk).
// window <= 0 means no window.  Both return the cudaError_t of the launch
// (0 = launched).  part: fp32 scratch of B·KVH·(n_split+1)·(H/KVH)·(dh+2)
// floats for the step (the new token is one more entry), n_split in
// place of n_split+1 for the read-only form; arrived: B·KVH·ceil(H/KVH / 16) int32 arrival counters, zero on
// entry and left zero by the launch (calls sharing them must be ordered,
// e.g. on one stream).

extern "C" int paged_decode_step_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* table, const void* lens, void* out,
    void* part, void* arrived, int B, int H, int KVH, int dh, int P, int ps,
    int MP, int window, int n_split, float scale, int dtype, void* stream) {
  if (!args_ok(H, KVH, dh, n_split)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  DISPATCH(launch_step, q, k_new, v_new, k_pages, v_pages,
           static_cast<const int*>(table), static_cast<const int*>(lens), out,
           static_cast<float*>(part), static_cast<int*>(arrived), B, H, KVH,
           dh, P, ps, MP, window, n_split, scale,
           static_cast<cudaStream_t>(stream));
}

extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* lens, void* out, void* part,
    void* arrived, int B, int H, int KVH, int dh, int P, int ps, int MP,
    int window, int n_split, float scale, int dtype, void* stream) {
  if (!args_ok(H, KVH, dh, n_split)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  DISPATCH(launch_attn, q, k_pages, v_pages, static_cast<const int*>(table),
           static_cast<const int*>(lens), out, static_cast<float*>(part),
           static_cast<int*>(arrived), B, H, KVH, dh, P, ps, MP, window,
           n_split, scale, static_cast<cudaStream_t>(stream));
}

// n_split for both entry points (split_count in decode_attend.cuh, for the
// step's kernel instance that dtype and dh select); pairs = B·KVH, device
// the CUDA device ordinal.
extern "C" int decode_split_count(int pairs, int n_tokens, int g, int dh,
                                  int dtype, int device) {
  if (!decode_dh_ok(dh) || g <= 0 || (dtype != 0 && dtype != 1))
    return -(int)cudaErrorInvalidValue;
  DISPATCH(splits, pairs, n_tokens, g, dh, device);
}
