// Single-token decode attention against a striped ring KV cache for
// Hopper (sm_90a): one query token per head, every attention layer of the
// striped (per-slot) decode step.
//
// Replaces the TPU kernel `decode_attention` (src/repro/kernels/
// decode_attention.py, body `_kernel`).  Layouts are the JAX package's:
//   q (B,H,dh); k/v (B,W,KVH,dh); spos (B,W) int32 position stored in each
//   ring slot (-1 = empty); pos (B,) int32 current positions; out (B,H,dh).
//   Slot w of row b is valid where spos >= 0 and spos <= pos, and also
//   pos - spos < window when a window is set.  dh is a multiple of 8 and
//   at most 256; any W (the Pallas version asserts W % bk == 0).
//
// What bounds it on the H100: bytes.  Each (slot, KV head) reads up to W K
// and V rows of dh elements and does 4·g·dh flops per row, far below the
// ~295 flop/byte ridge, so the floor is the K/V bytes over 3.35 TB/s.
//
// Design: the walk of the paged kernels (decode_attend.cuh) over the
// ring: a CTA holds the query heads of one (slot b, KV head h), so each K/V
// row is read once for all of them; masked slots are skipped, never
// multiplied by zero (fuzzed rings hold garbage there), and a tile with no
// valid slot is not computed.  Both walks run on the tensor cores
// (mma.sync: bf16 products, fp32 as 3xTF32).  The W slots are split over
// n_split CTAs per (b, h) (split_count picks n_split to fill the card: at
// the recurrentgemma serving shape B·KVH is only 8), and the last CTA of
// each (b, h) to arrive merges the fp32 partials in the same launch (a second,
// combine, launch took 57% of the kernel's time at that shape on an H100,
// and adds a host launch per layer to a host-bound path).  A row with no
// valid slot (the engines never make one: the new token is written before
// the call) gives the uniform mean of V over the W slots, as the plain
// version's all-masked softmax does.
#include "decode_attend.cuh"

namespace {

struct RingWalk {
  const int* spos;                   // spos row of slot b
  long long row0;                    // b * W: first K/V token row of slot b
  int pos, window;                   // window <= 0: none
  int begin, end, n_all;             // 0, W, W
  __device__ __forceinline__ long long row(int t) const {
    if (t >= end) return -1;
    const int sp = spos[t];
    if (sp < 0 || sp > pos) return -1;
    if (window > 0 && pos - sp >= window) return -1;
    return row0 + t;
  }
  __device__ __forceinline__ long long any_row(int t) const {
    return row0 + t;
  }
};

__device__ __forceinline__ RingWalk ring_walk(const int* spos,
                                              const int* pos, int b, int W,
                                              int window) {
  return RingWalk{spos + (long long)b * W, (long long)b * W, pos[b], window,
                  0, W, W};
}

// grid (B, KVH · row tiles, n_split): split z of (b, h, row tile) walks
// its share and writes its partial; the last of the pair's n_split CTAs
// to arrive merges them.  DH: the head-dim bucket of either walk.
template <typename T, int DH>
__global__ void __launch_bounds__(kMmaThreads,
                                  walk_min_blocks(DH, sizeof(T) == 4))
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ spos,
                        const int* __restrict__ pos, T* __restrict__ out,
                        float* part, int* arrived, int H, int KVH, int dh,
                        int W, int window, float scale) {
  const int g = H / KVH;
  const Place at(KVH, g, 0);
  extern __shared__ float4 smem4[];
  const long long row_stride = (long long)KVH * dh;
  float* po = at.po(part, g, dh);
  float* pml = at.pml(part, KVH, g, dh);
  const T* qr = q + ((long long)at.b * H + at.kvh * g + at.r0) * dh;
  const T* vb = v + (long long)at.kvh * dh;
  const RingWalk whole = ring_walk(spos, pos, at.b, W, window);
  walk_share<T, DH>(split_walk(whole, blockIdx.z, gridDim.z), qr,
                    k + (long long)at.kvh * dh, vb, at.rows, dh, row_stride,
                    scale, po + (long long)blockIdx.z * g * dh,
                    pml + 2LL * blockIdx.z * g, smem4);
  merge_pair<T>(at.counter(arrived), gridDim.z, po, pml, gridDim.z, g,
                at.rows, dh, whole, vb, row_stride,
                out + ((long long)at.b * H + at.kvh * g + at.r0) * dh,
                reinterpret_cast<float*>(smem4));
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* spos,
           const int* pos, void* out, float* part, int* arrived, int B,
           int H, int KVH, int dh, int W, int window, int n_split,
           float scale, cudaStream_t stream) {
  const int g = H / KVH;
  const size_t smem = launch_smem<T, DH>(g, dh, n_split, 0);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<T, DH><<<dim3(B, KVH * row_tiles(g), n_split),
                                   kMmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), spos, pos, static_cast<T*>(out), part,
      arrived, H, KVH, dh, W, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int splits(int pairs, int n_tokens, int g, int dh, int device) {
  return split_count(decode_attention_kernel<T, DH>, kMmaThreads,
                     walk_smem_bytes<T>(DH), pairs * row_tiles(g),
                     n_tokens, device, walk_fill<T>());
}

}  // namespace

// dtype: 0 = float32 (3xTF32 walk), 1 = bfloat16 (bf16 mma walk).
// window <= 0 means no window.  part: fp32 scratch of
// B·KVH·n_split·(H/KVH)·(dh+2) floats; arrived: B·KVH·ceil(H/KVH / 16)
// int32 arrival counters, zero on entry and left zero by the launch (calls
// sharing them must be ordered, e.g. on one stream).  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* spos,
                                       const void* pos, void* out, void* part,
                                       void* arrived, int B, int H, int KVH,
                                       int dh, int W, int window, int n_split,
                                       float scale, int dtype, void* stream) {
  const int* sp = static_cast<const int*>(spos);
  const int* ps = static_cast<const int*>(pos);
  float* pt = static_cast<float*>(part);
  int* ar = static_cast<int*>(arrived);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!decode_dh_ok(dh) || KVH <= 0 || H % KVH || W <= 0 || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  DISPATCH(launch, q, k, v, sp, ps, out, pt, ar, B, H, KVH, dh, W, window,
           n_split, scale, s);
}

// n_split for decode_attention_launch (split_count in decode_attend.cuh,
// for the kernel instance that dtype and dh select); pairs = B·KVH,
// device the CUDA device ordinal.
extern "C" int decode_split_count(int pairs, int n_tokens, int g, int dh,
                                  int dtype, int device) {
  if (!decode_dh_ok(dh) || g <= 0 || (dtype != 0 && dtype != 1))
    return -(int)cudaErrorInvalidValue;
  DISPATCH(splits, pairs, n_tokens, g, dh, device);
}
