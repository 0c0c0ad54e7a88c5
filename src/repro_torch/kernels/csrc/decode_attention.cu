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
// Design: the page walk of the paged kernels (decode_attend.cuh) over the
// ring: a CTA of 256 threads holds the g query heads of one (slot b, KV
// head h), so each K/V row is read once for all g; 32-slot tiles are
// loaded as 16-byte vectors one tile ahead; masked slots are skipped,
// never multiplied by zero (fuzzed rings hold garbage there), and a tile
// with no valid slot is not computed.  The W slots are split over n_split
// CTAs per (b, h) (split_count picks n_split to fill the card: at the
// recurrentgemma serving shape B·KVH is only 8, and with one CTA each the
// kernel ran 2.3x slower than the plain version on an H100); a second
// kernel merges the fp32 partials.  A row with no valid slot (the engines never make one: the new
// token is written before the call) gives the uniform mean of V over the W
// slots, as the plain version's all-masked softmax does.  Still simple:
// CUDA-core math, no TMA, no wgmma.
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

// grid (B, KVH, n_split): split z of (b, h) writes its partial
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ spos,
                        const int* __restrict__ pos, float* __restrict__ part,
                        int H, int KVH, int dh, int W, int window,
                        float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = H / KVH;
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), g, dh);
  const long long row_stride = (long long)KVH * dh;

  load_q(s, q + ((long long)b * H + kvh * g) * dh, g, dh, scale);
  const RingWalk walk = split_walk(ring_walk(spos, pos, b, W, window),
                                   blockIdx.z, gridDim.z);
  attend<T>(s, walk, k + (long long)kvh * dh, v + (long long)kvh * dh, g, dh,
            row_stride);
  write_partial(s, part + (((long long)b * KVH + kvh) * gridDim.z
                           + blockIdx.z) * g * (dh + 2), g, dh);
}

// grid (B, KVH): merge the n_split partials of (b, h)
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine(const float* __restrict__ part,
                         const T* __restrict__ v,
                         const int* __restrict__ spos,
                         const int* __restrict__ pos, T* __restrict__ out,
                         int H, int KVH, int dh, int W, int window,
                         int n_split) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = H / KVH;
  combine<T>(part + ((long long)b * KVH + kvh) * n_split * g * (dh + 2),
             n_split, ring_walk(spos, pos, b, W, window),
             out + ((long long)b * H + kvh * g) * dh,
             v + (long long)kvh * dh, g, dh, (long long)KVH * dh);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* spos,
           const int* pos, void* out, float* part, int B, int H, int KVH,
           int dh, int W, int window, int n_split, float scale,
           cudaStream_t stream) {
  if (!attend_dh_ok<T>(dh) || KVH <= 0 || H % KVH || W <= 0 || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * attend_smem_floats(H / KVH, dh);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<T><<<dim3(B, KVH, n_split), kThreads, smem,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), spos, pos, part, H, KVH, dh, W, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attention_combine<T><<<dim3(B, KVH), kThreads, 0, stream>>>(
      part, static_cast<const T*>(v), spos, pos, static_cast<T*>(out), H,
      KVH, dh, W, window, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// part: fp32 scratch of B·KVH·n_split·(H/KVH)·(dh+2) floats.
// Returns the cudaError_t of the launches (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* spos,
                                       const void* pos, void* out, void* part,
                                       int B, int H, int KVH, int dh, int W,
                                       int window, int n_split, float scale,
                                       int dtype, void* stream) {
  const int* sp = static_cast<const int*>(spos);
  const int* ps = static_cast<const int*>(pos);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k, v, sp, ps, out, pt, B, H, KVH, dh, W, window,
                         n_split, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, sp, ps, out, pt, B, H, KVH, dh, W,
                                 window, n_split, scale, s);
  return (int)cudaErrorInvalidValue;
}

// n_split for decode_attention_launch / paged_decode_attention_launch
// (split_count in decode_attend.cuh); device is the CUDA device ordinal.
extern "C" int decode_split_count(int pairs, int n_tokens, int device) {
  return split_count(pairs, n_tokens, device);
}
