// RG-LRU linear recurrence h_t = a_t ⊙ h_{t-1} + b_t for Hopper (sm_90a):
// the prefill hot spot of every recurrent layer of RecurrentGemma.
//
// Replaces the TPU kernel `rglru_scan` (src/repro/kernels/rglru_scan.py,
// body `_kernel`).  Layouts are the JAX package's: a, b (B,S,d) in fp32 or
// bf16 (one type for both); h0 (B,d) fp32; h (B,S,d) in a's type.  The
// carry is fp32.  Any S (the Pallas version asserts S % bt == 0).
//
// What bounds it on the H100: bytes.  Each element of a and b is read once
// and each h written once, with one FMA per element: the floor is
// 3·B·S·d elements over 3.35 TB/s.
//
// Design: one thread per (batch row, channel) holds the carry in a
// register and walks t in order, so there is no second pass and no
// cross-thread exchange.  Neighbouring threads own neighbouring channels,
// so every load and store of a time step is coalesced across the warp.
// The loads of the next kAhead time steps are issued before the current
// kAhead steps are computed, keeping 2·kAhead loads per thread in flight
// against memory latency; the FMA chain itself is 4 cycles a step.
// What holds it back: the parallelism is only B·d threads.  At B=1 and
// d=2560 that is 20 CTAs of 128 threads on 132 SMs, too few loads in
// flight to reach the bandwidth floor; a chunked two-level scan (per-chunk
// carries, then a fix-up pass) would use the whole card.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 16;           // time steps loaded ahead per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ h, int S,
                  int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (c >= d) return;
  const long long base = (long long)row * S * d + c;
  float carry = h0[(long long)row * d + c];
  float ra[kAhead], rb[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const bool in = u < S;
    ra[u] = in ? to_f(a[base + (long long)u * d]) : 0.f;
    rb[u] = in ? to_f(b[base + (long long)u * d]) : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += kAhead) {
    float na[kAhead], nb[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {           // next chunk, in flight
      const int t = t0 + kAhead + u;
      const bool in = t < S;
      na[u] = in ? to_f(a[base + (long long)t * d]) : 0.f;
      nb[u] = in ? to_f(b[base + (long long)t * d]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < S) {
        carry = fmaf(ra[u], carry, rb[u]);
        h[base + (long long)(t0 + u) * d] = from_f<T>(carry);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      ra[u] = na[u];
      rb[u] = nb[u];
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, void* h, int B,
           int S, int d, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || d <= 0) return 0;
  dim3 grid((d + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(h), S, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of a, b and h): 0 = float32, 1 = bfloat16.  h0 is float32.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* h, int B, int S, int d, int dtype,
                                 void* stream) {
  const float* h0f = static_cast<const float*>(h0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0f, h, B, S, d, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h0f, h, B, S, d, s);
  return (int)cudaErrorInvalidValue;
}
