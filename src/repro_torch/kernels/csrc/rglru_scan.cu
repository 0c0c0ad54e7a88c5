// RG-LRU linear recurrence h_t = a_t ⊙ h_{t-1} + b_t for Hopper (sm_90a):
// the prefill hot spot of every recurrent layer of RecurrentGemma.
//
// Replaces the TPU kernel `rglru_scan` (src/repro/kernels/rglru_scan.py,
// body `_kernel`).  Layouts are the JAX package's: a, b (B,S,d) in fp32 or
// bf16 (one type for both); h0 (B,d) fp32; h (B,S,d) in a's type.  The
// carry is fp32.  Any B, S and d (the Pallas version asserts S % bt == 0).
//
// What bounds it on the H100: bytes.  Each element of a and b is read once
// and each h written once, with one FMA per element: the floor is
// 3·B·S·d elements over 3.35 TB/s.
//
// Design: a chunked single-pass scan with decoupled look-back.  A chain is
// one (batch row, 128-channel tile); its S steps are cut into n chunks of
// L, one CTA each, one thread per channel.  Over a chunk a channel's
// recurrence is the affine map h -> A·h + Bc (A = Π a_t, Bc the chunk's
// scan from a zero carry), and two chunks compose as (A2, B2)∘(A1, B1) =
// (A2·A1, A2·B1 + B2).  Only that composition is used: no division by A,
// which underflows to 0 within a chunk at the model's small gates.
//   1. A CTA takes its chunk index from the chain's ticket (atomicAdd), so
//      every chunk it may wait on is already running: progress whatever
//      order the CTAs are scheduled in.
//   2. It copies its L×128 tile of a and b to shared memory once (16-byte
//      cp.async), computes (A, Bc) and publishes them under a flag.
//   3. Warp 0 reads the flags of the 32 nearest predecessors at once
//      (acquire loads) until it finds an inclusive carry with every nearer
//      predecessor's aggregate published; all 128 threads compose those in
//      one round of loads, and the CTA publishes its own carry-out.
//   4. It rescans its tile from the carry-in and writes h, so a and b are
//      read from device memory once and h written once, plus a few fp32
//      values per (chain, chunk).
// A fifth warp raises the flags (release stores) and arrives, so the
// channel threads never wait for a release: they meet on a barrier of
// their own while it completes.
// The chunk count is picked per shape and device (rglru_chunk_count): one
// chunk where the chains alone fill the SMs, launched as the plain walk of
// the earlier kernel (rglru_walk_kernel: one thread per channel down all
// of S, loads kAhead steps ahead).  A chunk longer than the shared-memory
// tile (a forced, small count) walks device memory twice instead.
//
// Status scratch (per device, from the wrapper): per chain a ticket, an
// arrival counter and n flags (0 none, 1 aggregate, 2 inclusive), all
// zero at launch.  A CTA arrives once its look-back is done and its flags
// are raised; the last of a chain to arrive zeroes them again, so every
// launch leaves them zero.  The published fp32 values are written before
// their flag and need no clearing.  Calls on one device must be
// serialised (one stream).
#include "common.cuh"

namespace {

constexpr int kTile = 128;           // channels of one chain, a thread each
constexpr int kThreads = kTile + 32; // and a warp that raises the flags
constexpr int kTileBytes = 64 * 1024;  // a and b of one chunk on chip
constexpr int kAhead = 16;           // device-memory walk: steps ahead
constexpr int kBatch = 16;           // shared-memory steps loaded at once
constexpr int kWindow = 32;          // predecessors one look-back round

// the longest chunk whose a and b tiles fit in kTileBytes
template <typename T>
__host__ __device__ constexpr int max_chunk() {
  return kTileBytes / (2 * kTile * (int)sizeof(T));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// The signalling warp (threads kTile..kThreads-1) raises the CTA's flags
// and arrives, so no channel thread waits for a release to complete: the
// channel threads meet on their own barrier (kSync) between those steps.
constexpr int kSignal = kTile;
constexpr int kSync = 1;

__device__ __forceinline__ void sync_channels() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(kSync), "n"(kTile) : "memory");
}

// Raise the chunk's flag to `state` after the CTA barrier: the release
// store makes every thread's value stores before the barrier visible to
// an acquire load of the flag (release is cumulative).
__device__ __forceinline__ void raise_flag(int* flag, int state) {
  __syncthreads();
  if (threadIdx.x == kSignal) st_release(flag, state);
}

// One channel's walk of `len` steps in device memory from `carry`, the
// loads of the next kAhead steps in flight while the current ones are
// computed.  kStore writes h; kProd returns Π a_t in *prod.
template <typename T, bool kStore, bool kProd>
__device__ float walk(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ h, long long off, int d, int len,
                      float carry, float* prod) {
  float p = 1.f;
  float ra[kAhead], rb[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const bool in = u < len;
    ra[u] = in ? to_f(a[off + (long long)u * d]) : 0.f;
    rb[u] = in ? to_f(b[off + (long long)u * d]) : 0.f;
  }
  for (int t0 = 0; t0 < len; t0 += kAhead) {
    float na[kAhead], nb[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + kAhead + u;
      const bool in = t < len;
      na[u] = in ? to_f(a[off + (long long)t * d]) : 0.f;
      nb[u] = in ? to_f(b[off + (long long)t * d]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < len) {
        if (kProd) p *= ra[u];
        carry = fmaf(ra[u], carry, rb[u]);
        if (kStore) h[off + (long long)(t0 + u) * d] = from_f<T>(carry);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      ra[u] = na[u];
      rb[u] = nb[u];
    }
  }
  if (kProd) *prod = p;
  return carry;
}

// `len` steps × 128 channels from g (step stride d, first channel c0) into
// the shared tile s ([step][128]) by the channel threads; channels past d
// read as 0.  kVec: 16-byte cp.async (d a multiple of 16 bytes, g
// aligned), left in flight.
template <typename T, bool kVec>
__device__ __forceinline__ void load_tile(T* s, const T* g, int len, int d,
                                          int c0) {
  if (kVec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int kChunks = kTile / V;
    for (int i = threadIdx.x; i < len * kChunks; i += kTile) {
      const int t = i / kChunks, col = c0 + (i % kChunks) * V;
      const bool in = col < d;
      cp_async16(smem_addr(s + t * kTile + (i % kChunks) * V),
                 in ? g + (long long)t * d + col : g, in ? 16 : 0);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < len * kTile; i += kTile) {
      const int t = i / kTile, col = c0 + i % kTile;
      s[i] = col < d ? g[(long long)t * d + col] : from_f<T>(0.f);
    }
  }
}

// Steps t0..t0+kBatch-1 of this thread's channel from the shared tiles,
// steps past len as the identity map (a 1, b 0).  Loaded together, ahead
// of the dependent FMAs: the compiler cannot move a load past the
// rescan's stores into the same shared array.
template <typename T>
__device__ __forceinline__ void batch(const T* sa, const T* sb, int t0,
                                      int len, float (&ra)[kBatch],
                                      float (&rb)[kBatch]) {
  const int i0 = t0 * kTile + threadIdx.x;
  if (t0 + kBatch <= len) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      ra[u] = to_f(sa[i0 + u * kTile]);
      rb[u] = to_f(sb[i0 + u * kTile]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = min(t0 + u, len - 1) * kTile + threadIdx.x;
      const float x = to_f(sa[i]), y = to_f(sb[i]);
      ra[u] = t0 + u < len ? x : 1.f;
      rb[u] = t0 + u < len ? y : 0.f;
    }
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_tile(T* g, const T* s, int len, int d,
                                           int c0) {
  if (kVec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int kChunks = kTile / V;
    for (int i = threadIdx.x; i < len * kChunks; i += kTile) {
      const int t = i / kChunks, col = c0 + (i % kChunks) * V;
      if (col < d)
        *reinterpret_cast<uint4*>(g + (long long)t * d + col) =
            *reinterpret_cast<const uint4*>(s + t * kTile + (i % kChunks) * V);
    }
  } else {
    for (int i = threadIdx.x; i < len * kTile; i += kTile) {
      const int t = i / kTile, col = c0 + i % kTile;
      if (col < d) g[(long long)t * d + col] = s[i];
    }
  }
}

// Chunk k's carry-in (the carry after chunk k-1) for this thread's
// channel, composed from the predecessors' published maps back to the
// nearest published carry.  Channel threads only.
__device__ float look_back(const int* flags, const float2* agg,
                           const float* incl, int k) {
  __shared__ int s_count, s_done;
  const int lane = threadIdx.x & 31;
  float P = 1.f, Q = 0.f;              // carry-in = P·(carry after top-1) + Q
  for (int top = k;; top -= kWindow) {
    if (threadIdx.x < 32) {
      const int j = top - 1 - lane;
      unsigned incl_m, need;
      for (;;) {
        const int f = j >= 0 ? ld_acquire(flags + j) : 2;
        incl_m = __ballot_sync(0xffffffffu, f == 2);
        const unsigned avail = __ballot_sync(0xffffffffu, f != 0);
        // the lanes nearer than the nearest inclusive carry (all 32 when
        // the window has none) must have their aggregates published
        need = incl_m ? (incl_m & (0u - incl_m)) - 1u : 0xffffffffu;
        if ((avail & need) == need) break;
        __nanosleep(32);
      }
      if (lane == 0) {
        s_count = incl_m ? __ffs(incl_m) : kWindow;
        s_done = incl_m != 0;
      }
    }
    sync_channels();
    const int count = s_count;
    const bool done = s_done;
    const int m = done ? count - 1 : count;   // aggregates to compose
    float2 v[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i)
      if (i < m) v[i] = __ldcg(agg + (long long)(top - 1 - i) * kTile +
                               threadIdx.x);
    float carry = 0.f;
    if (done)
      carry = __ldcg(incl + (long long)(top - count) * kTile + threadIdx.x);
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      if (i < m) {
        Q = fmaf(P, v[i].y, Q);
        P *= v[i].x;
      }
    }
    sync_channels();                   // s_count is rewritten next round
    if (done) return fmaf(P, carry, Q);
  }
}

// One chunk a chain: the plain walk.  grid (ceil(d/128) tiles, B rows),
// kTile threads, one per channel.
template <typename T>
__global__ void __launch_bounds__(kTile)
rglru_walk_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ h, int S,
                  int d) {
  const int c = blockIdx.x * kTile + threadIdx.x;
  const int row = blockIdx.y;
  if (c >= d) return;
  walk<T, true, false>(a, b, h, (long long)row * S * d + c, d, S,
                       h0[(long long)row * d + c], nullptr);
}

// n >= 2 chunks a chain.
// grid (n chunks, ceil(d/128) tiles, B rows), kThreads threads; dynamic
// shared memory 2·L·128·sizeof(T) when L <= max_chunk<T>(), else 0.
// ints: [tickets (chains) | arrivals (chains) | flags (chains·n)], zero;
// vals: [aggregates (chains·n·128 float2) | carries (chains·n·128)].
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ h, int S,
                  int d, int L, int* ints, float* vals) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_k;
  const int tid = threadIdx.x, n = gridDim.x;
  const int chains = gridDim.y * gridDim.z;
  const int row = blockIdx.z, c0 = blockIdx.y * kTile, c = c0 + tid;
  const int chain = row * gridDim.y + blockIdx.y;
  int* ticket = ints + chain;
  int* arrived = ints + chains + chain;
  int* flags = ints + 2 * chains + (long long)chain * n;
  float2* agg = reinterpret_cast<float2*>(vals) + (long long)chain * n * kTile;
  float* incl = vals + 2LL * chains * n * kTile + (long long)chain * n * kTile;

  if (tid == 0) s_k = atomicAdd(ticket, 1);
  __syncthreads();
  const int k = s_k;
  const int len = min(L, S - k * L);
  const long long base = ((long long)row * S + (long long)k * L) * d;
  const bool on_chip = L <= max_chunk<T>();
  const bool channel = tid < kTile, live = channel && c < d;
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + (on_chip ? L * kTile : 0);
  if (on_chip) {
    if (channel) {
      load_tile<T, kVec>(sa, a + base, len, d, c0);
      load_tile<T, kVec>(sb, b + base, len, d, c0);
      if (kVec) cp_async_wait_all();
    }
    __syncthreads();
  }

  // this chunk as the map h -> A·h + Bc
  float A = 1.f, Bc = 0.f, carry = 0.f;
  if (channel && on_chip) {
    for (int t0 = 0; t0 < len; t0 += kBatch) {
      float ra[kBatch], rb[kBatch];
      batch(sa, sb, t0, len, ra, rb);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        A *= ra[u];
        Bc = fmaf(ra[u], Bc, rb[u]);
      }
    }
  } else if (live) {
    Bc = walk<T, false, true>(a, b, h, base + c, d, len, 0.f, &A);
  }
  if (k == 0) {
    if (live) carry = h0[(long long)row * d + c];
  } else {
    if (k < n - 1) {
      if (channel) agg[(long long)k * kTile + tid] = make_float2(A, Bc);
      raise_flag(flags + k, 1);
    }
    if (channel) carry = look_back(flags, agg, incl, k);
  }
  if (k < n - 1) {
    if (channel) incl[(long long)k * kTile + tid] = fmaf(A, carry, Bc);
    raise_flag(flags + k, 2);
  } else {
    __syncthreads();                   // the look-back's flag reads are done
  }
  if (!channel) {
    // every flag of the chain is raised and read once all n CTAs arrived:
    // the last zeroes them (its acquire orders the stores after)
    int last = 0;
    if (tid == kSignal) last = atom_add_acq_rel(arrived, 1) == n - 1;
    last = __shfl_sync(0xffffffffu, last, 0);
    __syncwarp();
    if (last) {
      for (int i = tid - kSignal; i < n; i += 32) flags[i] = 0;
      if (tid == kSignal) {
        *ticket = 0;
        *arrived = 0;
      }
    }
    return;
  }

  // rescan from the carry-in: h over b's tile, or straight to memory
  if (on_chip) {
    for (int t0 = 0; t0 < len; t0 += kBatch) {
      float ra[kBatch], rb[kBatch];
      batch(sa, sb, t0, len, ra, rb);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        carry = fmaf(ra[u], carry, rb[u]);
        if (t0 + u < len) sb[(t0 + u) * kTile + tid] = from_f<T>(carry);
      }
    }
    sync_channels();
    store_tile<T, kVec>(h + base, sb, len, d, c0);
  } else if (live) {
    walk<T, true, false>(a, b, h, base + c, d, len, carry, nullptr);
  }
}

// smem of one CTA of the kernel at chunk length L
template <typename T>
size_t tile_smem(int L) {
  return L <= max_chunk<T>() ? 2 * (size_t)L * kTile * sizeof(T) : 0;
}

// Raise the kernel's dynamic shared-memory limit to kTileBytes on the
// current device, once (a tile above 48 KB needs it).
template <typename T, bool kVec>
cudaError_t allow_smem(size_t smem) {
  static unsigned long long raised = 0;   // bit per device
  if (smem <= 32 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || (raised >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute(rglru_scan_kernel<T, kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTileBytes);
  if (err == cudaSuccess) raised |= 1ull << dev;
  return err;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, void* h,
           void* ints, void* vals, int B, int S, int d, int n,
           cudaStream_t stream) {
  if (B <= 0 || S <= 0 || d <= 0) return 0;
  if (n < 1 || n > S) return (int)cudaErrorInvalidValue;
  const int L = (S + n - 1) / n;
  if ((S + L - 1) / L != n) return (int)cudaErrorInvalidValue;
  if (n == 1) {
    rglru_walk_kernel<T><<<dim3((d + kTile - 1) / kTile, B), kTile, 0,
                           stream>>>(static_cast<const T*>(a),
                                     static_cast<const T*>(b), h0,
                                     static_cast<T*>(h), S, d);
    return (int)cudaGetLastError();
  }
  const size_t smem = tile_smem<T>(L);
  const bool vec = d % (16 / (int)sizeof(T)) == 0 && aligned16(a) &&
                   aligned16(b) && aligned16(h);
  const cudaError_t err = vec ? allow_smem<T, true>(smem)
                              : allow_smem<T, false>(smem);
  if (err != cudaSuccess) return (int)err;
  auto kernel = vec ? rglru_scan_kernel<T, true> : rglru_scan_kernel<T, false>;
  dim3 grid(n, (d + kTile - 1) / kTile, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(h), S, d, L, static_cast<int*>(ints),
      static_cast<float*>(vals));
  return (int)cudaGetLastError();
}

template <typename T>
int chunk_count(int B, int S, int d, int device) {
  int sms = 0, prev = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  const long long chains = (long long)B * ((d + kTile - 1) / kTile);
  if (chains >= sms || S <= kBatch) return 1;
  if ((err = cudaGetDevice(&prev)) != cudaSuccess ||
      (err = cudaSetDevice(device)) != cudaSuccess)
    return -(int)err;
  err = allow_smem<T, true>(kTileBytes);
  long long best = 1, best_waves = -1;
  for (int L = kBatch; err == cudaSuccess && L <= max_chunk<T>();
       L += kBatch) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rglru_scan_kernel<T, true>, kThreads, tile_smem<T>(L));
    const long long n = (S + L - 1) / L;
    const long long slots = (long long)(per_sm > 1 ? per_sm : 1) * sms;
    const long long waves = (chains * n + slots - 1) / slots;
    if (best_waves < 0 || waves < best_waves) {
      best = n;
      best_waves = waves;
    }
    if (n == 1) break;
  }
  cudaSetDevice(prev);
  if (err != cudaSuccess) return -(int)err;
  return (int)best;
}

}  // namespace

// dtype (of a, b and h): 0 = float32, 1 = bfloat16.  h0 is float32.
// n_chunks: a count rglru_chunk_count could return (ceil(S / L) for some
// chunk length L).  ints / vals: the status scratch (see the note above),
// ints zero, at least B·ceil(d/128)·(n_chunks + 2) ints and
// B·ceil(d/128)·n_chunks·384 floats.  Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* h, void* ints, void* vals, int B,
                                 int S, int d, int n_chunks, int dtype,
                                 void* stream) {
  const float* h0f = static_cast<const float*>(h0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, h0f, h, ints, vals, B, S, d, n_chunks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0f, h, ints, vals, B, S, d,
                                 n_chunks, s);
  return (int)cudaErrorInvalidValue;
}

// The chunk count for (B, S, d, dtype) on `device`: 1 where the B·ceil(d/
// 128) chains alone reach the SM count (the plain walk); else, over chunk
// lengths L that are multiples of kBatch up to the shared-memory tile,
// the fewest waves of CTAs at the kernel's occupancy, and among those the
// shortest L.  A negative value is -cudaError_t.
extern "C" int rglru_chunk_count(int B, int S, int d, int dtype, int device) {
  if (B <= 0 || S <= 0 || d <= 0) return 1;
  if (dtype == 0) return chunk_count<float>(B, S, d, device);
  if (dtype == 1) return chunk_count<__nv_bfloat16>(B, S, d, device);
  return -(int)cudaErrorInvalidValue;
}
