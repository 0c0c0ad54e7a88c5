// Causal / sliding-window GQA flash attention for Hopper (sm_90a): the
// prefill attention of every layer.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, body `_kernel`).  Layouts are the JAX package's:
//   q (B,H,S,dh); k/v (B,KVH,S,dh); out (B,H,S,dh); H % KVH == 0; dh a
//   multiple of 8, at most 256.
// Unlike the TPU kernel, S need not be a multiple of the tile: the ragged
// tail is masked, since prefill runs prompts of any length.
//
// What bounds it on the H100: operations.  Causal attention does about
// 2·S²·dh flops per head against 4·S·dh elements moved, so past a few
// hundred tokens the work is far above the ridge point, and only the
// tensor cores come near the bound.
//
// Two kernels, chosen by the storage type (a fixed dispatch, not a
// fallback: a bf16 call that cannot launch returns its error):
//
// bf16: `flash_mma_kernel`, the FlashAttention-2 structure on
// mma.sync.m16n8k16 (bf16 in, fp32 accumulators).  One CTA of 4 warps per
// (64-row query tile, b, h); each warp owns 16 query rows.  The Q tile and a
// 2-stage ring of K and V tiles (64 keys; 32 at dh 256) sit in shared memory
// as bf16, loaded by 16-byte cp.async (tile k+1 in flight while tile k is
// used), rows XOR-swizzled in 16-byte chunks so that ldmatrix reads are free
// of bank conflicts.  S = Q·Kᵀ takes A (Q, re-read by ldmatrix every k-step
// rather than held in registers) and B (K) by ldmatrix; the online softmax
// runs in fp32 registers with scale·log2(e) folded into exp2f (the scores
// are never rounded; q is not pre-scaled); P is rounded to bf16 in registers
// and is directly the A operand of O += P·V, V coming in by ldmatrix.trans.
// Head dims are compile-time buckets 64, 128 and 256; any other dh (a
// multiple of 8) is zero-padded in shared memory to the next bucket and the
// padded output columns are not written.  Shared memory, Q + 2 × (K + V): 80
// KB at 128 (two CTAs per SM), 96 KB at 256 (two: 32-key tiles halve the
// ring and the score registers; 64-key tiles there take 160 KB, one 4-warp
// CTA per SM, and spill registers).
//
// fp32: `flash_attention_kernel`, on the CUDA cores, because a
// tensor-core product in fp32 means TF32 (~3 decimal digits), which
// cannot meet the fp32 tolerance.  One CTA of 256 threads per (64-row
// query tile, b, h).  The query tile and one 64-row K and V tile at a
// time sit in shared memory as fp32, loaded with 16-byte vectors; each
// thread owns a 4×4 block of the score tile and a 4×(dh/16) block of the
// output in registers, reads shared memory as float4 where the layout
// allows, and keeps the online softmax in fp32.  The probabilities reuse
// the K tile's shared memory, so two CTAs fit on an SM up to dh 128; at
// dh 256 the three fp32 tiles take 4·(64·260 + 64·260 + 64·256) =
// 198,656 bytes and one CTA fits.
//
// Both: the KV range of each query tile is bounded to the blocks its
// causal/window mask can reach (first_blk..last_blk, as the TPU kernel
// bounds its grid); masked scores are skipped rather than multiplied by
// zero; query tiles are issued longest-first so the causal triangle's
// heavy tiles start early (in the bf16 kernel across every (b, h): the
// query tile is the slow grid dimension, so no head's longest tile waits
// for another head's short ones).  The bf16 kernel applies the mask only
// on the tiles that cross the diagonal, the window edge or the ragged
// tail.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kMaxDh = 256;
constexpr int kPd = kBK + 4;        // probability row stride (float4-aligned)
constexpr float kNegInf = -1e30f;

// reduce over the 16 lanes that share one thread row (tx = lane & 15)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [row0, row0+64) of a (S, dh) matrix into shared memory as
// fp32 with row stride ld, scaling by `scale`; rows past S become zeros.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int row0, int S, int dh, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = dh / kVec;
  for (int i = threadIdx.x; i < 64 * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * kVec;
    float f[kVec];
    if (row0 + r < S) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * dh + c);
      unpack(u, f, T());
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(dst + r * ld + c + e) =
          make_float4(f[e] * scale, f[e + 1] * scale, f[e + 2] * scale,
                      f[e + 3] * scale);
  }
}

// floats of the region holding the K tile and, after the scores, the
// probabilities
__host__ __device__ __forceinline__ int kp_size(int ld) {
  return kBK * ld > kBQ * kPd ? kBK * ld : kBQ * kPd;
}

// output column of a thread's chunk c (tx = column lane of the thread)
template <bool VEC4>
__device__ __forceinline__ int col(int c, int tx) {
  return VEC4 ? 64 * (c >> 2) + tx * 4 + (c & 3) : tx + 16 * c;
}

// NC = output column chunks of 16 per thread row (dh <= 16*NC).  VEC4:
// dh == 16*NC with NC a multiple of 4, so a thread owns runs of 4
// adjacent columns (tx*4 + 64*h ..) and reads V as float4.  Up to NC = 8
// two CTAs share an SM (at most 128 registers a thread); at NC = 16 the
// shared memory admits one, so a thread may take 255 registers for its 64
// accumulators rather than spill them.
template <typename T, int NC, bool VEC4>
__global__ void __launch_bounds__(kThreads, NC > 8 ? 1 : 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int KVH, int S, int dh, int causal, int window,
                       float scale) {
  const int nq = gridDim.x;
  const int qb = nq - 1 - blockIdx.x;          // longest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;      // 16 x 16 thread grid
  const int ld = dh + 4;                       // padded, float4-aligned rows

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // kBQ * ld
  float* k_s = q_s + kBQ * ld;                 // K tile, then P (kBQ*kPd)
  float* v_s = k_s + kp_size(ld);              // kBK * dh
  float* p_s = k_s;

  const T* qg = q + ((long long)b * H + h) * S * dh;
  const T* kg = k + ((long long)b * KVH + kvh) * S * dh;
  const T* vg = v + ((long long)b * KVH + kvh) * S * dh;
  const int q0 = qb * kBQ;
  stage(q_s, ld, qg, q0, S, dh, scale);

  // KV blocks this query tile's mask can reach
  const int q_last = (q0 + kBQ - 1 < S - 1) ? q0 + kBQ - 1 : S - 1;
  const int n_kb = (S + kBK - 1) / kBK;
  const int last_blk = causal ? q_last / kBK : n_kb - 1;
  int first_blk = 0;
  if (window > 0 && q0 - window + 1 > 0) first_blk = (q0 - window + 1) / kBK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kb = first_blk; kb <= last_blk; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();                           // previous tile fully used
    stage(k_s, ld, kg, k0, S, dh, 1.f);
    stage(v_s, dh, vg, k0, S, dh, 1.f);
    __syncthreads();

    // scores for rows ty+16i, cols tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; d += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bb[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bb[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bb[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bb[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bb[j].w, s[i][j]);
        }
    }
    __syncthreads();                           // K tile read: P reuses it

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool o = kpos < S;
        if (causal) o = o && kpos <= qpos;
        if (window > 0) o = o && qpos - kpos < window;
        ok[j] = o;
        if (o) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * kPd + tx + 16 * j] = p;
        sum += p;
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + row_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr[i];
    for (int j = 0; j < kBK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPd + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vr = v_s + (j + jj) * dh;
        float vv[NC];
        if (VEC4) {
#pragma unroll
          for (int c = 0; c < NC; c += 4) {
            const float4 w = *reinterpret_cast<const float4*>(vr + col<VEC4>(c, tx));
            vv[c] = w.x;
            vv[c + 1] = w.y;
            vv[c + 2] = w.z;
            vv[c + 3] = w.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c) vv[c] = col<VEC4>(c, tx) < dh ? vr[col<VEC4>(c, tx)] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? p4[i].x : jj == 1 ? p4[i].y
                        : jj == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + ((long long)b * H + h) * S * dh + (long long)row * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (col<VEC4>(c, tx) < dh)
        o[col<VEC4>(c, tx)] = from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int NC, bool VEC4>
int launch_nc(const void* q, const void* k, const void* v, void* out, int B,
              int H, int KVH, int S, int dh, int causal, int window,
              float scale, cudaStream_t stream) {
  const int ld = dh + 4;
  const size_t smem = sizeof(float) * (kBQ * ld + kp_size(ld) + kBK * dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NC, VEC4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, NC, VEC4><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KVH, S, dh, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KVH, int S, int dh, int causal, int window, float scale,
           cudaStream_t stream) {
  if (dh % 8 || dh > kMaxDh) return (int)cudaErrorInvalidValue;
  if (dh == 256)
    return launch_nc<T, 16, true>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  if (dh == 128)
    return launch_nc<T, 8, true>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  if (dh == 64)
    return launch_nc<T, 4, true>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  if (dh <= 16)
    return launch_nc<T, 1, false>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  if (dh <= 32)
    return launch_nc<T, 2, false>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  if (dh <= 64)
    return launch_nc<T, 4, false>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  if (dh <= 128)
    return launch_nc<T, 8, false>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  return launch_nc<T, 16, false>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
}

// ------------------------------------------------------------ bf16, mma
constexpr int kMmaThreads = 128;    // 4 warps, 16 query rows each

// Rows [row0, row0 + ROWS) of a (S, dh) bf16 matrix into a swizzled tile
// of ROWS rows of DH, by cp.async; rows past S and columns past dh are
// zeros.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int S, int dh) {
  constexpr int kChunks = DH / 8;
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kMmaThreads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < S && c * 8 < dh;
    const __nv_bfloat16* g = ok ? src + (long long)(row0 + r) * dh + c * 8
                                : src;
    cp_async16(dst + swz<DH>(r, c), g, ok ? 16 : 0);
  }
}

// DH: the head-dim bucket (64, 128 or 256), dh <= DH the real one; BK:
// keys per K/V tile; MINB: CTAs per SM the registers must allow.
// Thread (warp w, lane) holds, of each 16×8 accumulator tile, rows
// r_lo = 16w + lane/4 and r_lo + 8, columns 2·(lane%4) and +1.
template <int DH, int BK, int MINB>
__global__ void __launch_bounds__(kMmaThreads, MINB)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int H, int KVH, int S,
                 int dh, int causal, int window, float scale_log2) {
  constexpr uint32_t kQBytes = kBQ * DH * 2;
  constexpr uint32_t kTileBytes = BK * DH * 2;   // one K or V tile
  constexpr int kNT = BK / 8;      // 8-key column tiles of the scores
  constexpr int kDT = DH / 8;      // 8-column tiles of the output
  // grid (B·H, nq): the CTAs of one query tile index start together for
  // every (b, h), longest tiles first
  const int nq = gridDim.y;
  const int qb = nq - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Q tile, then the ring: stage st holds K, then V
  extern __shared__ float4 smem4[];
  const uint32_t s_q = smem_addr(smem4);

  const __nv_bfloat16* qg = q + ((long long)b * H + h) * S * dh;
  const __nv_bfloat16* kg = k + ((long long)b * KVH + kvh) * S * dh;
  const __nv_bfloat16* vg = v + ((long long)b * KVH + kvh) * S * dh;
  const int q0 = qb * kBQ;
  const int q_last = (q0 + kBQ - 1 < S - 1) ? q0 + kBQ - 1 : S - 1;
  const int n_kb = (S + BK - 1) / BK;
  const int last_blk = causal ? q_last / BK : n_kb - 1;
  int first_blk = 0;
  if (window > 0 && q0 - window + 1 > 0) first_blk = (q0 - window + 1) / BK;

  load_tile<DH, kBQ>(s_q, qg, q0, S, dh);
  load_tile<DH, BK>(s_q + kQBytes, kg, first_blk * BK, S, dh);
  load_tile<DH, BK>(s_q + kQBytes + kTileBytes, vg, first_blk * BK, S, dh);
  cp_async_commit();

  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int r_lo = q0 + warp * 16 + (lane >> 2);
  const int c_lo = 2 * (lane & 3);

  for (int kb = first_blk; kb <= last_blk; ++kb) {
    const int st = (kb - first_blk) & 1;
    if (kb < last_blk) {                       // next tile in flight
      const uint32_t nxt = s_q + kQBytes + 2 * (st ^ 1) * kTileBytes;
      load_tile<DH, BK>(nxt, kg, (kb + 1) * BK, S, dh);
      load_tile<DH, BK>(nxt + kTileBytes, vg, (kb + 1) * BK, S, dh);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const uint32_t s_k = s_q + kQBytes + 2 * st * kTileBytes;
    const uint32_t s_v = s_k + kTileBytes;

    // S = Q·Kᵀ for this warp's 16 rows × BK keys
    float sc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, s_q + swz<DH>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, s_k + swz<DH>(n * 8 + (lane & 7) + ((lane >> 4) << 3),
                                  2 * kk + ((lane >> 3) & 1)));
        mma16816(sc[n], a, bb[0], bb[1]);
        mma16816(sc[n + 1], a, bb[2], bb[3]);
      }
    }

    // mask only the tiles that cross the diagonal, the window edge or the
    // ragged tail; masked scores become the sentinel and then exactly 0
    const int k0 = kb * BK;
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0)
                      || (window > 0 && q_last - k0 >= window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = r_lo + (e >> 1) * 8;
          const int kp = k0 + n * 8 + c_lo + (e & 1);
          bool ok = kp < S;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && qp - kp < window;
          if (!ok) sc[n][e] = kNegInf;
        }
    }

    // online softmax in fp32: rows r_lo (i = 0) and r_lo + 8 (i = 1),
    // reduced over the quad of lanes that share them
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    float corr[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f((m[i] - mx[i]) * scale_log2);
      m[i] = mx[i];
      mc[i] = mx[i] * scale_log2;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(sc[n][e], scale_log2, -mc[e >> 1]));
        if (edge && sc[n][e] == kNegInf) p = 0.f;
        sc[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P·V: P rounded to bf16 in registers is the A fragment of each
    // 16-key step
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kDT; j += 2) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, s_v + swz<DH>(kk * 16 + (lane & 15),
                                        j + (lane >> 4)));
        mma16816(o[j], pa, bb[0], bb[1]);
        mma16816(o[j + 1], pa, bb[2], bb[3]);
      }
    }
    __syncthreads();                 // stage st is refilled next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  __nv_bfloat16* og = out + ((long long)b * H + h) * S * dh;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int c = j * 8 + c_lo;
    if (c >= dh) continue;                     // padded columns
    if (r_lo < S)
      *reinterpret_cast<uint32_t*>(og + (long long)r_lo * dh + c) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (r_lo + 8 < S)
      *reinterpret_cast<uint32_t*>(og + (long long)(r_lo + 8) * dh + c) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

template <int DH, int BK, int MINB>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int H, int KVH, int S, int dh, int causal, int window,
               float scale, cudaStream_t stream) {
  const int smem = (kBQ + 4 * BK) * DH * 2;     // Q + 2 × (K + V)
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DH, BK, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_mma_kernel<DH, BK, MINB><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      H, KVH, S, dh, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// bf16: the head-dim bucket at or above dh
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int H, int KVH, int S, int dh, int causal, int window,
                float scale, cudaStream_t stream) {
  if (dh % 8 || dh > kMaxDh) return (int)cudaErrorInvalidValue;
  if (dh <= 64)
    return launch_mma<64, 64, 4>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  if (dh <= 128)
    return launch_mma<128, 64, 2>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
  return launch_mma<256, 32, 2>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, stream);
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core
// kernel).  causal: 0/1.  window <= 0 = none.  Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int KVH, int S, int dh, int causal,
                                      int window, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, H, KVH, S, dh, causal, window, scale, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, B, H, KVH, S, dh, causal, window, scale,
                       s);
  return (int)cudaErrorInvalidValue;
}
