// Flash decode: one query row per sequence against a head-major KV cache,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:
//   flash_decode_pallas (_flash_decode_kernel, with _slot_visibility)
//
// q: (B, H, HD); k, v: (B, KV, S, HD), f32 or bf16. pos: each row's query
// position, a scalar or a per-row (B,) int32 array read on the device.
// Slot s holds global position gp = s, or gp = pos - ((pos - s) mod S) for
// a ring buffer; it is visible iff 0 <= gp <= pos, gp > pos - window
// (window > 0) and gp >= offsets[b] (left pad). With rope, q is rotated
// in-kernel by pos - offsets[b] (half-split RoPE, freq_i =
// exp(-(i / (HD/2)) * log(theta)), as _rope_rotate of the Pallas kernels);
// the cached keys were rotated when they were written. A row that sees no
// slot is written as 0.
//
// What bounds it: per step it must read the visible part of the cache,
// 2 * KV * (pos + 1) * HD elements per row, for 4 FLOPs per element per
// query head: bytes (at B = 8, KV = 8, S = 544, HD = 128 in bf16, 18 MB).
//
// Design (a first, simple kernel; split-KV is later work): one block of 256
// threads (8 warps) per (kv head, batch row) holds the G = H / KV query rows
// of the GQA group in shared memory, so each cached key and value is read
// once per step. The warps take the visible slots in turn: a warp reads
// one slot's key and value rows whole (each lane HD/32 consecutive
// elements), forms the G logits with a warp reduction and updates its own
// online softmax (max, sum and HD/32 output columns per row in registers).
// Slots outside [offset, pos] (or outside the window) are never visited
// unless the cache is a ring, whose slot order is not monotone in position.
// At the end the 8 warps' partial softmaxes are merged through shared
// memory. Only B * KV blocks run (64 on 132 SMs at B = 8, KV = 8).

#include <math.h>

#include "common.cuh"

namespace {

using port::from_f;
using port::to_f;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_GHD = 1024;  // G * HD: query rows of a group times width

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        const int* __restrict__ pos_rows, int pos_scalar,
                        const int* __restrict__ offsets, int H, int KV, int S,
                        int window, int ring, int rope, float log_theta,
                        float scale) {
  constexpr int C = HD / 32;  // columns per lane
  __shared__ __align__(16) float qs[G * HD];
  __shared__ __align__(16) float wacc[WARPS][G * HD];
  __shared__ float wm[WARPS][G];
  __shared__ float wl[WARPS][G];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int pos = pos_rows != nullptr ? pos_rows[b] : pos_scalar;
  const int off = offsets != nullptr ? offsets[b] : 0;
  const size_t q_base = (static_cast<size_t>(b) * H + kvh * G) * HD;

  for (int i = tid; i < G * HD; i += THREADS) qs[i] = to_f(q[q_base + i]);
  __syncthreads();
  if (rope) {
    constexpr int HALF = HD / 2;
    const float qpos = static_cast<float>(pos - off);
    for (int i = tid; i < G * HALF; i += THREADS) {
      const int r = i / HALF, j = i % HALF;
      const float ang =
          qpos * expf(-(static_cast<float>(j) / HALF) * log_theta);
      float sn, cs;
      sincosf(ang, &sn, &cs);
      const float x1 = qs[r * HD + j], x2 = qs[r * HD + j + HALF];
      qs[r * HD + j] = (x1 * cs - x2 * sn) * scale;
      qs[r * HD + j + HALF] = (x1 * sn + x2 * cs) * scale;
    }
  } else {
    for (int i = tid; i < G * HD; i += THREADS) qs[i] *= scale;
  }
  __syncthreads();

  // slots worth visiting; a ring visits all and masks per slot
  int s_lo = 0, s_hi = S;
  if (!ring) {
    s_hi = min(S, pos + 1);
    s_lo = max(0, off);
    if (window > 0) s_lo = max(s_lo, pos - window + 1);
  }

  float m[G], l[G], acc[G][C];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S;
  for (int s = s_lo + warp; s < s_hi; s += WARPS) {
    const int gp = ring ? pos - floor_mod(pos - s, S) : s;
    bool ok = gp >= 0 && gp <= pos && gp >= off;
    if (window > 0) ok = ok && gp > pos - window;
    if (!ok) continue;  // uniform across the warp
    const size_t at = (kv_base + s) * HD + lane * C;
    float kv[C], vv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      kv[c] = to_f(k[at + c]);
      vv[c] = to_f(v[at + c]);
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) dot = fmaf(qs[r * HD + lane * C + c], kv[c], dot);
      dot = port::warp_sum(dot);
      const float m_new = fmaxf(m[r], dot);
      const float alpha = expf(m[r] - m_new);
      const float p = expf(dot - m_new);
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c] * alpha);
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < G; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) wacc[warp][r * HD + lane * C + c] = acc[r][c];
    if (lane == 0) {
      wm[warp][r] = m[r];
      wl[warp][r] = l[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += THREADS) {
    const int r = i / HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w][r]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float f = expf(wm[w][r] - mx);  // 0 for a warp that saw none
        lsum = fmaf(wl[w][r], f, lsum);
        a = fmaf(wacc[w][i], f, a);
      }
    }
    o[q_base + i] = from_f<T>(lsum > 0.f ? a / lsum : 0.f);
  }
}

template <typename T, int HD, int G>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* pos_rows, int pos_scalar, const int* offsets, int B,
           int H, int KV, int S, int window, int ring, int rope,
           float log_theta, float scale, cudaStream_t stream) {
  if constexpr (G * HD > MAX_GHD) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const dim3 grid(KV, B);
    flash_decode_kernel<T, HD, G><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), pos_rows, pos_scalar,
        offsets, H, KV, S, window, ring, rope, log_theta, scale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int HD>
int dispatch_g(int g, const void* q, const void* k, const void* v, void* o,
               const int* pos_rows, int pos_scalar, const int* offsets, int B,
               int H, int KV, int S, int window, int ring, int rope,
               float log_theta, float scale, cudaStream_t stream) {
#define PORT_DECODE_G(GV)                                                    \
  case GV:                                                                   \
    return launch<T, HD, GV>(q, k, v, o, pos_rows, pos_scalar, offsets, B,  \
                             H, KV, S, window, ring, rope, log_theta, scale, \
                             stream);
  switch (g) {
    PORT_DECODE_G(1)
    PORT_DECODE_G(2)
    PORT_DECODE_G(4)
    PORT_DECODE_G(8)
    PORT_DECODE_G(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PORT_DECODE_G
}

template <typename T>
int dispatch_hd(int hd, int g, const void* q, const void* k, const void* v,
                void* o, const int* pos_rows, int pos_scalar,
                const int* offsets, int B, int H, int KV, int S, int window,
                int ring, int rope, float log_theta, float scale,
                cudaStream_t stream) {
#define PORT_DECODE_HD(HV)                                                  \
  case HV:                                                                  \
    return dispatch_g<T, HV>(g, q, k, v, o, pos_rows, pos_scalar, offsets, \
                             B, H, KV, S, window, ring, rope, log_theta,   \
                             scale, stream);
  switch (hd) {
    PORT_DECODE_HD(32)
    PORT_DECODE_HD(64)
    PORT_DECODE_HD(128)
    PORT_DECODE_HD(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PORT_DECODE_HD
}

}  // namespace

extern "C" {

// q (B, H, hd); k, v (B, KV, S, hd); o like q; all of `dtype`, contiguous.
// pos_rows (B,) int32 or null (then every row is at pos_scalar); offsets
// (B,) int32 or null. window <= 0 means none. hd is 32, 64, 128 or 256;
// H / KV is 1, 2, 4, 8 or 16 with (H / KV) * hd <= 1024.
int flash_decode_fwd(const void* q, const void* k, const void* v, void* o,
                     const int* pos_rows, int pos_scalar, const int* offsets,
                     int B, int H, int KV, int S, int hd, int window, int ring,
                     int rope, float log_theta, float scale, int dtype,
                     cudaStream_t stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || S < 1 || B > 65535 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = H / KV;
  if (dtype == port::kF32)
    return dispatch_hd<float>(hd, g, q, k, v, o, pos_rows, pos_scalar, offsets,
                              B, H, KV, S, window, ring, rope, log_theta,
                              scale, stream);
  if (dtype == port::kBF16)
    return dispatch_hd<__nv_bfloat16>(hd, g, q, k, v, o, pos_rows, pos_scalar,
                                      offsets, B, H, KV, S, window, ring, rope,
                                      log_theta, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
