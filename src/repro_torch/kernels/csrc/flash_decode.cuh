// The body shared by the flash decode kernels (flash_decode.cu: a
// contiguous head-major cache; flash_decode_paged.cu: a page pool behind a
// block table, bf16/f32 or int8 with per-slot scales).
//
// One block of 256 threads (8 warps) handles one (kv head, batch row). It
// holds the G = H / KV query rows of the GQA group in shared memory (scaled
// by 1/sqrt(HD), rotated by RoPE when asked), so each cached key and value
// is read once per step. The warps take the visible slots in turn
// (s = s_lo + warp, s_lo + warp + 8, ...): a warp reads one slot's key and
// value rows whole (each lane HD/32 consecutive elements, converted to f32
// by the slot source), forms the G logits with a warp reduction and
// updates its own online softmax (max, sum and HD/32 output columns per
// row in registers). At the end the 8 warps' partial softmaxes are merged
// through shared memory in warp order. A row that sees no slot is 0.
//
// The slot source is the only thing the two kernels change: given a slot
// index it loads that slot's key and value columns of this lane. The slot
// order, the arithmetic and the merge are this one body, so the paged
// kernel's output equals the contiguous kernel's bit for bit on the same
// cache contents.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace port {
namespace decode {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_GHD = 1024;  // G * HD: query rows of a group times width

__device__ __forceinline__ float load_f(float x) { return x; }
__device__ __forceinline__ float load_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float load_f(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// Slot s of a head-major (B, KV, S, HD) cache: element (row + s) * HD.
template <typename T>
struct ContiguousSlots {
  const T* __restrict__ k;
  const T* __restrict__ v;
  size_t row;  // (b * KV + kvh) * S

  template <int C>
  __device__ __forceinline__ void load(int s, int col, float (&kk)[C],
                                       float (&vv)[C]) const {
    const size_t at = (row + s) * (C * 32) + col;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      kk[c] = load_f(k[at + c]);
      vv[c] = load_f(v[at + c]);
    }
  }
};

// Logical slot s of row b lives in page pt[b, s / ps] at slot s % ps of a
// (pages, KV, ps, HD) pool. With T = int8_t the pool holds codes and
// ks/vs (pages, KV, ps) f32 the per-slot scales: k = code * scale in f32.
template <typename T>
struct PagedSlots {
  const T* __restrict__ k;
  const T* __restrict__ v;
  const float* __restrict__ ks;
  const float* __restrict__ vs;
  const int* __restrict__ pt_row;  // pt + b * NB
  int KV, kvh, ps;

  template <int C>
  __device__ __forceinline__ void load(int s, int col, float (&kk)[C],
                                       float (&vv)[C]) const {
    const int page = pt_row[s / ps];
    const size_t r = (static_cast<size_t>(page) * KV + kvh) * ps + s % ps;
    const size_t at = r * (C * 32) + col;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      kk[c] = load_f(k[at + c]);
      vv[c] = load_f(v[at + c]);
    }
    if constexpr (sizeof(T) == 1) {
      const float sk = ks[r], sv = vs[r];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        kk[c] *= sk;
        vv[c] *= sv;
      }
    }
  }
};

// q, o: (B, H, HD) of Q. Slots [0, S) of row b; slot s holds global
// position s, or pos - ((pos - s) mod S) for a ring. A slot is visible iff
// 0 <= gp <= pos, gp > pos - window (window > 0) and gp >= off.
template <typename Q, int HD, int G, typename Slots>
__device__ __forceinline__ void decode_block(
    const Q* __restrict__ q, Q* __restrict__ o, const Slots& slots, int b,
    int kvh, int pos, int off, int H, int S, int window, int ring, int rope,
    float log_theta, float scale) {
  constexpr int C = HD / 32;  // columns per lane
  __shared__ __align__(16) float qs[G * HD];
  __shared__ __align__(16) float wacc[WARPS][G * HD];
  __shared__ float wm[WARPS][G];
  __shared__ float wl[WARPS][G];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t q_base = (static_cast<size_t>(b) * H + kvh * G) * HD;

  for (int i = tid; i < G * HD; i += THREADS) qs[i] = load_f(q[q_base + i]);
  __syncthreads();
  if (rope) {
    constexpr int HALF = HD / 2;
    const float qpos = static_cast<float>(pos - off);
    for (int i = tid; i < G * HALF; i += THREADS) {
      const int r = i / HALF, j = i % HALF;
      float x1 = qs[r * HD + j], x2 = qs[r * HD + j + HALF];
      rope_pair(x1, x2, qpos, j, HALF, log_theta);
      qs[r * HD + j] = x1 * scale;
      qs[r * HD + j + HALF] = x2 * scale;
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
  for (int s = s_lo + warp; s < s_hi; s += WARPS) {
    const int gp = ring ? pos - floor_mod(pos - s, S) : s;
    bool ok = gp >= 0 && gp <= pos && gp >= off;
    if (window > 0) ok = ok && gp > pos - window;
    if (!ok) continue;  // uniform across the warp
    float kv[C], vv[C];
    slots.template load<C>(s, lane * C, kv, vv);
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        dot = fmaf(qs[r * HD + lane * C + c], kv[c], dot);
      dot = warp_sum(dot);
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
    o[q_base + i] = from_f<Q>(lsum > 0.f ? a / lsum : 0.f);
  }
}

}  // namespace decode
}  // namespace port
