// Flash attention forward (streaming softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/flash_attention.py:
//   flash_attention_pallas (_flash_kernel without RoPE), forward
//   flash_attention_rope_pallas (_flash_kernel with RoPE on the loads)
// Their backward is flash_attention_bwd.cu.
//
// q: (B, H, T, HD); k, v: (B, KV, S, HD), head-major, f32 or bf16. Head h
// reads kv head h / (H / KV) (GQA). Key s is visible to query t iff
//   s < S, s <= t (causal), s > t - window (window > 0), s >= kv_offsets[b]
// (the left pad of a ragged prompt), the mask of _visibility_mask in the
// Pallas kernel. Writes o (B, H, T, HD) and, when asked, the f32 row
// logsumexp lse (B, H, T).
//
// With positions pos (B, T) f32 (self-attention, S == T: the training
// path's attention_full), every q and k tile is rotated in f32 right after
// its load (half-split RoPE, port::rope_pair, the rotation the decode
// kernels use), before the 1/sqrt(HD) scale: the separate rotations of the
// full q and k tensors never reach device memory. The ROPE template flag
// compiles the rotation in; without it the kernel is the one serving runs.
//
// A query row that sees no key at all (a left-pad row t < kv_offsets[b]) is
// written as 0 with lse = -inf. The Pallas kernel masks with the finite
// -1e30 and so writes there the mean of V over the blocks it visited, a
// value that depends on its block size. Those rows never reach a real row:
// their key/value slots are masked in every later attention and in decode.
//
// What bounds it: at the serving prefill (B = 8, H = 16, T = S = 512,
// HD = 128, causal) the two products are about 8.6 GFLOP per layer for
// 8 MB of q, k, v and o in bf16: arithmetic at the tensor-core rate, but
// this kernel multiplies with f32 FMAs, whose peak is 15x lower.
//
// Design (a first, simple kernel; tensor cores and TMA are later work): one
// block of 256 threads per (q block of 64 rows, head, batch row) walks the
// key blocks of 64 that intersect the visible band (blocks wholly above
// the causal frontier, older than the window, or before the row's offset
// are skipped) with an online softmax in f32. q (pre-scaled by 1/sqrt(HD)),
// k and v tiles are staged in shared memory as f32, rows padded by one
// float so the dot products read without bank conflicts. Four threads own
// one query row: each computes 16 of the 64 logits, the row max and sum
// are combined with warp shuffles, and each thread accumulates HD/4 output
// columns in registers, reading the probabilities of its row's other three
// threads by shuffle.

#include <math.h>

#include "common.cuh"

namespace {

using port::from_f;
using port::to_f;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 4 threads per query row

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * (HD + 1) + BK * (HD + 1) + BK * HD);
}

template <typename T, int HD, bool ROPE>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse,
                     const int* __restrict__ kv_offsets,
                     const float* __restrict__ pos, int H, int KV, int T_,
                     int S, int causal, int window, float scale,
                     float log_theta) {
  constexpr int QS = HD + 1;         // padded row stride of qs and ks
  constexpr int HALF = HD / 2;
  constexpr int CPT = HD / 4;        // output columns per thread
  constexpr int JPT = BK / 4;        // logits per thread per key block
  extern __shared__ float smem[];
  float* qs = smem;                  // BQ x QS
  float* ks = qs + BQ * QS;          // BK x QS
  float* vs = ks + BK * QS;          // BK x HD

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 2;          // query row in the block
  const int qtr = tid & 3;           // which quarter of the row
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q_start = blockIdx.x * BQ;
  const int kvh = h / (H / KV);
  const size_t q_base = (static_cast<size_t>(b) * H + h) * T_;
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S;
  const int off = kv_offsets != nullptr ? kv_offsets[b] : 0;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    const int t = q_start + r;
    const float qv = t < T_ ? to_f(q[(q_base + t) * HD + c]) : 0.f;
    qs[r * QS + c] = ROPE ? qv : qv * scale;
  }
  if constexpr (ROPE) {  // rotate, then scale (the rotation is linear)
    __syncthreads();
    for (int i = tid; i < BQ * HALF; i += THREADS) {
      const int r = i / HALF, j = i % HALF;
      const int t = q_start + r;
      float& x1 = qs[r * QS + j];
      float& x2 = qs[r * QS + j + HALF];
      if (t < T_)
        port::rope_pair(x1, x2, pos[static_cast<size_t>(b) * T_ + t], j,
                        HALF, log_theta);
      x1 *= scale;
      x2 *= scale;
    }
  }

  // the band of keys any row of this block can see
  const int q_last = min(q_start + BQ, T_) - 1;
  int k_hi = S;
  if (causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = max(0, off);
  if (window > 0) k_lo = max(k_lo, q_start - window + 1);

  const int t = q_start + row;
  float m = -INFINITY, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // qs is written; ks/vs of the last block are consumed
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, c = i % HD;
      const int s = k0 + r;
      const bool in = s < S;
      ks[r * QS + c] = in ? to_f(k[(kv_base + s) * HD + c]) : 0.f;
      vs[r * HD + c] = in ? to_f(v[(kv_base + s) * HD + c]) : 0.f;
    }
    if constexpr (ROPE) {  // keys hold positions pos[b, s] (S == T)
      __syncthreads();
      for (int i = tid; i < BK * HALF; i += THREADS) {
        const int r = i / HALF, j = i % HALF;
        const int s = k0 + r;
        if (s < S)
          port::rope_pair(ks[r * QS + j], ks[r * QS + j + HALF],
                          pos[static_cast<size_t>(b) * S + s], j, HALF,
                          log_theta);
      }
    }
    __syncthreads();

    float sc[JPT];
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) sc[jj] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < HD; d0 += 8) {
      float qv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[e] = qs[row * QS + d0 + e];
#pragma unroll
      for (int jj = 0; jj < JPT; ++jj) {
        const float* kr = ks + (jj * 4 + qtr) * QS + d0;
#pragma unroll
        for (int e = 0; e < 8; ++e) sc[jj] = fmaf(qv[e], kr[e], sc[jj]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int s = k0 + jj * 4 + qtr;
      bool ok = s < S && s >= off;
      if (causal) ok = ok && s <= t;
      if (window > 0) ok = ok && s > t - window;
      sc[jj] = ok ? sc[jj] : -INFINITY;
      mx = fmaxf(mx, sc[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);  // 0 while m is -inf
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      sc[jj] = expf(sc[jj] - m_use);  // 0 for masked keys
      psum += sc[jj];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float p =
            __shfl_sync(0xffffffffu, sc[jj], (lane & ~3) | src);
        const float* vr = vs + (jj * 4 + src) * HD + qtr;
#pragma unroll
        for (int i = 0; i < CPT; ++i) acc[i] = fmaf(p, vr[4 * i], acc[i]);
      }
    }
  }

  if (t < T_) {
    const size_t o_base = (q_base + t) * HD;
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      o[o_base + qtr + 4 * i] = from_f<T>(l > 0.f ? acc[i] / l : 0.f);
    if (lse != nullptr && qtr == 0)
      lse[q_base + t] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

template <typename T, int HD, bool ROPE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* kv_offsets, const float* pos, int B, int H, int KV,
           int T_, int S, int causal, int window, float scale,
           float log_theta, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<T, HD, ROPE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_ + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, kv_offsets, pos, H,
      KV, T_, S, causal, window, scale, log_theta);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_rope(const void* q, const void* k, const void* v, void* o,
                float* lse, const int* kv_offsets, const float* pos, int B,
                int H, int KV, int T_, int S, int causal, int window,
                float scale, float log_theta, cudaStream_t stream) {
  if (pos != nullptr)
    return launch<T, HD, true>(q, k, v, o, lse, kv_offsets, pos, B, H, KV,
                               T_, S, causal, window, scale, log_theta,
                               stream);
  return launch<T, HD, false>(q, k, v, o, lse, kv_offsets, pos, B, H, KV, T_,
                              S, causal, window, scale, log_theta, stream);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                float* lse, const int* kv_offsets, const float* pos, int B,
                int H, int KV, int T_, int S, int causal, int window,
                float scale, float log_theta, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_rope<T, 32>(q, k, v, o, lse, kv_offsets, pos, B, H, KV,
                                T_, S, causal, window, scale, log_theta,
                                stream);
    case 64:
      return launch_rope<T, 64>(q, k, v, o, lse, kv_offsets, pos, B, H, KV,
                                T_, S, causal, window, scale, log_theta,
                                stream);
    case 128:
      return launch_rope<T, 128>(q, k, v, o, lse, kv_offsets, pos, B, H, KV,
                                 T_, S, causal, window, scale, log_theta,
                                 stream);
    case 256:
      return launch_rope<T, 256>(q, k, v, o, lse, kv_offsets, pos, B, H, KV,
                                 T_, S, causal, window, scale, log_theta,
                                 stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B, H, T, hd); k, v (B, KV, S, hd); o like q; all of `dtype`,
// contiguous. lse (B, H, T) f32 or null; kv_offsets (B,) int32 or null;
// pos (B, T) f32 positions or null (no RoPE); with pos, S == T and
// log_theta = log(rope_theta). window <= 0 means no window. hd is 32, 64,
// 128 or 256.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, const int* kv_offsets, const float* pos,
                        int B, int H, int KV, int T_, int S, int hd,
                        int causal, int window, float scale, float log_theta,
                        int dtype, cudaStream_t stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || T_ < 1 || S < 1 ||
      B > 65535 || H > 65535 || (pos != nullptr && S != T_))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32)
    return dispatch_hd<float>(hd, q, k, v, o, lse, kv_offsets, pos, B, H, KV,
                              T_, S, causal, window, scale, log_theta,
                              stream);
  if (dtype == port::kBF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, kv_offsets, pos, B,
                                      H, KV, T_, S, causal, window, scale,
                                      log_theta, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
