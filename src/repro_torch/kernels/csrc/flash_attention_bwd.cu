// Flash attention backward (recomputation from the row logsumexp) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/flash_attention.py:
//   flash_attention_backward_pallas (_recompute_p_ds, _flash_bwd_dq_kernel,
//   _flash_bwd_dkv_kernel; the split path)
//
// q, o, do: (B, H, T, HD); k, v: (B, KV, S, HD), head-major, f32 or bf16;
// lse: (B, H, T) f32, the forward's row logsumexp. Head h reads kv head
// h / (H / KV). Key s is visible to query t iff s < S, s <= t (causal) and
// s > t - window (window > 0), the mask of flash_attention.cu. With
// scale = 1/sqrt(HD), everything in f32:
//
//   delta = rowsum(do * o)                          (flash_bwd_delta_kernel)
//   p  = exp(q k^T * scale - lse)    (0 where not visible)
//   ds = p * (do v^T - delta)
//   dv = p^T do,  dk = ds^T q * scale               (flash_bwd_dkv_kernel)
//   dq = ds k * scale                               (flash_bwd_dq_kernel)
//
// dq, dk, dv are written in the input dtype. Nothing (T, S)-sized is ever
// stored: each kernel rebuilds its p and ds tiles from q, k, v, do, lse and
// delta. For RoPE attention the wrapper rotates q and k before and dq, dk
// back after (flash_attention_rope_backward).
//
// What bounds it: at the training shapes (B = 8, H = 16, KV = 8, T = S =
// 512, HD = 128, causal) the five products over the visible pairs are
// about 22 GFLOP for about 100 MB of inputs and outputs in bf16:
// arithmetic at the tensor-core rate; these f32 FMA tiles are far from it.
//
// Design (a first, simple kernel, deterministic: no atomics):
// - flash_bwd_dkv_kernel: one block of 256 threads per (key block of 64,
//   kv head, batch row). It keeps its k and v tiles in shared memory and
//   walks every q head of its GQA group and every q block of 64 that sees
//   the key block, accumulating dk and dv in registers, so the group's sum
//   is formed in one fixed order and dk, dv are written once in (B, KV, S,
//   HD). Four threads own one key row: each scores 16 of the 64 query rows
//   (q.k and do.v), and the row's p and ds are exchanged by warp shuffles
//   for the HD/4 output columns each thread accumulates.
// - flash_bwd_dq_kernel: one block per (q block of 64, head, batch row)
//   walks the key blocks of its band, as the forward does, recomputing p
//   and ds; four threads own one query row.
// Tiles are staged as f32 in shared memory, rows padded by one float: 4
// tiles of 64 x (HD + 1), 132 KB at HD = 128, so HD <= 128.

#include <math.h>

#include "common.cuh"

namespace {

using port::from_f;
using port::to_f;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 4 threads per tile row
constexpr int ROW_WARPS = 8;  // flash_bwd_delta_kernel: one warp per row

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ + BK) * 2 * (HD + 1) + 2 * BQ);
}

__device__ __forceinline__ bool visible(int t, int s, int T_, int S,
                                        int causal, int window) {
  bool ok = t < T_ && s < S;
  if (causal) ok = ok && s <= t;
  if (window > 0) ok = ok && s > t - window;
  return ok;
}

// Loads rows [r0, r0 + 64) of a (rows, HD) matrix into a padded f32 tile;
// rows at or past n are 0.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          size_t base, int r0, int n) {
  constexpr int QS = HD + 1;
  for (int i = threadIdx.x; i < 64 * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    const int t = r0 + r;
    dst[r * QS + c] = t < n ? to_f(src[(base + t) * HD + c]) : 0.f;
  }
}

// delta[row] = sum_c do[row, c] * o[row, c] over rows = B * H * T.
template <typename T, int HD>
__global__ void __launch_bounds__(ROW_WARPS * 32)
    flash_bwd_delta_kernel(const T* __restrict__ o,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, size_t rows) {
  constexpr int C = HD / 32;
  const size_t row = static_cast<size_t>(blockIdx.x) * ROW_WARPS +
                     (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const size_t at = row * HD + lane + 32 * c;
    acc = fmaf(to_f(dout[at]), to_f(o[at]), acc);
  }
  acc = port::warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int H, int KV, int T_,
               int S, int causal, int window, float scale) {
  constexpr int QS = HD + 1;
  constexpr int CPT = HD / 4;  // output columns per thread
  constexpr int JPT = BQ / 4;  // query rows scored per thread per q block
  extern __shared__ float smem[];
  float* ks = smem;            // BK x QS
  float* vs = ks + BK * QS;    // BK x QS
  float* qs = vs + BK * QS;    // BQ x QS
  float* dos = qs + BQ * QS;   // BQ x QS
  float* lses = dos + BQ * QS; // BQ
  float* dls = lses + BQ;      // BQ

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 2;    // key row in the block
  const int qtr = tid & 3;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int k_start = blockIdx.x * BK;
  const int G = H / KV;
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S;
  load_tile<T, HD>(ks, k, kv_base, k_start, S);
  load_tile<T, HD>(vs, v, kv_base, k_start, S);

  // the queries any key of this block is visible to
  const int k_last = min(k_start + BK, S) - 1;
  const int q_lo = causal ? k_start : 0;
  int q_hi = T_;
  if (window > 0) q_hi = min(q_hi, k_last + window);
  const int s = k_start + row;

  float acc_k[CPT], acc_v[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const size_t q_base = (static_cast<size_t>(b) * H + kvh * G + g) * T_;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // k/v are staged; the last q block is consumed
      load_tile<T, HD>(qs, q, q_base, q0, T_);
      load_tile<T, HD>(dos, dout, q_base, q0, T_);
      if (tid < BQ) {
        const int t = q0 + tid;
        lses[tid] = t < T_ ? lse[q_base + t] : 0.f;
        dls[tid] = t < T_ ? delta[q_base + t] : 0.f;
      }
      __syncthreads();

      float sc[JPT], dp[JPT];
#pragma unroll
      for (int jj = 0; jj < JPT; ++jj) sc[jj] = dp[jj] = 0.f;
#pragma unroll 2
      for (int d0 = 0; d0 < HD; d0 += 8) {
        float kv[8], vv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          kv[e] = ks[row * QS + d0 + e];
          vv[e] = vs[row * QS + d0 + e];
        }
#pragma unroll
        for (int jj = 0; jj < JPT; ++jj) {
          const float* qr = qs + (jj * 4 + qtr) * QS + d0;
          const float* dr = dos + (jj * 4 + qtr) * QS + d0;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            sc[jj] = fmaf(kv[e], qr[e], sc[jj]);
            dp[jj] = fmaf(vv[e], dr[e], dp[jj]);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < JPT; ++jj) {
        const int j = jj * 4 + qtr;
        const float p = visible(q0 + j, s, T_, S, causal, window)
                            ? expf(sc[jj] * scale - lses[j])
                            : 0.f;
        sc[jj] = p;
        dp[jj] = p * (dp[jj] - dls[j]);
      }
      // dv[s] += sum_j p_j do_j; dk[s] += sum_j ds_j q_j (scaled at the end)
#pragma unroll
      for (int jj = 0; jj < JPT; ++jj) {
#pragma unroll
        for (int src = 0; src < 4; ++src) {
          const float p = __shfl_sync(0xffffffffu, sc[jj], (lane & ~3) | src);
          const float ds = __shfl_sync(0xffffffffu, dp[jj], (lane & ~3) | src);
          const int j = jj * 4 + src;
          const float* dor = dos + j * QS + qtr;
          const float* qr = qs + j * QS + qtr;
#pragma unroll
          for (int i = 0; i < CPT; ++i) {
            acc_v[i] = fmaf(p, dor[4 * i], acc_v[i]);
            acc_k[i] = fmaf(ds, qr[4 * i], acc_k[i]);
          }
        }
      }
    }
  }

  if (s < S) {
    const size_t at = (kv_base + s) * HD + qtr;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      dk[at + 4 * i] = from_f<T>(acc_k[i] * scale);
      dv[at + 4 * i] = from_f<T>(acc_v[i]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int H, int KV, int T_, int S, int causal,
              int window, float scale) {
  constexpr int QS = HD + 1;
  constexpr int CPT = HD / 4;
  constexpr int JPT = BK / 4;  // keys scored per thread per key block
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x QS
  float* dos = qs + BQ * QS;   // BQ x QS
  float* ks = dos + BQ * QS;   // BK x QS
  float* vs = ks + BK * QS;    // BK x QS
  float* lses = vs + BK * QS;  // BQ
  float* dls = lses + BQ;      // BQ

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 2;    // query row in the block
  const int qtr = tid & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q_start = blockIdx.x * BQ;
  const int kvh = h / (H / KV);
  const size_t q_base = (static_cast<size_t>(b) * H + h) * T_;
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S;
  load_tile<T, HD>(qs, q, q_base, q_start, T_);
  load_tile<T, HD>(dos, dout, q_base, q_start, T_);
  if (tid < BQ) {
    const int t = q_start + tid;
    lses[tid] = t < T_ ? lse[q_base + t] : 0.f;
    dls[tid] = t < T_ ? delta[q_base + t] : 0.f;
  }

  // the band of keys any row of this block can see
  const int q_last = min(q_start + BQ, T_) - 1;
  int k_hi = S;
  if (causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(k_lo, q_start - window + 1);
  const int t = q_start + row;

  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // q/do are staged; the last k/v block is consumed
    load_tile<T, HD>(ks, k, kv_base, k0, S);
    load_tile<T, HD>(vs, v, kv_base, k0, S);
    __syncthreads();
    const float lrow = lses[row], drow = dls[row];

    float sc[JPT], dp[JPT];
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) sc[jj] = dp[jj] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < HD; d0 += 8) {
      float qv[8], dv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qv[e] = qs[row * QS + d0 + e];
        dv[e] = dos[row * QS + d0 + e];
      }
#pragma unroll
      for (int jj = 0; jj < JPT; ++jj) {
        const float* kr = ks + (jj * 4 + qtr) * QS + d0;
        const float* vr = vs + (jj * 4 + qtr) * QS + d0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sc[jj] = fmaf(qv[e], kr[e], sc[jj]);
          dp[jj] = fmaf(dv[e], vr[e], dp[jj]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const float p = visible(t, k0 + jj * 4 + qtr, T_, S, causal, window)
                          ? expf(sc[jj] * scale - lrow)
                          : 0.f;
      dp[jj] = p * (dp[jj] - drow);
    }
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float ds = __shfl_sync(0xffffffffu, dp[jj], (lane & ~3) | src);
        const float* kr = ks + (jj * 4 + src) * QS + qtr;
#pragma unroll
        for (int i = 0; i < CPT; ++i) acc[i] = fmaf(ds, kr[4 * i], acc[i]);
      }
    }
  }

  if (t < T_) {
    const size_t at = (q_base + t) * HD + qtr;
#pragma unroll
    for (int i = 0; i < CPT; ++i) dq[at + 4 * i] = from_f<T>(acc[i] * scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int B, int H, int KV, int T_, int S, int causal,
           int window, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const size_t rows = static_cast<size_t>(B) * H * T_;
  const size_t nblk = (rows + ROW_WARPS - 1) / ROW_WARPS;
  if (nblk > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_delta_kernel<T, HD>
      <<<static_cast<unsigned>(nblk), ROW_WARPS * 32, 0, stream>>>(
          static_cast<const T*>(o), dot, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t smem = smem_bytes<HD>();
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  flash_bwd_dkv_kernel<T, HD><<<dim3((S + BK - 1) / BK, KV, B), THREADS, smem,
                      stream>>>(qt, kt, vt, dot, lse, delta,
                                static_cast<T*>(dk), static_cast<T*>(dv), H,
                                KV, T_, S, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, HD><<<dim3((T_ + BQ - 1) / BQ, H, B), THREADS, smem,
                     stream>>>(qt, kt, vt, dot, lse, delta,
                               static_cast<T*>(dq), H, KV, T_, S, causal,
                               window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* o, const float* lse, const void* dout, void* dq,
                void* dk, void* dv, float* delta, int B, int H, int KV,
                int T_, int S, int causal, int window, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, KV,
                           T_, S, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, KV,
                           T_, S, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H,
                            KV, T_, S, causal, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, H, T, hd); k, v, dk, dv (B, KV, S, hd); all of
// `dtype`, contiguous. lse (B, H, T) f32; delta (B, H, T) f32 scratch.
// window <= 0 means no window. hd is 32, 64 or 128.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const float* lse, const void* dout,
                        void* dq, void* dk, void* dv, float* delta, int B,
                        int H, int KV, int T_, int S, int hd, int causal,
                        int window, float scale, int dtype,
                        cudaStream_t stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || T_ < 1 || S < 1 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32)
    return dispatch_hd<float>(hd, q, k, v, o, lse, dout, dq, dk, dv, delta, B,
                              H, KV, T_, S, causal, window, scale, stream);
  if (dtype == port::kBF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, dout, dq, dk, dv,
                                      delta, B, H, KV, T_, S, causal, window,
                                      scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
