// Fused SwiGLU front half for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/swiglu.py:
//   swiglu_pallas (_fwd_kernel)
//
// x: (N, d), wg, wu: (d, F), all row-major, f32 or bf16. Writes
//   g = x @ wg                  (the gate pre-activation the backward keeps)
//   h = silu(g) * (x @ wu)      (computed from the f32 sums, then rounded)
// Both products accumulate in f32; u = x @ wu is never written.
//
// What bounds it: at prefill (N = 4096 rows of d = 2048 into F = 6144) the
// two products are 2 * 2 * N * d * F = 206 GFLOP, far above the card's
// balance point, so the bound is arithmetic. At decode (N = 8) the kernel
// must read both weight matrices (50 MB in bf16) for 0.4 GFLOP: bytes.
//
// Design (a first, simple kernel; tensor cores, TMA and split-K are later
// work): one block computes a 64 x 64 tile of BOTH g and u, so each x tile
// is read once for the two products. The d axis is walked in steps of 16:
// 256 threads stage the x tile (transposed) and the two weight tiles in
// shared memory as f32, then each thread accumulates a 4 x 4 sub-tile of g
// and of u with f32 FMAs (32 FMAs per three 16-byte shared loads). The
// silu product runs in the epilogue on the f32 sums. Ragged N, d and F
// edges are zero-filled on load and masked on store.

#include "common.cuh"

namespace {

using port::from_f;
using port::to_f;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    swiglu_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                  const T* __restrict__ wu, T* __restrict__ h,
                  T* __restrict__ g, int n, int d, int f) {
  __shared__ __align__(16) float xs[BK][BM];
  __shared__ __align__(16) float gs[BK][BN];
  __shared__ __align__(16) float us[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // cols tx*4 .. tx*4+3

  // loaders: x tile row lm, k lk..lk+3; weight tile k wk, cols wn..wn+3
  const int lm = tid / 4, lk = (tid % 4) * 4;
  const int wk = tid / 16, wn = (tid % 16) * 4;

  float acc_g[4][4] = {};
  float acc_u[4][4] = {};

  for (int k0 = 0; k0 < d; k0 += BK) {
    {
      const int row = m0 + lm;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + lk + e;
        xs[lk + e][lm] =
            (row < n && k < d) ? to_f(x[static_cast<size_t>(row) * d + k])
                               : 0.f;
      }
      const int k = k0 + wk;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + wn + e;
        const bool ok = k < d && col < f;
        const size_t at = static_cast<size_t>(k) * f + col;
        gs[wk][wn + e] = ok ? to_f(wg[at]) : 0.f;
        us[wk][wn + e] = ok ? to_f(wu[at]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 bg = *reinterpret_cast<const float4*>(&gs[kk][tx * 4]);
      const float4 bu = *reinterpret_cast<const float4*>(&us[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {bg.x, bg.y, bg.z, bg.w};
      const float uv[4] = {bu.x, bu.y, bu.z, bu.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_g[i][j] = fmaf(av[i], gv[j], acc_g[i][j]);
          acc_u[i][j] = fmaf(av[i], uv[j], acc_u[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= f) continue;
      const float gv = acc_g[i][j];
      const size_t at = static_cast<size_t>(row) * f + col;
      g[at] = from_f<T>(gv);
      h[at] = from_f<T>(gv * (1.f / (1.f + expf(-gv))) * acc_u[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, void* h, void* g,
           int n, int d, int f, cudaStream_t stream) {
  const dim3 grid((f + BN - 1) / BN, (n + BM - 1) / BM);
  swiglu_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<T*>(h), static_cast<T*>(g), n, d,
      f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (n, d); wg, wu (d, f); h, g (n, f); all of `dtype`, contiguous.
int swiglu_fwd(const void* x, const void* wg, const void* wu, void* h,
               void* g, int n, int d, int f, int dtype, cudaStream_t stream) {
  if (n < 1 || d < 1 || f < 1 || (n + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32) return launch<float>(x, wg, wu, h, g, n, d, f, stream);
  if (dtype == port::kBF16)
    return launch<__nv_bfloat16>(x, wg, wu, h, g, n, d, f, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
