// Fused SwiGLU backward (activation side) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/swiglu.py:
//   swiglu_backward_pallas (_bwd_kernel)
//
// x: (N, d), wg, wu: (d, F), g (the saved gate pre-activation) and dh: (N,
// F), all row-major, f32 or bf16. With u = x @ wu recomputed (it is never
// saved) and sig = sigmoid(g), in f32:
//   du = dh * g * sig
//   dg = dh * u * sig * (1 + g * (1 - sig))
//   dx = dg @ wg^T + du @ wu^T          (from the f32 dg and du)
// dg and du are written in x's type, dx in f32. The weight gradients
// x^T @ dg and x^T @ du are plain GEMMs outside (kernels/ops.py), as in the
// reference.
//
// What bounds it: at the training shapes (N = 4096, d = 2048, F = 6144)
// the recompute and the two dx products are 3 * 2 * N * d * F = 309 GFLOP
// for about 0.3 GB: arithmetic.
//
// Design (a first, simple kernel; tensor cores and TMA are later work), two
// launches in order on the stream:
// - swiglu_bwd_gate_kernel: one block computes a 64 x 64 tile of u as the
//   forward kernel computes g (the x tile transposed and the weight tile
//   staged in shared memory as f32, 4 x 4 f32 FMA sub-tiles a thread), then
//   its epilogue reads g and dh and writes dg and du. For a bf16 x it also
//   writes dg and du in f32 to scratch, so dx is formed from the unrounded
//   values as in the reference.
// - swiglu_bwd_dx_kernel: one block computes a 64 x 64 tile of dx by
//   walking the F axis twice (dg against the rows of wg, then du against
//   the rows of wu) into one f32 accumulator, the same 4 x 4 sub-tiles.
// Ragged edges are zero-filled on load and masked on store. Each output is
// computed in one fixed order by one thread: no atomics.

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
    swiglu_bwd_gate_kernel(const T* __restrict__ x, const T* __restrict__ wu,
                           const T* __restrict__ g, const T* __restrict__ dh,
                           T* __restrict__ dg, T* __restrict__ du,
                           float* __restrict__ dgf, float* __restrict__ duf,
                           int n, int d, int f) {
  __shared__ __align__(16) float xs[BK][BM];
  __shared__ __align__(16) float us[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int lm = tid / 4, lk = (tid % 4) * 4;
  const int wk = tid / 16, wn = (tid % 16) * 4;

  float acc[4][4] = {};
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
        us[wk][wn + e] = (k < d && col < f)
                             ? to_f(wu[static_cast<size_t>(k) * f + col])
                             : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&us[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
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
      const size_t at = static_cast<size_t>(row) * f + col;
      const float gv = to_f(g[at]);
      const float hv = to_f(dh[at]);
      const float sig = 1.f / (1.f + expf(-gv));
      const float duv = hv * gv * sig;
      const float dgv = hv * acc[i][j] * sig * (1.f + gv * (1.f - sig));
      dg[at] = from_f<T>(dgv);
      du[at] = from_f<T>(duv);
      if (dgf != nullptr) {
        dgf[at] = dgv;
        duf[at] = duv;
      }
    }
  }
}

// dx (n, d) f32 = dg (n, f) @ wg^T + du (n, f) @ wu^T; dg, du f32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    swiglu_bwd_dx_kernel(const float* __restrict__ dg,
                         const float* __restrict__ du,
                         const T* __restrict__ wg, const T* __restrict__ wu,
                         float* __restrict__ dx, int n, int d, int f) {
  __shared__ __align__(16) float as[BK][BM];
  __shared__ __align__(16) float bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;  // rows of dx
  const int n0 = blockIdx.x * BN;  // columns of dx (the d axis)
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int lm = tid / 4, lk = (tid % 4) * 4;  // A tile row, k..k+3
  const int bn = tid / 4, bk = (tid % 4) * 4;  // B tile column, k..k+3

  float acc[4][4] = {};
  for (int part = 0; part < 2; ++part) {
    const float* a = part == 0 ? dg : du;
    const T* w = part == 0 ? wg : wu;
    for (int k0 = 0; k0 < f; k0 += BK) {
      const int row = m0 + lm;
      const int col = n0 + bn;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + lk + e;
        as[lk + e][lm] =
            (row < n && k < f) ? a[static_cast<size_t>(row) * f + k] : 0.f;
        const int kb = k0 + bk + e;
        bs[bk + e][bn] = (col < d && kb < f)
                             ? to_f(w[static_cast<size_t>(col) * f + kb])
                             : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 av4 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 bv4 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float av[4] = {av4.x, av4.y, av4.z, av4.w};
        const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < d) dx[static_cast<size_t>(row) * d + col] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* g,
           const void* dh, void* dg, void* du, float* dgf, float* duf,
           float* dx, int n, int d, int f, cudaStream_t stream) {
  // f32: dg and du are their own f32 copies
  const bool f32 = sizeof(T) == sizeof(float);
  const dim3 gate_grid((f + BN - 1) / BN, (n + BM - 1) / BM);
  swiglu_bwd_gate_kernel<T><<<gate_grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wu),
      static_cast<const T*>(g), static_cast<const T*>(dh),
      static_cast<T*>(dg), static_cast<T*>(du), f32 ? nullptr : dgf,
      f32 ? nullptr : duf, n, d, f);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* a = f32 ? static_cast<const float*>(dg) : dgf;
  const float* c = f32 ? static_cast<const float*>(du) : duf;
  const dim3 dx_grid((d + BN - 1) / BN, (n + BM - 1) / BM);
  swiglu_bwd_dx_kernel<T><<<dx_grid, THREADS, 0, stream>>>(
      a, c, static_cast<const T*>(wg), static_cast<const T*>(wu), dx, n, d,
      f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (n, d); wg, wu (d, f); g, dh, dg, du (n, f): all of `dtype`,
// contiguous. dx (n, d) f32. dgf, duf (n, f) f32 scratch for a bf16 x
// (ignored, and may be null, for f32).
int swiglu_bwd(const void* x, const void* wg, const void* wu, const void* g,
               const void* dh, void* dg, void* du, float* dgf, float* duf,
               float* dx, int n, int d, int f, int dtype,
               cudaStream_t stream) {
  if (n < 1 || d < 1 || f < 1 || (n + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32)
    return launch<float>(x, wg, wu, g, dh, dg, du, dgf, duf, dx, n, d, f,
                         stream);
  if (dtype == port::kBF16) {
    if (dgf == nullptr || duf == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<__nv_bfloat16>(x, wg, wu, g, dh, dg, du, dgf, duf, dx, n, d,
                                 f, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
