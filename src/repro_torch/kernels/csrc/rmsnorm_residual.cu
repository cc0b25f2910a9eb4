// Fused residual add + RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/fused_norm.py:
//   rmsnorm_residual_pallas (_fwd_kernel)
//   rmsnorm_residual_backward_pallas (_bwd_kernel)
//
// x, r: (N, d) f32 or bf16, row-major; scale: (d,) f32. Writes
//   s = x + r                                 (rounded to the input type)
//   y = s * rsqrt(mean(s^2) + eps) * scale    (computed in f32, rounded)
// The norm reads the ROUNDED s, as the Pallas kernel and the oracle do.
// With no residual (r and s null) it is a plain RMSNorm: s is x, so the
// kernel reads x and writes y only (4 bytes an element in bf16).
//
// No matrix product: the kernel is bound by device-memory bytes, reading x
// and r once and writing s and y once (8 bytes an element in bf16). One
// block per row: each thread adds 16-byte vectors of x and r, writes s,
// keeps s in shared memory as f32 (so the row is read from device memory
// only once) and sums its squares; a block reduction gives the row's mean
// square, and a second pass over shared memory writes y. d is bounded by
// that shared-memory row: the wrapper takes d <= 8192 (32 KB).
//
// Backward, from the saved s and scale and the cotangents dy (of y) and ds
// (of s; null for the norms with no residual): with rstd = rsqrt(mean(s^2)
// + eps), s_hat = s * rstd and w = dy * scale,
//   dx = rstd * (w - s_hat * mean(w * s_hat)) + ds   (= dr, in s's type)
//   dscale = sum over rows of dy * s_hat             (f32)
// Also bound by bytes (read s, dy, ds; write dx: 8 bytes an element in
// bf16). Each block takes a run of rows, one row at a time: one pass over
// the row stages s and dy in shared memory as f32 and sums s^2 and w * s
// (mean(w * s_hat) = rstd * mean(w * s)); a second pass writes dx and adds
// dy * s_hat into the block's own per-column partial of dscale (each
// thread always owns the same columns). dscale is reduced in two stages,
// without atomics, so it repeats bit for bit: every block writes its
// partial row, then a second kernel sums the partials of each column in
// block order.

#include "common.cuh"

namespace {

using port::from_f;
using port::to_f;
using port::Vec16;

template <typename T, bool VEC, bool RES>
__global__ void rmsnorm_residual_kernel(const T* __restrict__ x,
                                        const T* __restrict__ r,
                                        const float* __restrict__ scale,
                                        T* __restrict__ y, T* __restrict__ s,
                                        int d, float eps) {
  extern __shared__ float srow[];  // d floats, then 32 for the reduction
  float* scratch = srow + d;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  if constexpr (VEC) {
    constexpr int V = Vec16<T>::N;
    for (int i = threadIdx.x * V; i < d; i += blockDim.x * V) {
      float a[V];
      port::load16<T>(x + base + i, a);
      if constexpr (RES) {
        float b[V];
        port::load16<T>(r + base + i, b);
#pragma unroll
        for (int e = 0; e < V; ++e) a[e] = to_f(from_f<T>(a[e] + b[e]));
        port::store16<T>(s + base + i, a);  // s rounded to T
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        srow[i + e] = a[e];
        ss += a[e] * a[e];
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      T sv = x[base + i];
      if constexpr (RES) {
        sv = from_f<T>(to_f(sv) + to_f(r[base + i]));
        s[base + i] = sv;
      }
      const float v = to_f(sv);
      srow[i] = v;
      ss += v * v;
    }
  }
  ss = port::block_sum(ss, scratch);  // also orders srow's writes
  const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
  if constexpr (VEC) {
    constexpr int V = Vec16<T>::N;
    for (int i = threadIdx.x * V; i < d; i += blockDim.x * V) {
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = srow[i + e] * rstd * scale[i + e];
      port::store16<T>(y + base + i, o);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      y[base + i] = from_f<T>(srow[i] * rstd * scale[i]);
    }
  }
}

template <typename T, bool RES>
int launch(const void* x, const void* r, const float* scale, void* y, void* s,
           int n, int d, float eps, int vec, cudaStream_t stream) {
  const int per_thread = vec ? Vec16<T>::N : 1;
  int threads = 32;
  while (threads < 1024 && threads * per_thread < d) threads *= 2;
  const size_t smem = (static_cast<size_t>(d) + 32) * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  T* yt = static_cast<T*>(y);
  T* st = static_cast<T*>(s);
  if (vec) {
    rmsnorm_residual_kernel<T, true, RES><<<n, threads, smem, stream>>>(
        xt, rt, scale, yt, st, d, eps);
  } else {
    rmsnorm_residual_kernel<T, false, RES><<<n, threads, smem, stream>>>(
        xt, rt, scale, yt, st, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const void* x, const void* r, const float* scale, void* y,
               void* s, int n, int d, float eps, int vec,
               cudaStream_t stream) {
  if (r != nullptr)
    return launch<T, true>(x, r, scale, y, s, n, d, eps, vec, stream);
  return launch<T, false>(x, r, scale, y, s, n, d, eps, vec, stream);
}

template <typename T, bool VEC, bool DS>
__global__ void rmsnorm_residual_bwd_kernel(
    const T* __restrict__ s, const float* __restrict__ scale,
    const T* __restrict__ dy, const T* __restrict__ ds, T* __restrict__ dx,
    float* __restrict__ partial, int n, int d, int rows_per_block,
    float eps) {
  extern __shared__ float sm[];  // s row, dy row, dscale partial, scratch
  float* srow = sm;
  float* grow = srow + d;
  float* acc = grow + d;
  float* scratch = acc + d;
  constexpr int V = VEC ? Vec16<T>::N : 1;
  const int stride = blockDim.x * V;
  for (int i = threadIdx.x * V; i < d; i += stride)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i + e] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const size_t base = static_cast<size_t>(row) * d;
    float ss = 0.f, ws = 0.f;
    for (int i = threadIdx.x * V; i < d; i += stride) {
      float a[V], g[V];
      if constexpr (VEC) {
        port::load16<T>(s + base + i, a);
        port::load16<T>(dy + base + i, g);
      } else {
        a[0] = to_f(s[base + i]);
        g[0] = to_f(dy[base + i]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        srow[i + e] = a[e];
        grow[i + e] = g[e];
        ss += a[e] * a[e];
        ws += g[e] * scale[i + e] * a[e];
      }
    }
    ss = port::block_sum(ss, scratch);
    ws = port::block_sum(ws, scratch);
    const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
    const float m = ws * rstd / static_cast<float>(d);  // mean(w * s_hat)
    for (int i = threadIdx.x * V; i < d; i += stride) {
      float o[V], c[V];
      if constexpr (DS) {
        if constexpr (VEC) {
          port::load16<T>(ds + base + i, c);
        } else {
          c[0] = to_f(ds[base + i]);
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float sh = srow[i + e] * rstd;
        const float g = grow[i + e];
        o[e] = rstd * (g * scale[i + e] - sh * m);
        if constexpr (DS) o[e] += c[e];
        acc[i + e] += g * sh;
      }
      if constexpr (VEC) {
        port::store16<T>(dx + base + i, o);
      } else {
        dx[base + i] = from_f<T>(o[0]);
      }
    }
  }
  for (int i = threadIdx.x * V; i < d; i += stride)
#pragma unroll
    for (int e = 0; e < V; ++e)
      partial[static_cast<size_t>(blockIdx.x) * d + i + e] = acc[i + e];
}

// dscale[c] = sum over the nblk partial rows, in block order.
__global__ void rmsnorm_residual_dscale_kernel(
    const float* __restrict__ partial, float* __restrict__ dscale, int nblk,
    int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += partial[static_cast<size_t>(b) * d + c];
  dscale[c] = acc;
}

template <typename T, bool VEC, bool DS>
int launch_bwd(const void* s, const float* scale, const void* dy,
               const void* ds, void* dx, float* partial, float* dscale, int n,
               int d, int nblk, int rows_per_block, float eps,
               cudaStream_t stream) {
  const int per_thread = VEC ? Vec16<T>::N : 1;
  int threads = 32;
  while (threads < 1024 && threads * per_thread < d) threads *= 2;
  const size_t smem = (3 * static_cast<size_t>(d) + 32) * sizeof(float);
  auto kernel = rmsnorm_residual_bwd_kernel<T, VEC, DS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nblk, threads, smem, stream>>>(
      static_cast<const T*>(s), scale, static_cast<const T*>(dy),
      static_cast<const T*>(ds), static_cast<T*>(dx), partial, n, d,
      rows_per_block, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_residual_dscale_kernel<<<(d + 255) / 256, 256, 0, stream>>>(
      partial, dscale, nblk, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_any(const void* s, const float* scale, const void* dy,
                   const void* ds, void* dx, float* partial, float* dscale,
                   int n, int d, int nblk, int rows_per_block, float eps,
                   int vec, cudaStream_t stream) {
  if (vec && ds != nullptr)
    return launch_bwd<T, true, true>(s, scale, dy, ds, dx, partial, dscale,
                                     n, d, nblk, rows_per_block, eps, stream);
  if (vec)
    return launch_bwd<T, true, false>(s, scale, dy, ds, dx, partial, dscale,
                                      n, d, nblk, rows_per_block, eps, stream);
  if (ds != nullptr)
    return launch_bwd<T, false, true>(s, scale, dy, ds, dx, partial, dscale,
                                      n, d, nblk, rows_per_block, eps, stream);
  return launch_bwd<T, false, false>(s, scale, dy, ds, dx, partial, dscale, n,
                                     d, nblk, rows_per_block, eps, stream);
}

}  // namespace

extern "C" {

// x, r, y, s: (n, d) of `dtype`; scale: (d,) f32. r and s are both null
// (no residual: y = rmsnorm(x) * scale) or both set. vec != 0 requires d to
// be a multiple of 16 / sizeof(element) and every pointer 16-byte aligned.
int rmsnorm_residual_fwd(const void* x, const void* r, const float* scale,
                         void* y, void* s, int n, int d, float eps, int dtype,
                         int vec, cudaStream_t stream) {
  if (n < 1 || d < 1 || (r == nullptr) != (s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32)
    return launch_any<float>(x, r, scale, y, s, n, d, eps, vec, stream);
  if (dtype == port::kBF16)
    return launch_any<__nv_bfloat16>(x, r, scale, y, s, n, d, eps, vec,
                                     stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// s, dy, ds, dx: (n, d) of `dtype`; scale, dscale: (d,) f32; partial:
// (nblk, d) f32 scratch, nblk * rows_per_block >= n. ds may be null (a
// zero cotangent on s). vec != 0 requires d to be a multiple of
// 16 / sizeof(element) and every pointer 16-byte aligned.
int rmsnorm_residual_bwd(const void* s, const float* scale, const void* dy,
                         const void* ds, void* dx, float* partial,
                         float* dscale, int n, int d, int nblk,
                         int rows_per_block, float eps, int dtype, int vec,
                         cudaStream_t stream) {
  if (n < 1 || d < 1 || nblk < 1 || rows_per_block < 1 ||
      static_cast<long long>(nblk) * rows_per_block < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32)
    return launch_bwd_any<float>(s, scale, dy, ds, dx, partial, dscale, n, d,
                                 nblk, rows_per_block, eps, vec, stream);
  if (dtype == port::kBF16)
    return launch_bwd_any<__nv_bfloat16>(s, scale, dy, ds, dx, partial,
                                         dscale, n, d, nblk, rows_per_block,
                                         eps, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
