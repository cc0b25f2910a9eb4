// Fused residual add + RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_norm.py:
//   rmsnorm_residual_pallas (_fwd_kernel)
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

}  // extern "C"
