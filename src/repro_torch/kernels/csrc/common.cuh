// Shared helpers of the port's CUDA kernels: element types, conversions to
// and from f32, 16-byte vector loads and stores, a block-wide sum and the
// RoPE rotation.
//
// Every kernel takes f32 or bf16 tensors (a dtype code from the wrapper:
// 0 = float32, 1 = bfloat16) and computes in f32. bf16 values are rounded
// to nearest even, as PyTorch and XLA round them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace port {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements of T in one 16-byte vector.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

// Loads N = Vec16<T>::N consecutive elements from a 16-byte aligned address.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[Vec16<T>::N]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) v[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&v)[Vec16<T>::N]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) e[i] = from_f<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the result. `scratch` holds 32
// floats of shared memory. blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by an earlier call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : 0.f;
  return warp_sum(v);
}

// Half-split RoPE of one pair (x1 = element j, x2 = element j + half of a
// row) at position pos, with freq_j = exp(-(j / half) * log(theta)): the
// rotation of repro.kernels.flash_attention._rope_rotate. The decode kernels
// (the query row) and the flash attention forward (its q and k tiles) all
// rotate through this one function, so they cannot drift apart.
__device__ __forceinline__ void rope_pair(float& x1, float& x2, float pos,
                                          int j, int half, float log_theta) {
  const float ang = pos * expf(-(static_cast<float>(j) /
                                 static_cast<float>(half)) * log_theta);
  float sn, cs;
  sincosf(ang, &sn, &cs);
  const float a = x1, b = x2;
  x1 = a * cs - b * sn;
  x2 = a * sn + b * cs;
}

}  // namespace port
