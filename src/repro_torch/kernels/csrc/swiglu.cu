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
// Two bodies; the wrapper (kernels/swiglu.py:_body) picks one from (d, F,
// dtype), never from N:
// - swiglu_wgmma_kernel, bf16 with d and F multiples of 8 (TMA's 16-byte
//   row strides): the persistent warp-specialised block of hopper.cuh. A
//   tile is 128 rows x 128 columns of BOTH g and u, so each x tile feeds
//   the two products: a stage holds the x tile (128 x 64, K-major) and the
//   wg and wu tiles (64 x 128 each, MN-major: the weights are (d, F)
//   row-major), and each consumer warpgroup accumulates its 64 rows of g
//   and of u on wgmma (128 f32 registers a thread). The epilogue forms
//   silu(g) * u from the f32 sums and stores g and h in bf16 (16 bytes a
//   lane), masked at ragged N and F; rows and depth past the ends arrive
//   from TMA as zeros. At decode the same body
//   streams the weights through the four-stage ring (4 x 32 KB of weight
//   tiles in flight a block); a warpgroup whose rows are all past N issues
//   no products.
// - swiglu_kernel (f32, and bf16 at other d or F): one block computes a
//   64 x 64 tile of both g and u with f32 FMAs. The d axis is walked in
//   steps of 16: 256 threads stage the x tile (transposed) and the two
//   weight tiles in shared memory as f32, then each thread accumulates a
//   4 x 4 sub-tile of g and of u (32 FMAs per three 16-byte shared loads).
//   Ragged N, d and F edges are zero-filled on load and masked on store.

#include "common.cuh"
#include "hopper.cuh"

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

namespace hw = port::hopper;

// A tile: 128 rows x 128 columns of both g and u. Stage i: the x tile at
// depth 64 i and the wg, wu tiles of columns n0 .. n0 + 127 (two 64-column
// boxes each). The epilogue takes acc0 = g, acc1 = u of the warpgroup's 64
// rows and stores g and silu(g) * u in bf16.
struct FwdGemm {
  static constexpr int kCols = hw::kBN;
  const CUtensorMap *x, *wg, *wu;
  hw::bf16 *h, *g;
  int n, f, m_blocks, n_blocks, ktiles;

  __device__ __forceinline__ void load(int m0, int n0, int i, hw::bf16* a,
                                       hw::bf16* b0, hw::bf16* b1,
                                       uint64_t* bar) const {
    const int k0 = i * hw::kBK;
    hw::tma_load_2d(a, x, k0, m0, bar);
    hw::tma_load_2d(b0, wg, n0, k0, bar);
    hw::tma_load_2d(b0 + 64 * hw::kBK, wg, n0 + 64, k0, bar);
    hw::tma_load_2d(b1, wu, n0, k0, bar);
    hw::tma_load_2d(b1 + 64 * hw::kBK, wu, n0 + 64, k0, bar);
  }

  __device__ __forceinline__ void prefetch(int, int) const {}

  // Each quad packs its words of four 8-column chunks, transposes them
  // (hw::quad_transpose) and stores 16 bytes a lane.
  __device__ __forceinline__ void epilogue(int m0, int n0, int wgp,
                                           const float (&acc0)[64],
                                           const float (&acc1)[64]) const {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + 64 * wgp + hw::acc_row(2 * half);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t gw[4], hw4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 4 * (4 * m + j) + 2 * half;
          const float g0 = acc0[e], g1 = acc0[e + 1];
          gw[j] = port::pack_bf16(g0, g1);
          hw4[j] = port::pack_bf16(g0 * (1.f / (1.f + expf(-g0))) * acc1[e],
                                   g1 * (1.f / (1.f + expf(-g1))) *
                                       acc1[e + 1]);
        }
        hw::quad_transpose(gw);
        hw::quad_transpose(hw4);
        const int col = n0 + 8 * (4 * m + threadIdx.x % 4);
        if (row < n && col < f) {     // f % 8 == 0: chunks stay whole
          const size_t at = static_cast<size_t>(row) * f + col;
          *reinterpret_cast<uint4*>(g + at) =
              make_uint4(gw[0], gw[1], gw[2], gw[3]);
          *reinterpret_cast<uint4*>(h + at) =
              make_uint4(hw4[0], hw4[1], hw4[2], hw4[3]);
        }
      }
    }
  }
};

__global__ void __launch_bounds__(hw::kThreads, 1)
    swiglu_wgmma_kernel(const __grid_constant__ CUtensorMap mx,
                        const __grid_constant__ CUtensorMap mg,
                        const __grid_constant__ CUtensorMap mu,
                        hw::bf16* __restrict__ h, hw::bf16* __restrict__ g,
                        int n, int d, int f) {
  hw::gemm_persistent<true>(
      FwdGemm{&mx, &mg, &mu, h, g, n, f, (n + hw::kBM - 1) / hw::kBM,
              (f + hw::kBN - 1) / hw::kBN, (d + hw::kBK - 1) / hw::kBK});
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

// The bf16 wgmma body: x (n, d); wg, wu (d, f); h, g (n, f); d and f
// multiples of 8, every pointer 16-byte aligned.
int swiglu_fwd_wgmma(const void* x, const void* wg, const void* wu, void* h,
                     void* g, int n, int d, int f, cudaStream_t stream) {
  if (n < 1 || d < 8 || f < 8 || d % 8 != 0 || f % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mg, mu;
  int err = hw::tensor_map(&mx, x, n, d, hw::kBM, hw::kBK);
  if (err == 0) err = hw::tensor_map(&mg, wg, d, f, hw::kBK, 64);
  if (err == 0) err = hw::tensor_map(&mu, wu, d, f, hw::kBK, 64);
  if (err != 0) return err;
  const int tiles =
      ((f + hw::kBN - 1) / hw::kBN) * ((n + hw::kBM - 1) / hw::kBM);
  return hw::launch_persistent(swiglu_wgmma_kernel, tiles, stream, mx, mg, mu,
                          static_cast<hw::bf16*>(h),
                          static_cast<hw::bf16*>(g), n, d, f);
}

}  // extern "C"
