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
//   dx = dg @ wg^T + du @ wu^T          (from dg and du as written)
// dg and du are written in x's type, dx in f32. dx is formed from the dg
// and du the kernel writes, the values from which the caller forms the
// weight gradients x^T @ dg and x^T @ du (plain GEMMs, kernels/ops.py, as
// in the reference): in bf16 each term is rounded once to 2^-9, as the TPU
// kernel's f32 dot at default precision rounds its operands to bf16.
//
// What bounds it: at the training shapes (N = 4096, d = 2048, F = 6144)
// the recompute and the two dx products are 3 * 2 * N * d * F = 309 GFLOP
// for about 0.3 GB: arithmetic.
//
// Two launches in order on the stream, for each of two bodies; the wrapper
// (kernels/swiglu.py:_body) picks one from (d, F, dtype), never from N:
// - bf16 with d and F multiples of 8: the persistent warp-specialised
//   wgmma block of hopper.cuh. swiglu_bwd_gate_wgmma_kernel computes
//   128 x 256 tiles of u (x tiles K-major, wu tiles MN-major: two
//   128-column halves), and its epilogue reads g and dh (prefetched into
//   L2 halfway through the tile's stages) and writes dg and du in bf16,
//   16 bytes a lane.
//   swiglu_bwd_dx_wgmma_kernel computes 128 x 256 tiles of dx by walking
//   K = 2F once: dg against the rows of wg, then du against the rows of wu
//   (both operands K-major: the rows of dg/du and of the (d, F) weights),
//   into one set of f32 accumulators. A block cannot carry the TPU
//   kernel's (rows, d) dx accumulator across the hidden axis, so dx is its
//   own pass over the written dg and du.
// - f32, and bf16 at other d or F: swiglu_bwd_gate_kernel computes a 64 x
//   64 tile of u as the forward's FMA body computes g (the x tile
//   transposed and the weight tile staged in shared memory as f32, 4 x 4
//   f32 FMA sub-tiles a thread) and writes dg and du;
//   swiglu_bwd_dx_kernel computes a 64 x 64 tile of dx by walking the F
//   axis twice (dg against the rows of wg, then du against the rows of wu)
//   into one f32 accumulator, the same 4 x 4 sub-tiles.
// Ragged edges are zero-filled on load and masked on store. Each output is
// computed in one fixed order by one thread: no split-K, no atomics.

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
    swiglu_bwd_gate_kernel(const T* __restrict__ x, const T* __restrict__ wu,
                           const T* __restrict__ g, const T* __restrict__ dh,
                           T* __restrict__ dg, T* __restrict__ du, int n,
                           int d, int f) {
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
    }
  }
}

// dx (n, d) f32 = dg (n, f) @ wg^T + du (n, f) @ wu^T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    swiglu_bwd_dx_kernel(const T* __restrict__ dg, const T* __restrict__ du,
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
    const T* a = part == 0 ? dg : du;
    const T* w = part == 0 ? wg : wu;
    for (int k0 = 0; k0 < f; k0 += BK) {
      const int row = m0 + lm;
      const int col = n0 + bn;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + lk + e;
        as[lk + e][lm] =
            (row < n && k < f) ? to_f(a[static_cast<size_t>(row) * f + k])
                               : 0.f;
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
           const void* dh, void* dg, void* du, float* dx, int n, int d, int f,
           cudaStream_t stream) {
  const dim3 gate_grid((f + BN - 1) / BN, (n + BM - 1) / BM);
  swiglu_bwd_gate_kernel<T><<<gate_grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wu),
      static_cast<const T*>(g), static_cast<const T*>(dh),
      static_cast<T*>(dg), static_cast<T*>(du), n, d, f);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 dx_grid((d + BN - 1) / BN, (n + BM - 1) / BM);
  swiglu_bwd_dx_kernel<T><<<dx_grid, THREADS, 0, stream>>>(
      static_cast<const T*>(dg), static_cast<const T*>(du),
      static_cast<const T*>(wg), static_cast<const T*>(wu), dx, n, d, f);
  return static_cast<int>(cudaGetLastError());
}

namespace hw = port::hopper;
using hw::bf16;

// Gate: a tile is 128 rows x 256 columns of u. Stage i: the x tile at
// depth 64 i and the wu tiles of columns n0 .. n0 + 255 (B0: the first
// 128, B1: the next; two boxes each). The epilogue takes acc0, acc1 = u of
// columns n0 + [0, 128) and n0 + [128, 256) and writes dg and du.
struct GateGemm {
  static constexpr int kCols = 2 * hw::kBN;
  const CUtensorMap *x, *wu, *mg, *mdh;
  const bf16 *g, *dh;
  bf16 *dg, *du;
  int n, f, m_blocks, n_blocks, ktiles;

  __device__ __forceinline__ void load(int m0, int n0, int i, bf16* a,
                                       bf16* b0, bf16* b1,
                                       uint64_t* bar) const {
    const int k0 = i * hw::kBK;
    hw::tma_load_2d(a, x, k0, m0, bar);
    hw::tma_load_2d(b0, wu, n0, k0, bar);
    hw::tma_load_2d(b0 + 64 * hw::kBK, wu, n0 + 64, k0, bar);
    hw::tma_load_2d(b1, wu, n0 + 128, k0, bar);
    hw::tma_load_2d(b1 + 64 * hw::kBK, wu, n0 + 192, k0, bar);
  }

  // g and dh of the tile, into L2 while its last stages run: 128 rows x
  // 256 columns of each, four 64-column boxes.
  __device__ __forceinline__ void prefetch(int m0, int n0) const {
#pragma unroll
    for (int b = 0; b < kCols / 64; ++b) {
      hw::tma_prefetch_2d(mg, n0 + 64 * b, m0);
      hw::tma_prefetch_2d(mdh, n0 + 64 * b, m0);
    }
  }

  // One accumulator row of the warpgroup (rows 8 apart: half = 0, 1) of
  // the 128 columns at c0: each lane loads 16 bytes of g and of dh for
  // each of four 8-column chunks (all eight loads before any store: the
  // stores could alias them for all the compiler knows), the quad
  // transposes them into the accumulator layout (hw::quad_transpose),
  // forms dg and du, transposes back and stores 16 bytes a lane.
  __device__ __forceinline__ void rows8(int row, int c0, int half,
                                        const float (&u)[64]) const {
    const int t = threadIdx.x % 4;
    uint4 graw[4], hraw[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int col = c0 + 8 * (4 * m + t);
      const bool ok = row < n && col < f;    // f % 8 == 0: chunks whole
      const size_t at = ok ? static_cast<size_t>(row) * f + col : 0;
      graw[m] = *reinterpret_cast<const uint4*>(g + at);
      hraw[m] = *reinterpret_cast<const uint4*>(dh + at);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t gw[4] = {graw[m].x, graw[m].y, graw[m].z, graw[m].w};
      uint32_t hw4[4] = {hraw[m].x, hraw[m].y, hraw[m].z, hraw[m].w};
      hw::quad_transpose(gw);
      hw::quad_transpose(hw4);
      uint32_t dgw[4], duw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 4 * (4 * m + j) + 2 * half;
        const float2 gv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&gw[j]));
        const float2 hv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hw4[j]));
        const float gs[2] = {gv.x, gv.y}, hs[2] = {hv.x, hv.y};
        float dgv[2], duv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float sig = 1.f / (1.f + expf(-gs[c]));
          duv[c] = hs[c] * gs[c] * sig;
          dgv[c] = hs[c] * u[e + c] * sig * (1.f + gs[c] * (1.f - sig));
        }
        dgw[j] = port::pack_bf16(dgv[0], dgv[1]);
        duw[j] = port::pack_bf16(duv[0], duv[1]);
      }
      hw::quad_transpose(dgw);
      hw::quad_transpose(duw);
      const int col = c0 + 8 * (4 * m + t);
      if (row < n && col < f) {
        const size_t at = static_cast<size_t>(row) * f + col;
        *reinterpret_cast<uint4*>(dg + at) =
            make_uint4(dgw[0], dgw[1], dgw[2], dgw[3]);
        *reinterpret_cast<uint4*>(du + at) =
            make_uint4(duw[0], duw[1], duw[2], duw[3]);
      }
    }
  }

  __device__ __forceinline__ void epilogue(int m0, int n0, int wgp,
                                           const float (&acc0)[64],
                                           const float (&acc1)[64]) const {
    const int r0 = m0 + 64 * wgp;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rows8(r0 + hw::acc_row(2 * half), n0, half, acc0);
      rows8(r0 + hw::acc_row(2 * half), n0 + hw::kBN, half, acc1);
    }
  }
};

__global__ void __launch_bounds__(hw::kThreads, 1)
    swiglu_bwd_gate_wgmma_kernel(const __grid_constant__ CUtensorMap mx,
                                 const __grid_constant__ CUtensorMap mu,
                                 const __grid_constant__ CUtensorMap mg,
                                 const __grid_constant__ CUtensorMap mdh,
                                 const bf16* __restrict__ g,
                                 const bf16* __restrict__ dh,
                                 bf16* __restrict__ dg, bf16* __restrict__ du,
                                 int n, int d, int f) {
  hw::gemm_persistent<true>(GateGemm{
      &mx, &mu, &mg, &mdh, g, dh, dg, du, n, f, (n + hw::kBM - 1) / hw::kBM,
      (f + GateGemm::kCols - 1) / GateGemm::kCols,
      (d + hw::kBK - 1) / hw::kBK});
}

// dx: a tile is 128 rows x 256 columns of dx, K = 2F deep: the first
// ceil(f / 64) stages walk dg against wg, the rest du against wu. Stage i:
// A, the dg or du tile at depth k0; B0, B1: rows j0 .. j0 + 127 and
// j0 + 128 .. j0 + 255 of the weight (its columns k0 .. k0 + 63). The
// epilogue stores acc0, acc1 (columns j0 + [0, 128), j0 + [128, 256)) in
// f32.
struct DxGemm {
  static constexpr int kCols = 2 * hw::kBN;
  const CUtensorMap *dg, *du, *wg, *wu;
  float* dx;
  int n, d, m_blocks, n_blocks, ktiles;

  __device__ __forceinline__ void load(int m0, int j0, int i, bf16* a,
                                       bf16* b0, bf16* b1,
                                       uint64_t* bar) const {
    const int kt = ktiles / 2;
    const bool second = i >= kt;
    const int k0 = (second ? i - kt : i) * hw::kBK;
    const CUtensorMap* w = second ? wu : wg;
    hw::tma_load_2d(a, second ? du : dg, k0, m0, bar);
    hw::tma_load_2d(b0, w, k0, j0, bar);
    hw::tma_load_2d(b1, w, k0, j0 + hw::kBN, bar);
  }

  __device__ __forceinline__ void prefetch(int, int) const {}

  __device__ __forceinline__ void epilogue(int m0, int j0, int wgp,
                                           const float (&acc0)[64],
                                           const float (&acc1)[64]) const {
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const int row = m0 + 64 * wgp + hw::acc_row(e);
      if (row >= n) continue;
      const int col = j0 + hw::acc_col(e);    // d % 8 == 0: pairs stay whole
      float* out = dx + static_cast<size_t>(row) * d + col;
      if (col < d)
        *reinterpret_cast<float2*>(out) = make_float2(acc0[e], acc0[e + 1]);
      if (col + hw::kBN < d)
        *reinterpret_cast<float2*>(out + hw::kBN) =
            make_float2(acc1[e], acc1[e + 1]);
    }
  }
};

__global__ void __launch_bounds__(hw::kThreads, 1)
    swiglu_bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap mdg,
                               const __grid_constant__ CUtensorMap mdu,
                               const __grid_constant__ CUtensorMap mwg,
                               const __grid_constant__ CUtensorMap mwu,
                               float* __restrict__ dx, int n, int d, int f) {
  hw::gemm_persistent<false>(DxGemm{
      &mdg, &mdu, &mwg, &mwu, dx, n, d, (n + hw::kBM - 1) / hw::kBM,
      (d + DxGemm::kCols - 1) / DxGemm::kCols,
      2 * ((f + hw::kBK - 1) / hw::kBK)});
}

}  // namespace

extern "C" {

// x (n, d); wg, wu (d, f); g, dh, dg, du (n, f): all of `dtype`,
// contiguous. dx (n, d) f32.
int swiglu_bwd(const void* x, const void* wg, const void* wu, const void* g,
               const void* dh, void* dg, void* du, float* dx, int n, int d,
               int f, int dtype, cudaStream_t stream) {
  if (n < 1 || d < 1 || f < 1 || (n + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32)
    return launch<float>(x, wg, wu, g, dh, dg, du, dx, n, d, f, stream);
  if (dtype == port::kBF16)
    return launch<__nv_bfloat16>(x, wg, wu, g, dh, dg, du, dx, n, d, f,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 wgmma body, the same operands: d and f multiples of 8, every
// pointer 16-byte aligned.
int swiglu_bwd_wgmma(const void* x, const void* wg, const void* wu,
                     const void* g, const void* dh, void* dg, void* du,
                     float* dx, int n, int d, int f, cudaStream_t stream) {
  if (n < 1 || d < 8 || f < 8 || d % 8 != 0 || f % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mu_mn, mg, mdh, mdg, mdu, mwg_k, mwu_k;
  int err = hw::tensor_map(&mx, x, n, d, hw::kBM, hw::kBK);
  if (err == 0) err = hw::tensor_map(&mg, g, n, f, hw::kBM, hw::kBK);
  if (err == 0) err = hw::tensor_map(&mdh, dh, n, f, hw::kBM, hw::kBK);
  if (err == 0) err = hw::tensor_map(&mu_mn, wu, d, f, hw::kBK, 64);
  if (err == 0) err = hw::tensor_map(&mdg, dg, n, f, hw::kBM, hw::kBK);
  if (err == 0) err = hw::tensor_map(&mdu, du, n, f, hw::kBM, hw::kBK);
  if (err == 0) err = hw::tensor_map(&mwg_k, wg, d, f, hw::kBN, hw::kBK);
  if (err == 0) err = hw::tensor_map(&mwu_k, wu, d, f, hw::kBN, hw::kBK);
  if (err != 0) return err;
  const int rows = (n + hw::kBM - 1) / hw::kBM;
  err = hw::launch_persistent(
      swiglu_bwd_gate_wgmma_kernel,
      rows * ((f + GateGemm::kCols - 1) / GateGemm::kCols), stream, mx,
      mu_mn, mg, mdh, static_cast<const bf16*>(g), static_cast<const bf16*>(dh),
      static_cast<bf16*>(dg), static_cast<bf16*>(du), n, d, f);
  if (err != 0) return err;
  return hw::launch_persistent(
      swiglu_bwd_dx_wgmma_kernel,
      rows * ((d + DxGemm::kCols - 1) / DxGemm::kCols), stream, mdg, mdu,
      mwg_k, mwu_k, dx, n, d, f);
}

}  // extern "C"
