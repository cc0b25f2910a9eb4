// Ghost Batch Normalization forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gbn.py:
//   gbn_forward_pallas  (_stats_kernel + _normalize_kernel)
//   gbn_backward_pallas (_bwd_stats_kernel + _bwd_dx_kernel)
//
// Every kernel works on one f32 tensor laid out (G, R, C): G ghost batches,
// R rows per ghost (ghost_batch * H * W for a convolution), C channels
// innermost and contiguous. There is no matrix product here, so each kernel
// is bound by device-memory bytes: the forward reads x twice (statistics,
// then normalize) and writes y once, the backward reads x and dy twice and
// writes dx once. Nothing activation-sized is written besides y and dx.
//
// Work split, the same in every kernel: blockIdx.y is the ghost, blockIdx.x
// a chunk of `chunk_rows` rows. Thread t owns the VEC consecutive channels
// starting at (t % CV) * VEC, CV = C / VEC, and the rows lane, lane + L, ...
// of its chunk, lane = t / CV, L = blockDim.x / CV. A warp so reads one
// contiguous run of memory with 16-byte loads (VEC = 4), and each thread
// keeps its channels' per-(ghost, channel) coefficients in registers. The
// ragged edge of R is masked by the chunk bounds; C is never padded.
//
// Reductions over R cross blocks, and blocks run in no order, so each
// statistics kernel writes per-chunk partials and a second small kernel
// merges them in a fixed order (deterministic). The forward keeps
// (mean, M2) partials merged with Chan's formula, so the variance does not
// cancel the way sum(x^2)/R - mean^2 does at R = 131072.
//
// Each exported function launches its kernels on the given stream and
// returns cudaGetLastError() as an int (0 on success).

#include <cuda_runtime.h>

namespace {

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __ldg(p + k);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

struct Slot {
  int cv;         // channel group: channels [cv * VEC, cv * VEC + VEC)
  int lane;       // row lane inside the block
  int lanes;      // number of row lanes
  bool active;    // threads past lanes * CV idle
  long long r0;   // this block's rows [r0, r1)
  long long r1;
};

template <int VEC>
__device__ __forceinline__ Slot make_slot(int R, int C, int chunk_rows) {
  const int CV = C / VEC;
  Slot s;
  s.lanes = blockDim.x / CV;
  s.cv = threadIdx.x % CV;
  s.lane = threadIdx.x / CV;
  s.active = s.lane < s.lanes;
  s.r0 = static_cast<long long>(blockIdx.x) * chunk_rows;
  s.r1 = min(static_cast<long long>(R), s.r0 + chunk_rows);
  return s;
}

// offset of (ghost blockIdx.y, row 0, channel cv * VEC)
template <int VEC>
__device__ __forceinline__ size_t ghost_base(const Slot& s, int R, int C) {
  return static_cast<size_t>(blockIdx.y) * R * C + s.cv * VEC;
}

// ---------------------------------------------------------------------------
// forward statistics: per-chunk (mean, M2) partials
// ---------------------------------------------------------------------------

template <int VEC>
__global__ void gbn_fwd_partial_kernel(const float* __restrict__ x,
                                       float* __restrict__ pmean,
                                       float* __restrict__ pm2, int R, int C,
                                       int chunk_rows) {
  extern __shared__ float smem[];
  const Slot s = make_slot<VEC>(R, C, chunk_rows);
  const float* xg = x + ghost_base<VEC>(s, R, C);
  float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) mean[k] = m2[k] = 0.f;

  if (s.active && s.r0 + s.lane < s.r1) {
    // sums of x - shift, shift = the thread's first value: keeps the
    // per-thread sum of squares from cancelling when |mean| >> std
    float shift[VEC], sum[VEC], sq[VEC];
    load_vec<VEC>(xg + (s.r0 + s.lane) * C, shift);
#pragma unroll
    for (int k = 0; k < VEC; ++k) sum[k] = sq[k] = 0.f;
    for (long long r = s.r0 + s.lane; r < s.r1; r += s.lanes) {
      float v[VEC];
      load_vec<VEC>(xg + r * C, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = v[k] - shift[k];
        sum[k] += d;
        sq[k] += d * d;
      }
      n += 1.f;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      mean[k] = shift[k] + sum[k] / n;
      m2[k] = fmaxf(sq[k] - sum[k] * sum[k] / n, 0.f);
    }
  }

  float* sn = smem;
  float* smean = sn + blockDim.x;
  float* sm2 = smean + blockDim.x * VEC;
  sn[threadIdx.x] = n;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    smean[threadIdx.x * VEC + k] = mean[k];
    sm2[threadIdx.x * VEC + k] = m2[k];
  }
  __syncthreads();
  if (s.lane != 0) return;
  const int CV = C / VEC;
  for (int l = 1; l < s.lanes; ++l) {  // Chan merge, lane order
    const int t = l * CV + s.cv;
    const float nb = sn[t];
    if (nb == 0.f) continue;
    const float nab = n + nb;
    const float w = nb / nab;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float d = smean[t * VEC + k] - mean[k];
      mean[k] += d * w;
      m2[k] += sm2[t * VEC + k] + d * d * n * w;
    }
    n = nab;
  }
  const size_t o =
      (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * C +
      s.cv * VEC;
  store_vec<VEC>(pmean + o, mean);
  store_vec<VEC>(pm2 + o, m2);
}

// ---------------------------------------------------------------------------
// merge of the per-chunk partials, one thread per (ghost, channel)
// CHAN: (mean, M2) -> (mu, biased var); else plain sums of both planes
// ---------------------------------------------------------------------------

template <bool CHAN>
__global__ void gbn_merge_kernel(const float* __restrict__ pa,
                                 const float* __restrict__ pb,
                                 float* __restrict__ oa,
                                 float* __restrict__ ob, int G, int R, int C,
                                 int chunk_rows, int nchunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= G * C) return;
  const int g = i / C, c = i % C;
  const float* a = pa + static_cast<size_t>(g) * nchunks * C + c;
  const float* b = pb + static_cast<size_t>(g) * nchunks * C + c;
  if constexpr (CHAN) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int k = 0; k < nchunks; ++k) {
      const float nb = static_cast<float>(min(chunk_rows, R - k * chunk_rows));
      const float nab = n + nb;
      const float w = nb / nab;
      const float d = a[static_cast<size_t>(k) * C] - mean;
      mean += d * w;
      m2 += b[static_cast<size_t>(k) * C] + d * d * n * w;
      n = nab;
    }
    oa[i] = mean;
    ob[i] = m2 / static_cast<float>(R);
  } else {
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < nchunks; ++k) {
      sa += a[static_cast<size_t>(k) * C];
      sb += b[static_cast<size_t>(k) * C];
    }
    oa[i] = sa;
    ob[i] = sb;
  }
}

// ---------------------------------------------------------------------------
// normalize: y = (x - mu) * rsqrt(var + eps) * gamma + beta
// ---------------------------------------------------------------------------

template <int VEC>
__global__ void gbn_normalize_kernel(const float* __restrict__ x,
                                     const float* __restrict__ mu,
                                     const float* __restrict__ var,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     float eps, float* __restrict__ y, int R,
                                     int C, int chunk_rows) {
  const Slot s = make_slot<VEC>(R, C, chunk_rows);
  if (!s.active) return;
  const int c0 = s.cv * VEC;
  const size_t gc = static_cast<size_t>(blockIdx.y) * C + c0;
  float m[VEC], rs[VEC], ga[VEC], be[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    m[k] = mu[gc + k];
    rs[k] = rsqrtf(var[gc + k] + eps);
    ga[k] = gamma[c0 + k];
    be[k] = beta[c0 + k];
  }
  const size_t base = ghost_base<VEC>(s, R, C);
  for (long long r = s.r0 + s.lane; r < s.r1; r += s.lanes) {
    float v[VEC];
    load_vec<VEC>(x + base + r * C, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = (v[k] - m[k]) * rs[k] * ga[k] + be[k];
    store_vec<VEC>(y + base + r * C, v);
  }
}

// ---------------------------------------------------------------------------
// backward statistics: per-chunk sum dy and sum dy * xhat
// ---------------------------------------------------------------------------

template <int VEC>
__global__ void gbn_bwd_partial_kernel(const float* __restrict__ x,
                                       const float* __restrict__ dy,
                                       const float* __restrict__ mu,
                                       const float* __restrict__ rstd,
                                       float* __restrict__ psdy,
                                       float* __restrict__ psdyxh, int R,
                                       int C, int chunk_rows) {
  extern __shared__ float smem[];
  const Slot s = make_slot<VEC>(R, C, chunk_rows);
  float sdy[VEC], sdyxh[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) sdy[k] = sdyxh[k] = 0.f;
  if (s.active) {
    const size_t gc = static_cast<size_t>(blockIdx.y) * C + s.cv * VEC;
    float m[VEC], rs[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      m[k] = mu[gc + k];
      rs[k] = rstd[gc + k];
    }
    const size_t base = ghost_base<VEC>(s, R, C);
    for (long long r = s.r0 + s.lane; r < s.r1; r += s.lanes) {
      float xv[VEC], dv[VEC];
      load_vec<VEC>(x + base + r * C, xv);
      load_vec<VEC>(dy + base + r * C, dv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        sdy[k] += dv[k];
        sdyxh[k] += dv[k] * ((xv[k] - m[k]) * rs[k]);
      }
    }
  }
  float* sa = smem;
  float* sb = sa + blockDim.x * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sa[threadIdx.x * VEC + k] = sdy[k];
    sb[threadIdx.x * VEC + k] = sdyxh[k];
  }
  __syncthreads();
  if (s.lane != 0) return;
  const int CV = C / VEC;
  for (int l = 1; l < s.lanes; ++l) {
    const int t = l * CV + s.cv;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sdy[k] += sa[t * VEC + k];
      sdyxh[k] += sb[t * VEC + k];
    }
  }
  const size_t o =
      (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * C +
      s.cv * VEC;
  store_vec<VEC>(psdy + o, sdy);
  store_vec<VEC>(psdyxh + o, sdyxh);
}

// ---------------------------------------------------------------------------
// dx = dy * c1 + (x - mu) * c2 + c3, per-(ghost, channel) coefficients
// ---------------------------------------------------------------------------

template <int VEC>
__global__ void gbn_dx_kernel(const float* __restrict__ x,
                              const float* __restrict__ dy,
                              const float* __restrict__ mu,
                              const float* __restrict__ c1,
                              const float* __restrict__ c2,
                              const float* __restrict__ c3,
                              float* __restrict__ dx, int R, int C,
                              int chunk_rows) {
  const Slot s = make_slot<VEC>(R, C, chunk_rows);
  if (!s.active) return;
  const size_t gc = static_cast<size_t>(blockIdx.y) * C + s.cv * VEC;
  float m[VEC], a[VEC], b[VEC], c[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    m[k] = mu[gc + k];
    a[k] = c1[gc + k];
    b[k] = c2[gc + k];
    c[k] = c3[gc + k];
  }
  const size_t base = ghost_base<VEC>(s, R, C);
  for (long long r = s.r0 + s.lane; r < s.r1; r += s.lanes) {
    float xv[VEC], dv[VEC];
    load_vec<VEC>(x + base + r * C, xv);
    load_vec<VEC>(dy + base + r * C, dv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) dv[k] = dv[k] * a[k] + (xv[k] - m[k]) * b[k] + c[k];
    store_vec<VEC>(dx + base + r * C, dv);
  }
}

constexpr int kMergeThreads = 256;

inline dim3 chunk_grid(int G, int nchunks) {
  return dim3(static_cast<unsigned>(nchunks), static_cast<unsigned>(G));
}

inline dim3 merge_grid(int G, int C) {
  return dim3(static_cast<unsigned>((G * C + kMergeThreads - 1) /
                                    kMergeThreads));
}

}  // namespace

extern "C" {

// x (G, R, C) -> mu, var (G, C); pmean, pm2 (G, nchunks, C) are scratch.
int gbn_fwd_stats(const float* x, float* pmean, float* pm2, float* mu,
                  float* var, int G, int R, int C, int chunk_rows, int nchunks,
                  int vec, int threads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(threads) * (1 + 2 * vec) * sizeof(float);
  if (vec == 4) {
    gbn_fwd_partial_kernel<4><<<chunk_grid(G, nchunks), threads, smem, stream>>>(
        x, pmean, pm2, R, C, chunk_rows);
  } else if (vec == 1) {
    gbn_fwd_partial_kernel<1><<<chunk_grid(G, nchunks), threads, smem, stream>>>(
        x, pmean, pm2, R, C, chunk_rows);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gbn_merge_kernel<true><<<merge_grid(G, C), kMergeThreads, 0, stream>>>(
      pmean, pm2, mu, var, G, R, C, chunk_rows, nchunks);
  return static_cast<int>(cudaGetLastError());
}

// y = (x - mu) * rsqrt(var + eps) * gamma + beta over (G, R, C).
int gbn_normalize(const float* x, const float* mu, const float* var,
                  const float* gamma, const float* beta, float eps, float* y,
                  int G, int R, int C, int chunk_rows, int nchunks, int vec,
                  int threads, cudaStream_t stream) {
  if (vec == 4) {
    gbn_normalize_kernel<4><<<chunk_grid(G, nchunks), threads, 0, stream>>>(
        x, mu, var, gamma, beta, eps, y, R, C, chunk_rows);
  } else if (vec == 1) {
    gbn_normalize_kernel<1><<<chunk_grid(G, nchunks), threads, 0, stream>>>(
        x, mu, var, gamma, beta, eps, y, R, C, chunk_rows);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, dy (G, R, C); mu, rstd (G, C) -> sdy, sdyxh (G, C); psdy, psdyxh
// (G, nchunks, C) are scratch.
int gbn_bwd_stats(const float* x, const float* dy, const float* mu,
                  const float* rstd, float* psdy, float* psdyxh, float* sdy,
                  float* sdyxh, int G, int R, int C, int chunk_rows,
                  int nchunks, int vec, int threads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(threads) * 2 * vec * sizeof(float);
  if (vec == 4) {
    gbn_bwd_partial_kernel<4><<<chunk_grid(G, nchunks), threads, smem, stream>>>(
        x, dy, mu, rstd, psdy, psdyxh, R, C, chunk_rows);
  } else if (vec == 1) {
    gbn_bwd_partial_kernel<1><<<chunk_grid(G, nchunks), threads, smem, stream>>>(
        x, dy, mu, rstd, psdy, psdyxh, R, C, chunk_rows);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gbn_merge_kernel<false><<<merge_grid(G, C), kMergeThreads, 0, stream>>>(
      psdy, psdyxh, sdy, sdyxh, G, R, C, chunk_rows, nchunks);
  return static_cast<int>(cudaGetLastError());
}

// dx = dy * c1 + (x - mu) * c2 + c3 over (G, R, C); mu, c1..c3 (G, C).
int gbn_bwd_dx(const float* x, const float* dy, const float* mu,
               const float* c1, const float* c2, const float* c3, float* dx,
               int G, int R, int C, int chunk_rows, int nchunks, int vec,
               int threads, cudaStream_t stream) {
  if (vec == 4) {
    gbn_dx_kernel<4><<<chunk_grid(G, nchunks), threads, 0, stream>>>(
        x, dy, mu, c1, c2, c3, dx, R, C, chunk_rows);
  } else if (vec == 1) {
    gbn_dx_kernel<1><<<chunk_grid(G, nchunks), threads, 0, stream>>>(
        x, dy, mu, c1, c2, c3, dx, R, C, chunk_rows);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
