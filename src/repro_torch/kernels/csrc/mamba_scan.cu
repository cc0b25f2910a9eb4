// One chunk of the Mamba-1 selective scan, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/mamba_scan.py:
//   mamba_chunk_pallas (_mamba_kernel)
//   mamba_chunk_backward_pallas (_mamba_bwd_kernel)
//
// xc, dt: (B, c, di) and Bm, Cm: (B, c, ds), all four f32 or all four bf16;
// A: (di, ds) f32; h0: (B, di, ds) f32. Per batch row b, channel d and state
// s, in f32:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (h_{-1} = h0)
//   y_t = sum_s h_t * C_t
// The forward writes y (B, c, di) f32 and h_last = h_{c-1} (B, di, ds) f32,
// so chunks chain through h. A step with dt = 0 leaves h bit for bit as it
// was (exp(0) is exactly 1, and the input term is a zero), which is how a
// left-padded ragged row equals its unpadded run: expf is the accurate
// one here (no fast-math), whose value at zero is exactly 1.
//
// Forward. The channels are independent and time is sequential, so one
// thread owns one (b, d) and keeps that channel's ds states (ds <= 16) and
// its row of A in registers; blocks of 128 channels, grid (di / 128, B).
// Each tile of 16 time steps stages that tile's B_t and C_t in shared
// memory (every thread of the block reads the same values) and loads its
// 16 x_t and dt_t into registers up front, coalesced along d, so the loads
// are in flight together before the sequential loop needs them. What bounds
// it: the bytes of x, dt and y (12 bytes a (t, d) in f32) and the exp of
// every (t, d, s), at the SFU rate; both come to about 64 us at
// (8, 256, 8192, 16).
//
// Backward, from the cotangents dy (B, c, di) f32 and dh_last (B, di, ds)
// f32: reverse time carrying dh (the cotangent of h_t) and a dA
// accumulator, with g = dh + dy_t C_t and du = g h_{t-1} exp(dt_t A):
//   dC_t  = sum_d h_t dy_t             dB_t = sum_d g (dt_t x_t)
//   dx_t  = dt_t sum_s g B_t           ddt_t = sum_s du A + x_t sum_s g B_t
//   dA   += du dt_t                    dh = g exp(dt_t A);  dh0 = dh at t=0
// The states h_t are needed in reverse order, and the (B, c, di, ds)
// trajectory is never written to device memory (the Pallas kernel keeps a
// chunk's trajectory in VMEM; a Hopper block's shared memory holds far too
// little of it). Segmented recompute instead: one thread owns one
// (b, d, s). A first forward pass over the chunk keeps h at the start of
// every segment of kSeg = 16 steps (ceil(c / 16) floats a thread, in
// shared memory: 16 KB a block at c = 256). Then, for each segment from
// the last to the first, the thread recomputes the segment's 16 states and
// decays from its checkpoint into registers and sweeps them in reverse.
// The sums over s (sum g B and sum du A) are shuffles among the ds lanes
// of a channel; the sums over d of dB and dC are shuffles among a warp's
// channels, then a fixed-order sum over the block's warps in shared
// memory. A block of 256 threads covers 256 / ds channels and walks
// kGroups = 8 such groups in turn, adding its dB, dC partials into its own
// row of a (B, tiles, c, 2, ds) f32 scratch; a second kernel sums the tiles
// of each (b, t, s) in tile order. No atomics: every sum is taken in a
// fixed order, so runs repeat bit for bit. dA is written per batch row
// (B, di, ds) and summed over B by the caller, as the reference does.
// Shared memory a block: 4 * (256 * ceil(c / 16) + 8 * 16 * 2 * 16 +
// 3 * 16 * 16 + 2 * 16 * 16) bytes at ds = 16, 37 KB at c = 256; the
// wrapper bounds c by MAX_BWD_CHUNK (2048: 149 KB). Bound: the bytes of
// x, dt, dy, dx, ddt (20 bytes a (t, d) in f32) and one exp a (t, d, s);
// the kernel takes two (the checkpoint pass and the recompute).

#include "common.cuh"

namespace {

using port::from_f;
using port::to_f;

constexpr int kFwdThreads = 128;   // channels a forward block
constexpr int kFwdSteps = 16;      // time steps staged at once
constexpr int kBwdThreads = 256;   // (channel, state) pairs a backward block
constexpr int kSeg = 16;           // steps a recomputed segment
constexpr int kGroups = 8;         // channel groups a backward block walks
constexpr int kReduceThreads = 256;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int DS, typename T>
__global__ void __launch_bounds__(kFwdThreads)
mamba_chunk_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                       const T* __restrict__ Bm, const T* __restrict__ Cm,
                       const float* __restrict__ A,
                       const float* __restrict__ h0, float* __restrict__ y,
                       float* __restrict__ hout, int c, int di, int ds) {
  __shared__ float sB[kFwdSteps][DS];
  __shared__ float sC[kFwdSteps][DS];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kFwdThreads + threadIdx.x;
  const bool live = d < di;
  const size_t sbase = (static_cast<size_t>(b) * di + d) * ds;
  float a[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    const bool on = live && s < ds;
    a[s] = on ? A[static_cast<size_t>(d) * ds + s] : 0.f;
    h[s] = on ? h0[sbase + s] : 0.f;
  }
  for (int t0 = 0; t0 < c; t0 += kFwdSteps) {
    const int len = min(kFwdSteps, c - t0);
    __syncthreads();  // the previous tile's sB, sC have been read
    for (int i = threadIdx.x; i < kFwdSteps * DS; i += kFwdThreads) {
      const int k = i / DS, s = i % DS;
      const bool on = k < len && s < ds;
      const size_t off = (static_cast<size_t>(b) * c + t0 + k) * ds + s;
      sB[k][s] = on ? to_f(Bm[off]) : 0.f;
      sC[k][s] = on ? to_f(Cm[off]) : 0.f;
    }
    __syncthreads();
    float xv[kFwdSteps], dv[kFwdSteps];
#pragma unroll
    for (int k = 0; k < kFwdSteps; ++k) {
      const bool on = live && k < len;
      const size_t off = (static_cast<size_t>(b) * c + t0 + k) * di + d;
      xv[k] = on ? to_f(x[off]) : 0.f;
      dv[k] = on ? to_f(dt[off]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kFwdSteps; ++k) {
      if (k < len) {
        const float dtx = dv[k] * xv[k];
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          h[s] = fmaf(expf(dv[k] * a[s]), h[s], dtx * sB[k][s]);
          acc = fmaf(h[s], sC[k][s], acc);
        }
        if (live) y[(static_cast<size_t>(b) * c + t0 + k) * di + d] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < DS; ++s)
      if (s < ds) hout[sbase + s] = h[s];
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Stage one segment's inputs in shared memory as f32: x_t, dt_t (and dy_t)
// of the group's CH channels, B_t (and C_t) of the batch row. Entries past
// the chunk, past di or past ds are zeros.
template <int DS, bool REVERSE, typename T>
__device__ __forceinline__ void stage_segment(
    const T* __restrict__ x, const T* __restrict__ dt,
    const float* __restrict__ dy, const T* __restrict__ Bm,
    const T* __restrict__ Cm, float* sx, float* sdt, float* sdy, float* sB,
    float* sC, int b, int t0, int len, int dbase, int c, int di, int ds) {
  constexpr int CH = kBwdThreads / DS;
  for (int i = threadIdx.x; i < kSeg * CH; i += kBwdThreads) {
    const int k = i / CH, dd = dbase + i % CH;
    const bool on = k < len && dd < di;
    const size_t off = (static_cast<size_t>(b) * c + t0 + k) * di + dd;
    sx[i] = on ? to_f(x[off]) : 0.f;
    sdt[i] = on ? to_f(dt[off]) : 0.f;
    if constexpr (REVERSE) sdy[i] = on ? dy[off] : 0.f;
  }
  for (int i = threadIdx.x; i < kSeg * DS; i += kBwdThreads) {
    const int k = i / DS, s = i % DS;
    const bool on = k < len && s < ds;
    const size_t off = (static_cast<size_t>(b) * c + t0 + k) * ds + s;
    sB[i] = on ? to_f(Bm[off]) : 0.f;
    if constexpr (REVERSE) sC[i] = on ? to_f(Cm[off]) : 0.f;
  }
}

template <int DS, typename T>
__global__ void __launch_bounds__(kBwdThreads)
mamba_chunk_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                       const T* __restrict__ Bm, const T* __restrict__ Cm,
                       const float* __restrict__ A,
                       const float* __restrict__ h0,
                       const float* __restrict__ dy,
                       const float* __restrict__ dhl, T* __restrict__ dx,
                       T* __restrict__ ddt, float* __restrict__ part,
                       float* __restrict__ dA, float* __restrict__ dh0, int c,
                       int di, int ds, int ntiles) {
  constexpr int CH = kBwdThreads / DS;  // channels of a group
  constexpr int NW = kBwdThreads / 32;
  extern __shared__ float smem[];
  const int nseg = (c + kSeg - 1) / kSeg;
  float* cp = smem;                            // nseg x kBwdThreads
  float* stage = cp + nseg * kBwdThreads;      // NW x kSeg x 2 DS
  float* sx = stage + NW * kSeg * 2 * DS;      // kSeg x CH each
  float* sdt = sx + kSeg * CH;
  float* sdy = sdt + kSeg * CH;
  float* sB = sdy + kSeg * CH;                 // kSeg x DS each
  float* sC = sB + kSeg * DS;

  const int tid = threadIdx.x;
  const int s = tid % DS, ch = tid / DS;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, tile = blockIdx.x;

  for (int g = 0; g < kGroups; ++g) {
    const int dbase = (tile * kGroups + g) * CH;
    if (dbase >= di) break;  // the same for the whole block
    const int d = dbase + ch;
    const bool live = d < di && s < ds;
    const size_t hoff = (static_cast<size_t>(b) * di + d) * ds + s;
    const float a = live ? A[static_cast<size_t>(d) * ds + s] : 0.f;

    // pass 1: the chunk forward, h kept at the start of every segment
    float h = live ? h0[hoff] : 0.f;
    for (int j = 0; j < nseg; ++j) {
      const int t0 = j * kSeg, len = min(kSeg, c - t0);
      cp[j * kBwdThreads + tid] = h;
      __syncthreads();  // the staged inputs of the previous segment are read
      stage_segment<DS, false>(x, dt, dy, Bm, Cm, sx, sdt, sdy, sB, sC, b, t0,
                               len, dbase, c, di, ds);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kSeg; ++k) {
        if (k < len) {
          const float dtk = sdt[k * CH + ch];
          h = fmaf(expf(dtk * a), h, (dtk * sx[k * CH + ch]) * sB[k * DS + s]);
        }
      }
    }

    // pass 2: segments from the last, each recomputed, then swept backwards
    float dh = live ? dhl[hoff] : 0.f;
    float dacc = 0.f;
    for (int j = nseg - 1; j >= 0; --j) {
      const int t0 = j * kSeg, len = min(kSeg, c - t0);
      __syncthreads();  // staged inputs and `stage` of the last segment read
      stage_segment<DS, true>(x, dt, dy, Bm, Cm, sx, sdt, sdy, sB, sC, b, t0,
                              len, dbase, c, di, ds);
      __syncthreads();
      const float hstart = cp[j * kBwdThreads + tid];
      float hs[kSeg], dec[kSeg];
      float hh = hstart;
#pragma unroll
      for (int k = 0; k < kSeg; ++k) {
        if (k < len) {
          const float dtk = sdt[k * CH + ch];
          dec[k] = expf(dtk * a);
          hh = fmaf(dec[k], hh, (dtk * sx[k * CH + ch]) * sB[k * DS + s]);
          hs[k] = hh;
        } else {
          dec[k] = 0.f;
          hs[k] = 0.f;
        }
      }
#pragma unroll
      for (int k = kSeg - 1; k >= 0; --k) {
        if (k < len) {  // the same for the whole block
          const float dtk = sdt[k * CH + ch], xk = sx[k * CH + ch];
          const float dyk = sdy[k * CH + ch];
          const float hprev = k > 0 ? hs[k > 0 ? k - 1 : 0] : hstart;
          const float gg = fmaf(dyk, sC[k * DS + s], dh);
          const float du = gg * hprev * dec[k];
          dacc = fmaf(du, dtk, dacc);
          float gb = gg * sB[k * DS + s];
          float ga = du * a;
#pragma unroll
          for (int o = DS / 2; o > 0; o >>= 1) {
            gb += __shfl_xor_sync(0xffffffffu, gb, o);
            ga += __shfl_xor_sync(0xffffffffu, ga, o);
          }
          if (s == 0 && d < di) {
            const size_t off = (static_cast<size_t>(b) * c + t0 + k) * di + d;
            dx[off] = from_f<T>(dtk * gb);
            ddt[off] = from_f<T>(ga + xk * gb);
          }
          float vb = gg * (dtk * xk);
          float vc = hs[k] * dyk;
#pragma unroll
          for (int o = DS; o < 32; o <<= 1) {
            vb += __shfl_xor_sync(0xffffffffu, vb, o);
            vc += __shfl_xor_sync(0xffffffffu, vc, o);
          }
          if (lane < DS) {
            float* st = stage + (warp * kSeg + k) * 2 * DS;
            st[lane] = vb;
            st[DS + lane] = vc;
          }
          dh = gg * dec[k];
        }
      }
      __syncthreads();
      // this segment's dB, dC of the group: the warps' partials summed in
      // warp order, added into the block's row of the scratch
      for (int i = tid; i < kSeg * 2 * DS; i += kBwdThreads) {
        const int k = i / (2 * DS), r = i % (2 * DS);
        const int which = r / DS, ss = r % DS;
        if (k < len && ss < ds) {
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < NW; ++w) v += stage[(w * kSeg + k) * 2 * DS + r];
          float* p = part +
                     ((static_cast<size_t>(b) * ntiles + tile) * c + t0 + k) *
                         2 * ds +
                     which * ds + ss;
          *p = g == 0 ? v : *p + v;
        }
      }
    }
    if (live) {
      dh0[hoff] = dh;
      dA[hoff] = dacc;
    }
  }
}

// dB, dC (B, c, ds) = the partials of every tile, summed in tile order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
mamba_dbc_reduce_kernel(const float* __restrict__ part, T* __restrict__ dB,
                        T* __restrict__ dC, int batch, int c, int ds,
                        int ntiles) {
  const long long total = static_cast<long long>(batch) * c * 2 * ds;
  const long long e = static_cast<long long>(blockIdx.x) * kReduceThreads +
                      threadIdx.x;
  if (e >= total) return;
  const int ss = static_cast<int>(e % ds);
  long long r = e / ds;
  const int which = static_cast<int>(r % 2);
  r /= 2;
  const int t = static_cast<int>(r % c);
  const int b = static_cast<int>(r / c);
  float v = 0.f;
  for (int tl = 0; tl < ntiles; ++tl)
    v += part[((static_cast<size_t>(b) * ntiles + tl) * c + t) * 2 * ds +
              which * ds + ss];
  T* out = which == 0 ? dB : dC;
  out[(static_cast<size_t>(b) * c + t) * ds + ss] = from_f<T>(v);
}

template <int DS>
int bwd_tiles(int di) {
  const int per_tile = (kBwdThreads / DS) * kGroups;
  return (di + per_tile - 1) / per_tile;
}

template <int DS>
size_t bwd_smem(int c) {
  constexpr int CH = kBwdThreads / DS;
  const int nseg = (c + kSeg - 1) / kSeg;
  return sizeof(float) *
         (static_cast<size_t>(nseg) * kBwdThreads +
          (kBwdThreads / 32) * kSeg * 2 * DS + 3 * kSeg * CH + 2 * kSeg * DS);
}

template <int DS, typename T>
int launch_fwd(const void* x, const void* dt, const void* Bm, const void* Cm,
               const float* A, const float* h0, float* y, float* hout,
               int batch, int c, int di, int ds, cudaStream_t stream) {
  const dim3 grid((di + kFwdThreads - 1) / kFwdThreads, batch);
  mamba_chunk_fwd_kernel<DS, T><<<grid, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), A, h0, y, hout, c,
      di, ds);
  return static_cast<int>(cudaGetLastError());
}

template <int DS, typename T>
int launch_bwd(const void* x, const void* dt, const void* Bm, const void* Cm,
               const float* A, const float* h0, const float* dy,
               const float* dhl, void* dx, void* ddt, void* dB, void* dC,
               float* part, float* dA, float* dh0, int batch, int c, int di,
               int ds, int ntiles, cudaStream_t stream) {
  if (ntiles != bwd_tiles<DS>(di))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem<DS>(c);
  auto kernel = mamba_chunk_bwd_kernel<DS, T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(ntiles, batch), kBwdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), A, h0, dy, dhl,
      static_cast<T*>(dx), static_cast<T*>(ddt), part, dA, dh0, c, di, ds,
      ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * c * 2 * ds;
  const unsigned blocks =
      static_cast<unsigned>((total + kReduceThreads - 1) / kReduceThreads);
  mamba_dbc_reduce_kernel<T><<<blocks, kReduceThreads, 0, stream>>>(
      part, static_cast<T*>(dB), static_cast<T*>(dC), batch, c, ds, ntiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_any(const void* x, const void* dt, const void* Bm, const void* Cm,
            const float* A, const float* h0, float* y, float* hout, int batch,
            int c, int di, int ds, cudaStream_t stream) {
  if (ds <= 8)
    return launch_fwd<8, T>(x, dt, Bm, Cm, A, h0, y, hout, batch, c, di, ds,
                            stream);
  return launch_fwd<16, T>(x, dt, Bm, Cm, A, h0, y, hout, batch, c, di, ds,
                           stream);
}

template <typename T>
int bwd_any(const void* x, const void* dt, const void* Bm, const void* Cm,
            const float* A, const float* h0, const float* dy,
            const float* dhl, void* dx, void* ddt, void* dB, void* dC,
            float* part, float* dA, float* dh0, int batch, int c, int di,
            int ds, int ntiles, cudaStream_t stream) {
  if (ds <= 8)
    return launch_bwd<8, T>(x, dt, Bm, Cm, A, h0, dy, dhl, dx, ddt, dB, dC,
                            part, dA, dh0, batch, c, di, ds, ntiles, stream);
  return launch_bwd<16, T>(x, dt, Bm, Cm, A, h0, dy, dhl, dx, ddt, dB, dC,
                           part, dA, dh0, batch, c, di, ds, ntiles, stream);
}

bool bad_shape(int batch, int c, int di, int ds) {
  return batch < 1 || batch > 65535 || c < 1 || di < 1 || ds < 1 || ds > 16;
}

}  // namespace

extern "C" {

// x, dt: (batch, c, di) and Bm, Cm: (batch, c, ds) of `dtype`; A: (di, ds)
// f32; h0, hout: (batch, di, ds) f32; y: (batch, c, di) f32.
int mamba_chunk_fwd(const void* x, const void* dt, const void* Bm,
                    const void* Cm, const float* A, const float* h0, float* y,
                    float* hout, int batch, int c, int di, int ds, int dtype,
                    cudaStream_t stream) {
  if (bad_shape(batch, c, di, ds))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32)
    return fwd_any<float>(x, dt, Bm, Cm, A, h0, y, hout, batch, c, di, ds,
                          stream);
  if (dtype == port::kBF16)
    return fwd_any<__nv_bfloat16>(x, dt, Bm, Cm, A, h0, y, hout, batch, c,
                                  di, ds, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As the forward, plus dy: (batch, c, di) f32 and dhl: (batch, di, ds) f32.
// Writes dx, ddt (batch, c, di) and dB, dC (batch, c, ds) in `dtype`, and
// dA (per batch row), dh0 (batch, di, ds) f32. part: (batch, ntiles, c, 2,
// ds) f32 scratch, ntiles = ceil(di / (8 * 256 / (ds <= 8 ? 8 : 16))).
int mamba_chunk_bwd(const void* x, const void* dt, const void* Bm,
                    const void* Cm, const float* A, const float* h0,
                    const float* dy, const float* dhl, void* dx, void* ddt,
                    void* dB, void* dC, float* part, float* dA, float* dh0,
                    int batch, int c, int di, int ds, int ntiles, int dtype,
                    cudaStream_t stream) {
  if (bad_shape(batch, c, di, ds))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32)
    return bwd_any<float>(x, dt, Bm, Cm, A, h0, dy, dhl, dx, ddt, dB, dC,
                          part, dA, dh0, batch, c, di, ds, ntiles, stream);
  if (dtype == port::kBF16)
    return bwd_any<__nv_bfloat16>(x, dt, Bm, Cm, A, h0, dy, dhl, dx, ddt, dB,
                                  dC, part, dA, dh0, batch, c, di, ds, ntiles,
                                  stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
