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
// Backward, from the saved s and scale and the cotangents dy (of y) and ds
// (of s; null for the norms with no residual): with rstd = rsqrt(mean(s^2)
// + eps), s_hat = s * rstd and w = dy * scale,
//   dx = rstd * (w - s_hat * mean(w * s_hat)) + ds   (= dr, in s's type)
//   dscale = sum over rows of dy * s_hat             (f32)
// (mean(w * s_hat) = rstd * mean(w * s)).
//
// Both directions are bound by device-memory bytes (forward: read x and r,
// write s and y; backward: read s, dy and ds, write dx; 8 bytes an element
// in bf16). What the design does about it: keep many 16-byte loads in
// flight on every SM and touch each byte once, with no barrier between a
// row's loads and its stores.
//
// Row teams. A row belongs to a team of W warps (1, 2, 4 or 8; TT = 32 W
// threads), chosen from d and the element size alone
// (kernels/fused_norm.py:team). The row is cut into C = ceil(d / V) chunks
// of V = 16 / sizeof(T) elements; thread t of the team holds chunks t,
// t + TT, ..., t + (K - 1) TT in registers, as the raw 16-byte vectors
// they were loaded as (K a template parameter, K TT >= C). A team reduces
// sum(s^2) (and, backward, sum(w * s)) in a fixed order: each thread sums
// each chunk's elements in order, then its chunk sums in order, then a
// __shfl_xor_sync butterfly over the warp (every lane gets the same bits),
// then, for W > 1, the W warp sums in warp order from a few floats of
// shared memory behind a named barrier of the team's warps (two slots a
// team, used by alternate rows, so a row needs one barrier). The order
// depends on d and the element size only, never on N, the grid or the SM
// count: a row's result is the same bits in any batch. The scalar path
// (d not a multiple of V, or a pointer off 16 bytes) uses the same chunks,
// loading a chunk's elements one by one, so its order is the same too.
//
// Teams in flight. A block holds up to 256 threads: 8 / W teams of W warps
// (fewer when N is small, so that few rows spread over many SMs). The grid
// is at most the SM count times the blocks an SM holds at the kernel's
// register cap (__launch_bounds__ from K: kFwdMinBlocks, kBwdMinBlocks);
// team g of the grid takes rows g, g + G, g + 2G, ... (G teams in all).
// Each team issues the loads of its next row into a second set of
// registers before it reduces the current one.
//
// dscale without atomics. Each thread adds its columns' dy * s_hat into K V
// f32 registers over its team's rows; at the end the teams of a block add
// their partials in team order through d floats of shared memory, the
// block writes its row of `partial`, and a second kernel sums each column's
// partials in block order: 8 runs of consecutive blocks, each in order,
// then the runs in order. Two calls on the same inputs give the same bits.
//
// Wide rows of the backward. A team of 8 warps holds at most K = 4 chunks a
// thread (3 raw vectors of the current row, 3 of the next and the dscale
// partial: up to ~250 registers); wider rows (f32 past d = 4096) take the
// stream body: one team of 8 warps a block walks its rows in two passes,
// the first loading s and dy for the two sums and leaving each chunk in a
// shared-memory slot of the thread that loaded it, the second reading them
// back with ds to write dx, the dscale partial in shared memory too (96 KB
// a block at f32 d = 8192, two blocks an SM). Its chunks and sums run in
// the same order as a rows body of 8 warps.

#include "common.cuh"

namespace {

using port::from_f;
using port::to_f;
using port::Vec16;

constexpr int kThreads = 256;   // threads of a block at most
constexpr int kMaxTeams = kThreads / 32;

// The launch policy, read from this file by kernels/fused_norm.py (its
// plan sizes grids and register caps from these lines, so they live here
// only; keep each a literal). kFwdMinBlocks[K], kBwdMinBlocks[K]: the
// blocks an SM must hold when a thread holds K chunks, the rows kernels'
// __launch_bounds__, which cap their registers (0: no kernel at that K;
// launch_fwd and launch_bwd instantiate the others). kStreamMinBlocks: the
// same for the backward's stream body, and kStreamSmemMax the dynamic
// shared memory a stream block may take: 233472 bytes an SM over
// kStreamMinBlocks blocks, less the 1 KB the runtime keeps a block and 256
// bytes of static shared memory.
constexpr int kFwdMinBlocks[9] = {0, 4, 3, 2, 2, 0, 1, 0, 1};
constexpr int kBwdMinBlocks[5] = {0, 3, 2, 1, 1};
constexpr int kStreamMinBlocks = 2;
constexpr int kStreamSmemMax = 115456;

// Chunk c (V elements from c * V) of a row as a raw 16-byte vector; chunks
// past the row are zeros. VEC: one 16-byte load (requires c < d / V and a
// 16-byte aligned row); else the elements one by one, those past d zero.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ row, int c,
                                            int d) {
  constexpr int V = Vec16<T>::N;
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (VEC) {
    if (c * V < d) raw = *reinterpret_cast<const uint4*>(row + c * V);
  } else {
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (c * V + i < d) e[i] = row[c * V + i];
  }
  return raw;
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(T* __restrict__ row, int c, int d,
                                            const uint4& raw) {
  constexpr int V = Vec16<T>::N;
  if constexpr (VEC) {
    if (c * V < d) *reinterpret_cast<uint4*>(row + c * V) = raw;
  } else {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (c * V + i < d) row[c * V + i] = e[i];
  }
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& raw, int i) {
  return to_f(reinterpret_cast<const T*>(&raw)[i]);
}

template <typename T>
__device__ __forceinline__ void set_elem(uint4& raw, int i, float v) {
  reinterpret_cast<T*>(&raw)[i] = from_f<T>(v);
}

// Scale of the V columns of chunk c (zeros past d): 16-byte loads where
// VEC (the wrapper then also has scale 16-byte aligned).
template <typename T, bool VEC>
__device__ __forceinline__ void load_scale(const float* __restrict__ scale,
                                           int c, int d,
                                           float (&out)[Vec16<T>::N]) {
  constexpr int V = Vec16<T>::N;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c * V < d) v = __ldg(reinterpret_cast<const float4*>(scale + c * V + i));
      out[i] = v.x;
      out[i + 1] = v.y;
      out[i + 2] = v.z;
      out[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      out[i] = c * V + i < d ? __ldg(scale + c * V + i) : 0.f;
  }
}

// Where a thread sits: its team in the block, its place in the team, and
// the team's first row and the grid's team count (its row stride).
struct Team {
  int W, TT, team, t, row, stride;
  __device__ __forceinline__ explicit Team(int warps) {
    W = warps;
    TT = 32 * warps;
    team = threadIdx.x / TT;
    t = threadIdx.x % TT;
    const int per_block = blockDim.x / TT;
    row = blockIdx.x * per_block + team;
    stride = gridDim.x * per_block;
  }
};

// The scale of a thread's K chunks: held in registers for the kernel's
// life where K V is at most HELD floats (loaded beside the first row, and
// never on a row's path again), else loaded again, from L1, where it is
// used. The forward holds up to 32, the backward, which holds three rows'
// chunks and the dscale partial, up to 16.
template <typename T, bool VEC, int K, int HELD>
struct Scale {
  static constexpr int V = Vec16<T>::N;
  static constexpr bool kHeld = K * V <= HELD;
  const float* __restrict__ scale;
  int d;
  float held[kHeld ? K : 1][V];
  __device__ __forceinline__ Scale(const float* __restrict__ scale_,
                                   const Team& tm, int d_)
      : scale(scale_), d(d_) {
    if constexpr (kHeld) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        load_scale<T, VEC>(scale, tm.t + k * tm.TT, d, held[k]);
    }
  }
  // the scale of chunk c, the thread's k-th
  __device__ __forceinline__ void get(int k, int c, float (&w)[V]) const {
    if constexpr (kHeld) {
#pragma unroll
      for (int e = 0; e < V; ++e) w[e] = held[k][e];
    } else {
      load_scale<T, VEC>(scale, c, d, w);
    }
  }
};

// The team's sum of (a, b): warp butterfly, then the W warp sums in warp
// order from slots (2 x W float2 of this team; `parity` alternates by row).
__device__ __forceinline__ float2 team_sum(float2 v, float2* slots,
                                           int parity, const Team& tm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  if (tm.W == 1) return v;
  float2* sl = slots + parity * tm.W;
  if ((tm.t & 31) == 0) sl[tm.t >> 5] = v;
  port::named_sync(1 + tm.team, tm.TT);
  float2 s = sl[0];
  for (int w = 1; w < tm.W; ++w) {
    s.x += sl[w].x;
    s.y += sl[w].y;
  }
  return s;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, bool VEC, bool RES, int K>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks[K])
    rmsnorm_residual_kernel(const T* __restrict__ x, const T* __restrict__ r,
                            const float* __restrict__ scale,
                            T* __restrict__ y, T* __restrict__ s, int n,
                            int d, int warps, float eps) {
  constexpr int V = Vec16<T>::N;
  __shared__ float2 slots[kMaxTeams][2][kMaxTeams];
  const Team tm(warps);
  uint4 nx[K], nr[K];  // the next row's x and r, loads in flight
  if (tm.row < n) {
    const size_t base = static_cast<size_t>(tm.row) * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      nx[k] = load_chunk<T, VEC>(x + base, tm.t + k * tm.TT, d);
      if constexpr (RES) nr[k] = load_chunk<T, VEC>(r + base, tm.t + k * tm.TT, d);
    }
  }
  const Scale<T, VEC, K, 32> sc(scale, tm, d);
  for (int row = tm.row, it = 0; row < n; row += tm.stride, ++it) {
    const size_t base = static_cast<size_t>(row) * d;
    uint4 cs[K];  // s = x + r of this row, rounded to T
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cs[k] = nx[k];
      if constexpr (RES) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          set_elem<T>(cs[k], e, elem<T>(nx[k], e) + elem<T>(nr[k], e));
      }
    }
    const int next = row + tm.stride;
    if (next < n) {
      const size_t nb = static_cast<size_t>(next) * d;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        nx[k] = load_chunk<T, VEC>(x + nb, tm.t + k * tm.TT, d);
        if constexpr (RES) nr[k] = load_chunk<T, VEC>(r + nb, tm.t + k * tm.TT, d);
      }
    }
    // sum of squares: each chunk's elements in order, then the chunks in
    // order
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (RES) store_chunk<T, VEC>(s + base, tm.t + k * tm.TT, d, cs[k]);
      float q = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = elem<T>(cs[k], e);
        q += v * v;
      }
      ss += q;
    }
    ss = team_sum(make_float2(ss, 0.f), &slots[tm.team][0][0], it & 1, tm).x;
    const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = tm.t + k * tm.TT;
      float w[V];
      sc.get(k, c, w);
      uint4 o;
#pragma unroll
      for (int e = 0; e < V; ++e) set_elem<T>(o, e, elem<T>(cs[k], e) * rstd * w[e]);
      store_chunk<T, VEC>(y + base, c, d, o);
    }
  }
}

template <typename T, bool VEC, bool RES>
int launch_fwd(const void* x, const void* r, const float* scale, void* y,
               void* s, int n, int d, float eps, int warps, int k,
               int blocks, int threads, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  T* yt = static_cast<T*>(y);
  T* st = static_cast<T*>(s);
#define FWD_K(KK)                                                       \
  case KK:                                                              \
    rmsnorm_residual_kernel<T, VEC, RES, KK><<<blocks, threads, 0, stream>>>( \
        xt, rt, scale, yt, st, n, d, warps, eps);                       \
    break;
  switch (k) {
    FWD_K(1) FWD_K(2) FWD_K(3) FWD_K(4) FWD_K(6) FWD_K(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FWD_K
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd_any(const void* x, const void* r, const float* scale, void* y,
                   void* s, int n, int d, float eps, int vec, int warps,
                   int k, int blocks, int threads, cudaStream_t stream) {
  if (vec && r != nullptr)
    return launch_fwd<T, true, true>(x, r, scale, y, s, n, d, eps, warps, k,
                                     blocks, threads, stream);
  if (vec)
    return launch_fwd<T, true, false>(x, r, scale, y, s, n, d, eps, warps, k,
                                      blocks, threads, stream);
  if (r != nullptr)
    return launch_fwd<T, false, true>(x, r, scale, y, s, n, d, eps, warps, k,
                                      blocks, threads, stream);
  return launch_fwd<T, false, false>(x, r, scale, y, s, n, d, eps, warps, k,
                                     blocks, threads, stream);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// The block's dscale partial: its teams' columns added in team order
// through buf (d floats of shared memory), then written to its row of
// `partial`. acc(k, e) gives this thread's value of column (t + k TT) V + e.
template <typename T, int K, typename Acc>
__device__ __forceinline__ void write_partial(const Acc& acc, float* buf,
                                              float* __restrict__ partial,
                                              int d, const Team& tm) {
  constexpr int V = Vec16<T>::N;
  const int teams = blockDim.x / tm.TT;
  for (int j = 0; j < teams; ++j) {
    if (tm.team == j) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int col = (tm.t + k * tm.TT) * V + e;
          if (col < d) buf[col] = j == 0 ? acc(k, e) : buf[col] + acc(k, e);
        }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) out[col] = buf[col];
}

template <typename T, bool VEC, bool DS, int K>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks[K])
    rmsnorm_residual_bwd_kernel(const T* __restrict__ s,
                                const float* __restrict__ scale,
                                const T* __restrict__ dy,
                                const T* __restrict__ ds, T* __restrict__ dx,
                                float* __restrict__ partial, int n, int d,
                                int warps, float eps) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ float buf[];  // d floats: the block's dscale partial
  __shared__ float2 slots[kMaxTeams][2][kMaxTeams];
  const Team tm(warps);
  float acc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[k][e] = 0.f;
  uint4 ns[K], ng[K], nd[K];  // the next row's s, dy, ds in flight
  if (tm.row < n) {
    const size_t base = static_cast<size_t>(tm.row) * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ns[k] = load_chunk<T, VEC>(s + base, tm.t + k * tm.TT, d);
      ng[k] = load_chunk<T, VEC>(dy + base, tm.t + k * tm.TT, d);
      if constexpr (DS) nd[k] = load_chunk<T, VEC>(ds + base, tm.t + k * tm.TT, d);
    }
  }
  const Scale<T, VEC, K, 16> sc(scale, tm, d);
  for (int row = tm.row, it = 0; row < n; row += tm.stride, ++it) {
    const size_t base = static_cast<size_t>(row) * d;
    uint4 cs[K], cg[K], cd[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cs[k] = ns[k];
      cg[k] = ng[k];
      if constexpr (DS) cd[k] = nd[k];
    }
    const int next = row + tm.stride;
    if (next < n) {
      const size_t nb = static_cast<size_t>(next) * d;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ns[k] = load_chunk<T, VEC>(s + nb, tm.t + k * tm.TT, d);
        ng[k] = load_chunk<T, VEC>(dy + nb, tm.t + k * tm.TT, d);
        if constexpr (DS) nd[k] = load_chunk<T, VEC>(ds + nb, tm.t + k * tm.TT, d);
      }
    }
    // sum(s^2) and sum(dy * scale * s): each chunk's elements in order,
    // then the chunks in order
    float2 sums = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float w[V];
      sc.get(k, tm.t + k * tm.TT, w);
      float2 q = make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float a = elem<T>(cs[k], e), g = elem<T>(cg[k], e);
        q.x += a * a;
        q.y += g * w[e] * a;
      }
      sums.x += q.x;
      sums.y += q.y;
    }
    sums = team_sum(sums, &slots[tm.team][0][0], it & 1, tm);
    const float rstd = rsqrtf(sums.x / static_cast<float>(d) + eps);
    const float m = sums.y * rstd / static_cast<float>(d);  // mean(w s_hat)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = tm.t + k * tm.TT;
      float w[V];
      sc.get(k, c, w);
      uint4 o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float sh = elem<T>(cs[k], e) * rstd;
        const float g = elem<T>(cg[k], e);
        float v = rstd * (g * w[e] - sh * m);
        if constexpr (DS) v += elem<T>(cd[k], e);
        set_elem<T>(o, e, v);
        acc[k][e] += g * sh;
      }
      store_chunk<T, VEC>(dx + base, c, d, o);
    }
  }
  write_partial<T, K>([&](int k, int e) { return acc[k][e]; }, buf, partial,
                      d, tm);
}

// One team of 8 warps a block, two passes over each row (see the note at
// the top). Dynamic shared memory: the row's s and dy chunks as loaded (C
// 16-byte slots each; a thread reads back only the slots it wrote, so the
// passes need no barrier between them), then the dscale partial (C V
// floats).
template <typename T, bool VEC, bool DS>
__global__ void __launch_bounds__(kThreads, kStreamMinBlocks)
    rmsnorm_residual_bwd_stream_kernel(const T* __restrict__ s,
                                       const float* __restrict__ scale,
                                       const T* __restrict__ dy,
                                       const T* __restrict__ ds,
                                       T* __restrict__ dx,
                                       float* __restrict__ partial, int n,
                                       int d, float eps) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ uint4 stage[];
  __shared__ float2 slots[2][kMaxTeams];
  const Team tm(kMaxTeams);
  const int C = (d + V - 1) / V;
  uint4* stage_s = stage;
  uint4* stage_g = stage + C;
  float* acc = reinterpret_cast<float*>(stage + 2 * C);
  for (int c = tm.t; c < C; c += tm.TT)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[c * V + e] = 0.f;
  for (int row = tm.row, it = 0; row < n; row += tm.stride, ++it) {
    const size_t base = static_cast<size_t>(row) * d;
    float2 sums = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int c = tm.t; c < C; c += tm.TT) {
      const uint4 a4 = load_chunk<T, VEC>(s + base, c, d);
      const uint4 g4 = load_chunk<T, VEC>(dy + base, c, d);
      stage_s[c] = a4;
      stage_g[c] = g4;
      float sc[V];
      load_scale<T, VEC>(scale, c, d, sc);
      float2 q = make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float a = elem<T>(a4, e), g = elem<T>(g4, e);
        q.x += a * a;
        q.y += g * sc[e] * a;
      }
      sums.x += q.x;
      sums.y += q.y;
    }
    sums = team_sum(sums, &slots[0][0], it & 1, tm);
    const float rstd = rsqrtf(sums.x / static_cast<float>(d) + eps);
    const float m = sums.y * rstd / static_cast<float>(d);
#pragma unroll 4
    for (int c = tm.t; c < C; c += tm.TT) {
      uint4 d4 = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (DS) d4 = load_chunk<T, VEC>(ds + base, c, d);
      const uint4 a4 = stage_s[c];
      const uint4 g4 = stage_g[c];
      float sc[V];
      load_scale<T, VEC>(scale, c, d, sc);
      uint4 o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float sh = elem<T>(a4, e) * rstd;
        const float g = elem<T>(g4, e);
        float v = rstd * (g * sc[e] - sh * m);
        if constexpr (DS) v += elem<T>(d4, e);
        set_elem<T>(o, e, v);
        acc[c * V + e] += g * sh;
      }
      store_chunk<T, VEC>(dx + base, c, d, o);
    }
  }
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) out[col] = acc[col];
}

// dscale[c] = the nblk partial rows of column c summed in a fixed order:
// kDscaleRuns threads of the column each sum a run of ceil(nblk /
// kDscaleRuns) consecutive blocks in block order (16 loads in flight before
// they are added), then the runs are added in run order. The order depends
// on nblk only, which the plan fixes from N, d and the SM count.
constexpr int kDscaleCols = 32, kDscaleRuns = 8, kDscaleAhead = 16;

__global__ void __launch_bounds__(kDscaleCols * kDscaleRuns)
    rmsnorm_residual_dscale_kernel(const float* __restrict__ partial,
                                   float* __restrict__ dscale, int nblk,
                                   int d) {
  __shared__ float runs[kDscaleRuns][kDscaleCols];
  const int col = threadIdx.x % kDscaleCols, g = threadIdx.x / kDscaleCols;
  const int c = blockIdx.x * kDscaleCols + col;
  const int per = (nblk + kDscaleRuns - 1) / kDscaleRuns;
  const int b1 = min(nblk, (g + 1) * per);
  float acc = 0.f;
  if (c < d) {
    int b = g * per;
    for (; b + kDscaleAhead <= b1; b += kDscaleAhead) {
      float v[kDscaleAhead];
#pragma unroll
      for (int i = 0; i < kDscaleAhead; ++i)
        v[i] = partial[static_cast<size_t>(b + i) * d + c];
#pragma unroll
      for (int i = 0; i < kDscaleAhead; ++i) acc += v[i];
    }
    for (; b < b1; ++b) acc += partial[static_cast<size_t>(b) * d + c];
  }
  runs[g][col] = acc;
  __syncthreads();
  if (g == 0 && c < d) {
    float sum = runs[0][col];
    for (int j = 1; j < kDscaleRuns; ++j) sum += runs[j][col];
    dscale[c] = sum;
  }
}

template <typename T, bool VEC, bool DS>
int launch_bwd(const void* s, const float* scale, const void* dy,
               const void* ds, void* dx, float* partial, float* dscale, int n,
               int d, float eps, int stream_body, int warps, int k,
               int blocks, int threads, int smem, cudaStream_t stream) {
  const T* st = static_cast<const T*>(s);
  const T* gt = static_cast<const T*>(dy);
  const T* dt = static_cast<const T*>(ds);
  T* xt = static_cast<T*>(dx);
  if (stream_body) {
    auto kernel = rmsnorm_residual_bwd_stream_kernel<T, VEC, DS>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, threads, smem, stream>>>(st, scale, gt, dt, xt, partial,
                                              n, d, eps);
  } else {
#define BWD_K(KK)                                                          \
  case KK:                                                                 \
    rmsnorm_residual_bwd_kernel<T, VEC, DS, KK>                            \
        <<<blocks, threads, smem, stream>>>(st, scale, gt, dt, xt, partial, \
                                            n, d, warps, eps);             \
    break;
    switch (k) {
      BWD_K(1) BWD_K(2) BWD_K(3) BWD_K(4)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef BWD_K
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_residual_dscale_kernel<<<(d + kDscaleCols - 1) / kDscaleCols,
                                   kDscaleCols * kDscaleRuns, 0, stream>>>(
      partial, dscale, blocks, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_any(const void* s, const float* scale, const void* dy,
                   const void* ds, void* dx, float* partial, float* dscale,
                   int n, int d, float eps, int vec, int stream_body,
                   int warps, int k, int blocks, int threads, int smem,
                   cudaStream_t stream) {
  if (vec && ds != nullptr)
    return launch_bwd<T, true, true>(s, scale, dy, ds, dx, partial, dscale, n,
                                     d, eps, stream_body, warps, k, blocks,
                                     threads, smem, stream);
  if (vec)
    return launch_bwd<T, true, false>(s, scale, dy, ds, dx, partial, dscale,
                                      n, d, eps, stream_body, warps, k,
                                      blocks, threads, smem, stream);
  if (ds != nullptr)
    return launch_bwd<T, false, true>(s, scale, dy, ds, dx, partial, dscale,
                                      n, d, eps, stream_body, warps, k,
                                      blocks, threads, smem, stream);
  return launch_bwd<T, false, false>(s, scale, dy, ds, dx, partial, dscale, n,
                                     d, eps, stream_body, warps, k, blocks,
                                     threads, smem, stream);
}

// A plan the kernels can run: teams of 1, 2, 4 or 8 warps filling at most
// 256 threads, whose K chunks a thread cover the row.
bool plan_ok(int d, int V, int warps, int k, int blocks, int threads) {
  if (warps != 1 && warps != 2 && warps != 4 && warps != 8) return false;
  if (threads < 32 * warps || threads > kThreads || threads % (32 * warps))
    return false;
  const long long C = (d + V - 1) / V;
  return blocks >= 1 && static_cast<long long>(k) * 32 * warps >= C;
}

}  // namespace

extern "C" {

// x, r, y, s: (n, d) of `dtype`; scale: (d,) f32. r and s are both null
// (no residual: y = rmsnorm(x) * scale) or both set. vec != 0 requires d to
// be a multiple of 16 / sizeof(element) and every pointer 16-byte aligned.
// The plan (kernels/fused_norm.py:plan): teams of `warps` warps holding `k`
// chunks a thread, `threads` threads a block, `blocks` blocks.
int rmsnorm_residual_fwd(const void* x, const void* r, const float* scale,
                         void* y, void* s, int n, int d, float eps, int dtype,
                         int vec, int warps, int k, int blocks, int threads,
                         cudaStream_t stream) {
  if (n < 1 || d < 1 || (r == nullptr) != (s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32) {
    if (!plan_ok(d, 4, warps, k, blocks, threads))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_fwd_any<float>(x, r, scale, y, s, n, d, eps, vec, warps, k,
                                 blocks, threads, stream);
  }
  if (dtype == port::kBF16) {
    if (!plan_ok(d, 8, warps, k, blocks, threads))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_fwd_any<__nv_bfloat16>(x, r, scale, y, s, n, d, eps, vec,
                                         warps, k, blocks, threads, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// s, dy, ds, dx: (n, d) of `dtype`; scale, dscale: (d,) f32; partial:
// (blocks, d) f32 scratch. ds may be null (a zero cotangent on s). vec as
// above. The plan: the stream body (stream_body != 0: one team of 8 warps
// a block) or the rows body (teams of `warps` warps holding `k` chunks a
// thread), `threads` threads a block, `blocks` blocks (one partial row
// each), `smem` bytes of dynamic shared memory (rows: d floats; stream: the
// s and dy slots, then the partial).
int rmsnorm_residual_bwd(const void* s, const float* scale, const void* dy,
                         const void* ds, void* dx, float* partial,
                         float* dscale, int n, int d, float eps, int dtype,
                         int vec, int stream_body, int warps, int k,
                         int blocks, int threads, int smem,
                         cudaStream_t stream) {
  const int V = dtype == port::kBF16 ? 8 : 4;
  const int C = (d + V - 1) / V;
  const int need = stream_body ? 16 * 2 * C + 4 * C * V : 4 * d;
  if (n < 1 || d < 1 || smem < need ||
      smem > (stream_body ? kStreamSmemMax : 48 * 1024))
    return static_cast<int>(cudaErrorInvalidValue);
  if (stream_body ? (blocks < 1 || threads != kThreads)
                  : !plan_ok(d, V, warps, k, blocks, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32)
    return launch_bwd_any<float>(s, scale, dy, ds, dx, partial, dscale, n, d,
                                 eps, vec, stream_body, warps, k, blocks,
                                 threads, smem, stream);
  if (dtype == port::kBF16)
    return launch_bwd_any<__nv_bfloat16>(s, scale, dy, ds, dx, partial,
                                         dscale, n, d, eps, vec, stream_body,
                                         warps, k, blocks, threads, smem,
                                         stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
