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
// so chunks chain through h.
//
// Time is sequential in every thread; channels and states are parallel.
// (A parallel scan over time would give a left-padded row other bits than
// its solo run.) A step with dt = 0 leaves h bit for bit as it was: the
// decay is exactly 1 and the input term a zero, so a left-padded ragged row
// equals its unpadded run.
//
// Threads. States are padded to DS = 8 or 16 (zeros past ds). A thread owns
// Q = min(kQFwd or kQBwd, DS) consecutive states of one channel, so a
// channel spans LPC = DS / Q lanes of one warp and a block of NT threads
// (kFwdThreads or kBwdThreads) covers CH = NT / LPC channels; the grid is
// (ceil(di / CH), B). A sum over s is Q - 1 adds in registers (in state
// order) and log2(LPC) butterfly levels (xor 1, 2, ...), the same order in
// every lane and call. Plan works out a call's launch from the shape and
// these constants alone; mamba_scan_plan() reports it.
//
// The exp. decay() is the accurate expf of dt * A, for the forward and both
// backward passes; it is exactly 1 at dt = 0. ex2.approx.ftz of
// dt * (A log2 e), with A log2 e formed once per (d, s), was measured
// against it on an H100: 1.4x faster in the forward and 1.2x in the
// backward, but MUFU.EX2 on the unreduced argument drifts by a few ulps a
// step (forming the product in two floats did not help), and at a
// 2048-step chunk and at the falcon-mamba path shape the kernels then left
// the plain versions' 1e-4 (scripts/mamba_times.py --sweep, PERF.md).
//
// Copies. Every tile (forward) or segment (backward) reaches shared memory
// as TMA boxes of the (B c, di) and (B c, ds) views, asked for
// kStages - 1 items ahead into a ring of kStages slots by lane 0 of a few
// warps (one box each) and completing on the slot's mbarrier; channels
// past di arrive as zeros. A block meets once an item. Where a row is off
// 16 bytes (di or ds off the vector width, an unaligned view, ds < DS) the
// same ring is filled by plain loads. y (forward), dx and ddt (backward)
// are staged in shared memory and written as 16-byte rows. Every run of a
// tile's or segment's steps is straight-line code with its shared-memory
// stores after its last step, so the compiler interleaves the steps'
// loads, exps and shuffles.
//
// Forward. Each thread keeps its Q states and A in registers and walks the
// chunk in tiles of kTile steps. What bounds it: one exp a (t, d, s) at the
// SFU rate and the bytes of x, dt and y (12 bytes a (t, d) in f32); both
// come to about 64 us at (8, 256, 8192, 16). The accurate expf costs about
// eight issue slots a (t, d, s), which puts the issue rate ahead of both.
//
// Backward, from the cotangents dy (B, c, di) f32 and dh_last (B, di, ds)
// f32: reverse time carrying dh (the cotangent of h_t) and a dA
// accumulator, with g = dh + dy_t C_t and du = g h_{t-1} exp(dt_t A):
//   dC_t  = sum_d h_t dy_t             dB_t = sum_d g (dt_t x_t)
//   dx_t  = dt_t sum_s g B_t           ddt_t = sum_s du A + x_t sum_s g B_t
//   dA   += du dt_t                    dh = g exp(dt_t A);  dh0 = dh at t=0
// The (B, c, di, ds) trajectory is never written to device memory.
// Segmented recompute: a first pass over the chunk keeps h at the start of
// every segment of kSeg steps (in shared memory where the plan finds room,
// else in a (B, nseg, di, ds) f32 scratch); then, from the last segment to
// the first, each thread recomputes its segment's states and decays into
// registers and sweeps them in reverse, while the next segment's boxes
// land. The two passes are one stream of 2 * nseg ring items. The sums over
// d of dB and dC are a reduce-scatter: a halving butterfly leaves each lane
// with its warp's sum of one (dB or dC, s) entry (7 shuffles a step at
// Q = 4, DS = 16); the warps' rows are summed in warp order after the block
// next meets, and each block writes its tile's partial row of a
// (B, tiles, c, 2, ds) scratch once; a second kernel sums the tiles in tile
// order. No atomics and no read-modify-write: every sum is taken in a fixed
// order, and the order depends on kBwdThreads, not on B, so runs repeat bit
// for bit and a row gives the same bits alone and in a batch. dA is written per
// batch row (B, di, ds) and summed over B by the caller, as the reference
// does. Bound: the bytes of x, dt, dy, dx, ddt (20 bytes a (t, d) in f32)
// and one exp a (t, d, s); the kernel takes two (the checkpoint pass and the
// recompute), and is held by the issue of both (PERF.md).

#include <string.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = port::hopper;
using port::from_f;
using port::to_f;

// The constants, from scripts/mamba_times.py --sweep (PERF.md), which
// rewrites these lines.
constexpr int kQFwd = 4;          // states a forward thread (at most)
constexpr int kQBwd = 4;          // states a backward thread (at most)
constexpr int kSeg = 16;          // steps a backward segment
constexpr int kTile = 16;         // steps a forward tile
constexpr int kStages = 3;        // slots of the copy ring
constexpr int kFwdThreads = 128;  // threads a forward block
constexpr int kBwdThreads = 256;  // threads a backward block
constexpr int kFwdBlocks = 8;     // forward blocks an SM holds
constexpr int kBwdBlocks = 1;     // backward blocks an SM holds

// A backward block's shared memory: its share of an H100 SM's 228 KB (less
// the runtime's 1 KB a block), at most the 227 KB one block may take.
constexpr int kSmemPerSm = 233472, kSmemPerBlock = 232448;
constexpr int kSmemBudget = kSmemPerSm / kBwdBlocks - 1024 < kSmemPerBlock
                                ? kSmemPerSm / kBwdBlocks - 1024
                                : kSmemPerBlock;

constexpr int kReduceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kFwdThreads % 32 == 0 && kFwdThreads <= 1024 &&
                  kBwdThreads % 32 == 0 && kBwdThreads <= 1024,
              "whole warps");

__host__ __device__ constexpr int states_a_thread(int DS, int qmax) {
  return DS < qmax ? DS : qmax;
}

template <int DS, int QMAX, int NT>
struct Lanes {
  static constexpr int Q = states_a_thread(DS, QMAX);  // states a thread
  static constexpr int LPC = DS / Q;                   // lanes a channel
  static constexpr int CH = NT / LPC;                  // channels a block
};

// exp(dt * A); exactly 1 at dt = 0
__device__ __forceinline__ float decay(float dt, float a) {
  return expf(dt * a);
}

// Brings a tensor map (a __grid_constant__ parameter) into the TMA unit's
// descriptor cache ahead of its first box.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

template <typename U>
__device__ __forceinline__ U zero() {
  return from_f<U>(0.f);
}

// Q consecutive values at p (aligned to Q elements) as f32.
template <int Q, typename U>
__device__ __forceinline__ void lds_q(const U* p, float (&v)[Q]) {
  constexpr int BYTES = Q * static_cast<int>(sizeof(U));
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
      const U* e = reinterpret_cast<const U*>(&raw);
#pragma unroll
      for (int j = 0; j < 16 / static_cast<int>(sizeof(U)); ++j)
        v[i * (16 / static_cast<int>(sizeof(U))) + j] = to_f(e[j]);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const U* e = reinterpret_cast<const U*>(&raw);
#pragma unroll
    for (int j = 0; j < Q; ++j) v[j] = to_f(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < Q; ++j) v[j] = to_f(p[j]);
  }
}

// A thread's share of a [steps][CH] tile of channel rows moved in pieces of
// V elements: rows k0, k0 + kstep, ... at column col (CH and the block's
// NT threads are multiples of CH / V, so every piece of a thread lies in one
// column). Formed once a kernel, so the copies of a tile do no division.
struct Share {
  int k0, col, kstep;
  __device__ __forceinline__ Share(int NT, int CH, int V) {
    const int cpr = CH / V;
    k0 = threadIdx.x / cpr;
    col = (threadIdx.x - k0 * cpr) * V;
    kstep = NT / cpr;
  }
};

// Where TMA cannot copy (rows off 16 bytes): rows [t0, t0 + len) of the
// (B, c, di) tensor src, channels [d0, d0 + CH), into dst[steps][CH] by
// plain loads (sh in single elements); rows past len and channels past di
// are zeros.
template <typename U>
__device__ __forceinline__ void load_rows(U* dst, const U* __restrict__ src,
                                          const Share& sh, int b, int t0,
                                          int len, int steps, int d0, int CH,
                                          int c, int di) {
  const bool col_ok = d0 + sh.col < di;
  const U* row = src + (static_cast<size_t>(b) * c + t0) * di + d0 + sh.col;
  for (int k = sh.k0; k < steps; k += sh.kstep)
    dst[k * CH + sh.col] = k < len && col_ok
                               ? row[static_cast<size_t>(k) * di]
                               : zero<U>();
}

// The same for rows [t0, t0 + len) of the (B, c, ds) tensor src into
// dst[steps][DS] by a block of NT threads; states past ds and rows past len
// are zeros.
template <int DS, int NT, typename U>
__device__ __forceinline__ void load_states(U* dst, const U* __restrict__ src,
                                            int b, int t0, int len, int steps,
                                            int c, int ds) {
  for (int i = threadIdx.x; i < steps * DS; i += NT) {
    const int k = i / DS, s = i - k * DS;
    dst[i] = k < len && s < ds
                 ? src[(static_cast<size_t>(b) * c + t0 + k) * ds + s]
                 : zero<U>();
  }
}

// Rows [t0, t0 + len) of the (B, c, di) output dst, channels [d0, d0 + CH),
// from src[steps][CH] in shared memory: 16-byte stores with `vec` (sh in
// 16-byte pieces), else single elements.
template <typename U>
__device__ __forceinline__ void store_rows(U* __restrict__ dst, const U* src,
                                           const Share& sh, int b, int t0,
                                           int len, int d0, int CH, int c,
                                           int di, bool vec) {
  if (d0 + sh.col >= di) return;
  U* row = dst + (static_cast<size_t>(b) * c + t0) * di + d0 + sh.col;
  for (int k = sh.k0; k < len; k += sh.kstep) {
    if (vec)
      *reinterpret_cast<uint4*>(row + static_cast<size_t>(k) * di) =
          *reinterpret_cast<const uint4*>(src + k * CH + sh.col);
    else
      row[static_cast<size_t>(k) * di] = src[k * CH + sh.col];
  }
}

// Shared memory layouts, in bytes. Every part starts on a 128-byte boundary
// (TMA's destinations); kStages mbarriers, one a ring slot, follow the
// parts that TMA fills.
__host__ __device__ constexpr int up128(int n) { return (n + 127) & ~127; }

// A forward block: the ring (x, dt of the block's channels and B, C of the
// row, kTile steps each) and two y buffers. `tx` is the bytes TMA brings a
// slot.
struct FwdSmem {
  int x, dt, B, C, slot, y, bar, total, tx;
  __host__ __device__ FwdSmem(int CH, int DS, int esize) {
    x = 0;
    dt = up128(kTile * CH * esize);
    B = dt + up128(kTile * CH * esize);
    C = B + up128(kTile * DS * esize);
    slot = C + up128(kTile * DS * esize);
    y = kStages * slot;
    bar = y + up128(2 * kTile * CH * 4);
    total = bar + up128(8 * kStages);
    tx = 2 * kTile * (CH + DS) * esize;
  }
};

// A backward block: the ring (x, dt, dy of the block's channels and B, C of
// the row, kSeg steps each; the checkpoint pass brings no dy and no C), two
// buffers each of the warps' dB/dC rows of a segment and of its dx and ddt
// (one filled while the other is stored), and the checkpoints where they
// live here.
struct BwdSmem {
  int x, dt, dy, B, C, slot, stage, dx, ddt, bar, ckpt, total, tx1, tx2;
  __host__ __device__ BwdSmem(int CH, int DS, int Q, int esize, int nseg,
                              bool ckpt_smem) {
    constexpr int NT = kBwdThreads;
    x = 0;
    dt = up128(kSeg * CH * esize);
    dy = dt + up128(kSeg * CH * esize);
    B = dy + up128(kSeg * CH * 4);
    C = B + up128(kSeg * DS * esize);
    slot = C + up128(kSeg * DS * esize);
    stage = kStages * slot;
    dx = stage + 2 * up128((NT / 32) * kSeg * 2 * DS * 4);
    ddt = dx + 2 * up128(kSeg * CH * esize);
    bar = ddt + 2 * up128(kSeg * CH * esize);
    ckpt = bar + up128(8 * kStages);
    total = ckpt + (ckpt_smem ? nseg * NT * Q * 4 : 0);
    tx1 = kSeg * (2 * CH + DS) * esize;
    tx2 = tx1 + kSeg * (CH * 4 + DS * esize);
  }
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int DS, typename T>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocks)
mamba_chunk_fwd_kernel(const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mdt,
                       const __grid_constant__ CUtensorMap mB,
                       const __grid_constant__ CUtensorMap mC,
                       const T* __restrict__ x, const T* __restrict__ dt,
                       const T* __restrict__ Bm, const T* __restrict__ Cm,
                       const float* __restrict__ A,
                       const float* __restrict__ h0, float* __restrict__ y,
                       float* __restrict__ hout, int c, int di, int ds,
                       bool vec) {
  using Ln = Lanes<DS, kQFwd, kFwdThreads>;
  constexpr int NT = kFwdThreads, Q = Ln::Q, LPC = Ln::LPC, CH = Ln::CH;
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem lay(CH, DS, sizeof(T));
  const int tid = threadIdx.x, ch = tid / LPC, sg = tid - ch * LPC;
  const int b = blockIdx.y, d0 = blockIdx.x * CH, d = d0 + ch;
  const bool live = d < di;
  const size_t sbase = (static_cast<size_t>(b) * di + d) * ds;
  float a[Q], h[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = sg * Q + q;
    const bool on = live && s < ds;
    a[q] = on ? A[static_cast<size_t>(d) * ds + s] : 0.f;
    h[q] = on ? h0[sbase + s] : 0.f;
  }
  const int ntiles = (c + kTile - 1) / kTile;
  const Share shT(NT, CH, 1), shF(NT, CH, vec ? 4 : 1);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  if (vec && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) hp::mbar_init(&bar[i], 1);
    hp::mbar_init_fence();
  }
  if (vec && (threadIdx.x & 31) == 0) {  // the map warp e asks boxes of
    const int e = threadIdx.x >> 5;
    if (e < 4) prefetch_map(e == 0 ? &mx : e == 1 ? &mdt : e == 2 ? &mB : &mC);
  }
  __syncthreads();
  // Tile j into its slot: TMA boxes of kTile rows of the (B c, di) and
  // (B c, ds) views, asked for by thread 0 (rows past the chunk are unused,
  // channels past di come as zeros), else plain loads.
  auto issue = [&](int j) {
    unsigned char* s = smem + (j % kStages) * lay.slot;
    const int t0 = j * kTile;
    if (vec) {
      // lane 0 of warp e asks for box e (see the backward)
      uint64_t* sb = &bar[j % kStages];
      const int row = b * c + t0;
      for (int e = threadIdx.x >> 5; e < 4; e += NT >> 5) {
        if ((threadIdx.x & 31) != 0) break;
        if (e == 0) {
          hp::mbar_arrive_expect_tx(sb, lay.tx);
          hp::tma_load_2d(s + lay.x, &mx, d0, row, sb);
        } else if (e == 1) {
          hp::tma_load_2d(s + lay.dt, &mdt, d0, row, sb);
        } else if (e == 2) {
          hp::tma_load_2d(s + lay.B, &mB, 0, row, sb);
        } else {
          hp::tma_load_2d(s + lay.C, &mC, 0, row, sb);
        }
      }
      return;
    }
    const int len = min(kTile, c - t0);
    load_rows(reinterpret_cast<T*>(s + lay.x), x, shT, b, t0, len, kTile, d0,
              CH, c, di);
    load_rows(reinterpret_cast<T*>(s + lay.dt), dt, shT, b, t0, len, kTile,
              d0, CH, c, di);
    load_states<DS, NT>(reinterpret_cast<T*>(s + lay.B), Bm, b, t0, len,
                        kTile, c, ds);
    load_states<DS, NT>(reinterpret_cast<T*>(s + lay.C), Cm, b, t0, len,
                        kTile, c, ds);
  };
  float* sy = reinterpret_cast<float*>(smem + lay.y);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    if (i < ntiles) issue(i);
  for (int j = 0; j < ntiles; ++j) {
    if (vec) hp::mbar_wait(&bar[j % kStages], (j / kStages) & 1);
    __syncthreads();  // tile j has landed; tile j - 1's slot and y are done
    if (j > 0)
      store_rows(y, sy + ((j - 1) & 1) * kTile * CH, shF, b, (j - 1) * kTile,
                 kTile, d0, CH, c, di, vec);
    if (j + kStages - 1 < ntiles) issue(j + kStages - 1);
    const unsigned char* s = smem + (j % kStages) * lay.slot;
    const T* sx = reinterpret_cast<const T*>(s + lay.x);
    const T* sdt = reinterpret_cast<const T*>(s + lay.dt);
    const T* sB = reinterpret_cast<const T*>(s + lay.B);
    const T* sC = reinterpret_cast<const T*>(s + lay.C);
    float* yb = sy + (j & 1) * kTile * CH;
    const int len = min(kTile, c - j * kTile);
    // A whole tile is one run of straight-line code, so the compiler
    // interleaves its steps' loads, exps and shuffles; only the chunk's
    // last tile may be partial (`len` is the same for the whole block).
    // y stays in registers until the tile's last step: a store into shared
    // memory between two steps would order the next step's loads after it
    auto tile = [&](auto full) {
      float yv[kTile];
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        yv[k] = 0.f;
        if (decltype(full)::value || k < len) {
          const float dtk = to_f(sdt[k * CH + ch]);
          const float dtx = dtk * to_f(sx[k * CH + ch]);
          float Bv[Q], Cv[Q];
          lds_q<Q>(sB + k * DS + sg * Q, Bv);
          lds_q<Q>(sC + k * DS + sg * Q, Cv);
          float acc = 0.f;
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            h[q] = fmaf(decay(dtk, a[q]), h[q], dtx * Bv[q]);
            acc = fmaf(h[q], Cv[q], acc);
          }
#pragma unroll
          for (int o = 1; o < LPC; o <<= 1)
            acc += __shfl_xor_sync(kFull, acc, o);
          yv[k] = acc;
        }
      }
      if (sg == 0) {
#pragma unroll
        for (int k = 0; k < kTile; ++k)
          if (decltype(full)::value || k < len) yb[k * CH + ch] = yv[k];
      }
    };
    if (len == kTile)
      tile(std::true_type{});
    else
      tile(std::false_type{});
  }
  __syncthreads();
  store_rows(y, sy + ((ntiles - 1) & 1) * kTile * CH, shF, b,
             (ntiles - 1) * kTile, c - (ntiles - 1) * kTile, d0, CH, c, di,
             vec);
  if (live) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (sg * Q + q < ds) hout[sbase + sg * Q + q] = h[q];
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// The reduce-scatter of a warp's N values a lane over the lanes that differ
// in bits O, O / 2, ..., LPC of the lane index (a warp's channels): at each
// level a lane keeps half of its values (the upper half where its bit is
// set), adds the partner's copy of that half and passes on the other half;
// once one value is left, the remaining levels add the partner's value.
// v[0] ends as the sum over the warp's channels of entry
// scatter_entry<N, O, LPC>(lane).
template <int N, int O, int LPC>
__device__ __forceinline__ void scatter_sum(float* v, int lane) {
  if constexpr (O >= LPC) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      scatter_sum<H, O / 2, LPC>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      scatter_sum<1, O / 2, LPC>(v, lane);
    }
  }
}

template <int N, int O, int LPC>
__device__ __forceinline__ int scatter_entry(int lane) {
  if constexpr (O >= LPC && N > 1) {
    return ((lane & O) ? N / 2 : 0) + scatter_entry<N / 2, O / 2, LPC>(lane);
  } else {
    return 0;
  }
}

// the lane bits at which scatter_sum adds whole values (lanes that differ
// only there hold the same entry)
template <int N, int O, int LPC>
__device__ __forceinline__ int scatter_dups() {
  if constexpr (O >= LPC) {
    return (N > 1 ? 0 : O) + scatter_dups<(N > 1 ? N / 2 : 1), O / 2, LPC>();
  } else {
    return 0;
  }
}

template <int DS, typename T>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocks)
mamba_chunk_bwd_kernel(const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mdt,
                       const __grid_constant__ CUtensorMap mdy,
                       const __grid_constant__ CUtensorMap mB,
                       const __grid_constant__ CUtensorMap mC,
                       const T* __restrict__ x, const T* __restrict__ dt,
                       const T* __restrict__ Bm, const T* __restrict__ Cm,
                       const float* __restrict__ A,
                       const float* __restrict__ h0,
                       const float* __restrict__ dy,
                       const float* __restrict__ dhl, T* __restrict__ dx,
                       T* __restrict__ ddt, float* __restrict__ part,
                       float* __restrict__ ckpt_g, float* __restrict__ dA,
                       float* __restrict__ dh0, int c, int di, int ds,
                       bool ckpt_smem, bool vec) {
  using Ln = Lanes<DS, kQBwd, kBwdThreads>;
  constexpr int NT = kBwdThreads, Q = Ln::Q, LPC = Ln::LPC, CH = Ln::CH;
  constexpr int NW = NT / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nseg = (c + kSeg - 1) / kSeg;
  const BwdSmem lay(CH, DS, Q, sizeof(T), nseg, ckpt_smem);
  const int tid = threadIdx.x, ch = tid / LPC, sg = tid - ch * LPC;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, tile = blockIdx.x, ntiles = gridDim.x;
  const int d0 = tile * CH, d = d0 + ch;
  const bool live = d < di;
  const size_t sbase = (static_cast<size_t>(b) * di + d) * ds;

  float a[Q], h[Q], dh[Q], dacc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = sg * Q + q;
    const bool on = live && s < ds;
    a[q] = on ? A[static_cast<size_t>(d) * ds + s] : 0.f;
    h[q] = on ? h0[sbase + s] : 0.f;
    dh[q] = on ? dhl[sbase + s] : 0.f;
    dacc[q] = 0.f;
  }
  // where this lane's d-sum of dB/dC lands in a warp's row of 2 DS entries
  const int e = scatter_entry<2 * Q, 16, LPC>(lane);
  const int row_entry = (e / Q) * DS + sg * Q + e % Q;
  const bool writer = (lane & scatter_dups<2 * Q, 16, LPC>()) == 0;
  // checkpoints in shared memory: [segment][state q][thread]
  float* ck_s = reinterpret_cast<float*>(smem + lay.ckpt) + tid;
  // this thread's Q states of segment j's checkpoint in device memory:
  // 16-byte accesses where the states are whole (ds == DS), else one state
  // at a time; nothing past ds or di
  auto ck_g = [&](int j) {
    return ckpt_g + ((static_cast<size_t>(b) * nseg + j) * di + d) * ds +
           sg * Q;
  };
  auto ckpt_store = [&](float* p, const float (&v)[Q]) {
    if (!live) return;
    if constexpr (Q % 4 == 0) {
      if (ds == DS) {
#pragma unroll
        for (int q = 0; q < Q; q += 4)
          *reinterpret_cast<float4*>(p + q) =
              make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
        return;
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (sg * Q + q < ds) p[q] = v[q];
  };
  auto ckpt_load = [&](const float* p, float (&v)[Q]) {
    if constexpr (Q % 4 == 0) {
      if (live && ds == DS) {
#pragma unroll
        for (int q = 0; q < Q; q += 4) {
          const float4 f = *reinterpret_cast<const float4*>(p + q);
          v[q] = f.x;
          v[q + 1] = f.y;
          v[q + 2] = f.z;
          v[q + 3] = f.w;
        }
        return;
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
      v[q] = live && sg * Q + q < ds ? p[q] : 0.f;
  };

  // ring items: the forward pass over segments 0 .. nseg - 1, then the
  // reverse pass over segments nseg - 1 .. 0
  const int items = 2 * nseg;
  const Share shL(NT, CH, 1), shT(NT, CH, vec ? 16 / sizeof(T) : 1);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  if (vec && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) hp::mbar_init(&bar[i], 1);
    hp::mbar_init_fence();
  }
  if (vec && lane == 0 && warp < 5)  // the map warp e asks boxes of
    prefetch_map(warp == 0   ? &mx
                 : warp == 1 ? &mdt
                 : warp == 2 ? &mB
                 : warp == 3 ? &mdy
                             : &mC);
  __syncthreads();
  auto seg_of = [&](int i) { return i < nseg ? i : items - 1 - i; };
  // the staging buffers of reverse item i: i & 1
  auto stage_of = [&](int i) {
    return reinterpret_cast<float*>(
        smem + lay.stage + (i & 1) * up128(NW * kSeg * 2 * DS * 4));
  };
  auto sdx_of = [&](int i) {
    return reinterpret_cast<T*>(smem + lay.dx +
                                (i & 1) * up128(kSeg * CH * sizeof(T)));
  };
  auto sddt_of = [&](int i) {
    return reinterpret_cast<T*>(smem + lay.ddt +
                                (i & 1) * up128(kSeg * CH * sizeof(T)));
  };
  // The end of reverse item i, run after the block has met past it: dB, dC
  // of the block's channels (the warps' rows summed in warp order, this
  // tile's partial row written once), dx and ddt stored.
  auto finish = [&](int i) {
    const int t0 = seg_of(i) * kSeg, len = min(kSeg, c - t0);
    const float* stage = stage_of(i);
    for (int idx = tid; idx < kSeg * 2 * DS; idx += NT) {
      const int k = idx / (2 * DS), which = (idx / DS) & 1, ss = idx % DS;
      if (k < len && ss < ds) {
        // the warps' rows read at once, then added in warp order
        float row[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w)
          row[w] = stage[(w * kSeg + k) * 2 * DS + which * DS + ss];
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) acc += row[w];
        part[((static_cast<size_t>(b) * ntiles + tile) * c + t0 + k) * 2 *
                 ds + which * ds + ss] = acc;
      }
    }
    store_rows(dx, sdx_of(i), shT, b, t0, len, d0, CH, c, di, vec);
    store_rows(ddt, sddt_of(i), shT, b, t0, len, d0, CH, c, di, vec);
  };
  // Item i into its slot: TMA boxes of kSeg rows (see the forward), else
  // plain loads.
  auto issue = [&](int i) {
    unsigned char* s = smem + (i % kStages) * lay.slot;
    const int t0 = seg_of(i) * kSeg;
    const bool rev = i >= nseg;
    if (vec) {
      // lane 0 of warp e asks for box e (warp 0 first sets the bytes the
      // slot's barrier waits for; a box may land before that, the phase
      // cannot end before warp 0 arrives)
      uint64_t* sb = &bar[i % kStages];
      const int row = b * c + t0;
      for (int e = warp; e < (rev ? 5 : 3); e += NW) {
        if (lane != 0) break;
        if (e == 0) {
          hp::mbar_arrive_expect_tx(sb, rev ? lay.tx2 : lay.tx1);
          hp::tma_load_2d(s + lay.x, &mx, d0, row, sb);
        } else if (e == 1) {
          hp::tma_load_2d(s + lay.dt, &mdt, d0, row, sb);
        } else if (e == 2) {
          hp::tma_load_2d(s + lay.B, &mB, 0, row, sb);
        } else if (e == 3) {
          hp::tma_load_2d(s + lay.dy, &mdy, d0, row, sb);
        } else {
          hp::tma_load_2d(s + lay.C, &mC, 0, row, sb);
        }
      }
      return;
    }
    const int len = min(kSeg, c - t0);
    load_rows(reinterpret_cast<T*>(s + lay.x), x, shL, b, t0, len, kSeg, d0,
              CH, c, di);
    load_rows(reinterpret_cast<T*>(s + lay.dt), dt, shL, b, t0, len, kSeg, d0,
              CH, c, di);
    load_states<DS, NT>(reinterpret_cast<T*>(s + lay.B), Bm, b, t0, len, kSeg,
                        c, ds);
    if (rev) {
      load_rows(reinterpret_cast<float*>(s + lay.dy), dy, shL, b, t0, len,
                kSeg, d0, CH, c, di);
      load_states<DS, NT>(reinterpret_cast<T*>(s + lay.C), Cm, b, t0, len,
                          kSeg, c, ds);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    if (i < items) issue(i);
  float cnext[Q];  // the next reverse segment's checkpoint, read ahead
#pragma unroll
  for (int q = 0; q < Q; ++q) cnext[q] = 0.f;

  for (int i = 0; i < items; ++i) {
    if (vec) hp::mbar_wait(&bar[i % kStages], (i / kStages) & 1);
    __syncthreads();  // item i has landed; item i - 1 is done with
    if (i > nseg) finish(i - 1);
    if (i + kStages - 1 < items) issue(i + kStages - 1);
    const int j = seg_of(i), t0 = j * kSeg, len = min(kSeg, c - t0);
    const unsigned char* s = smem + (i % kStages) * lay.slot;
    const T* sx = reinterpret_cast<const T*>(s + lay.x);
    const T* sdt = reinterpret_cast<const T*>(s + lay.dt);
    const float* sdy = reinterpret_cast<const float*>(s + lay.dy);
    const T* sB = reinterpret_cast<const T*>(s + lay.B);
    const T* sC = reinterpret_cast<const T*>(s + lay.C);

    if (i < nseg) {
      // pass 1: keep h at the segment's start, step through it
      if (ckpt_smem) {
#pragma unroll
        for (int q = 0; q < Q; ++q) ck_s[(j * Q + q) * NT] = h[q];
      } else {
        ckpt_store(ck_g(j), h);
      }
      // a whole segment is one run of straight-line code (see the forward)
      auto forward = [&](auto full) {
#pragma unroll
        for (int k = 0; k < kSeg; ++k) {
          if (decltype(full)::value || k < len) {
            const float dtk = to_f(sdt[k * CH + ch]);
            const float dtx = dtk * to_f(sx[k * CH + ch]);
            float Bv[Q];
            lds_q<Q>(sB + k * DS + sg * Q, Bv);
#pragma unroll
            for (int q = 0; q < Q; ++q)
              h[q] = fmaf(decay(dtk, a[q]), h[q], dtx * Bv[q]);
          }
        }
      };
      if (len == kSeg)
        forward(std::true_type{});
      else
        forward(std::false_type{});
      continue;
    }

    // pass 2: the segment's states recomputed from its checkpoint
    float hst[Q];
    if (ckpt_smem) {
#pragma unroll
      for (int q = 0; q < Q; ++q) hst[q] = ck_s[(j * Q + q) * NT];
    } else {
      if (i == nseg) {  // written by this thread in the last item
        ckpt_load(ck_g(j), hst);
      } else {
#pragma unroll
        for (int q = 0; q < Q; ++q) hst[q] = cnext[q];
      }
      if (j > 0) {
        ckpt_load(ck_g(j - 1), cnext);
      }
    }
    float* stage = stage_of(i);
    T* sdx = sdx_of(i);
    T* sddt = sddt_of(i);
    auto reverse = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
      float hs[kSeg][Q], dec[kSeg][Q], hh[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) hh[q] = hst[q];
#pragma unroll
      for (int k = 0; k < kSeg; ++k) {
        if (FULL || k < len) {
          const float dtk = to_f(sdt[k * CH + ch]);
          const float dtx = dtk * to_f(sx[k * CH + ch]);
          float Bv[Q];
          lds_q<Q>(sB + k * DS + sg * Q, Bv);
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            dec[k][q] = decay(dtk, a[q]);
            hh[q] = fmaf(dec[k][q], hh[q], dtx * Bv[q]);
            hs[k][q] = hh[q];
          }
        } else {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            dec[k][q] = 0.f;
            hs[k][q] = 0.f;
          }
        }
      }
      // the step's outputs stay in registers until the segment's last step
      // (see the forward): dx (lane 0 of a channel) or ddt (lane LPC - 1),
      // and this lane's entry of the warp's dB/dC row
      float ov[kSeg], rv[kSeg];
#pragma unroll
      for (int k = kSeg - 1; k >= 0; --k) {
        ov[k] = rv[k] = 0.f;
        if (FULL || k < len) {
          const float dtk = to_f(sdt[k * CH + ch]);
          const float xk = to_f(sx[k * CH + ch]);
          const float dyk = sdy[k * CH + ch];
          const float dtx = dtk * xk;
          float Bv[Q], Cv[Q], v[2 * Q];
          lds_q<Q>(sB + k * DS + sg * Q, Bv);
          lds_q<Q>(sC + k * DS + sg * Q, Cv);
          float gb = 0.f, ga = 0.f;
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const float hp = k > 0 ? hs[k > 0 ? k - 1 : 0][q] : hst[q];
            const float g = fmaf(dyk, Cv[q], dh[q]);
            const float du = g * hp * dec[k][q];
            dacc[q] = fmaf(du, dtk, dacc[q]);
            gb = fmaf(g, Bv[q], gb);
            ga = fmaf(du, a[q], ga);
            v[q] = g * dtx;
            v[Q + q] = hs[k][q] * dyk;
            dh[q] = g * dec[k][q];
          }
#pragma unroll
          for (int o = 1; o < LPC; o <<= 1) {
            gb += __shfl_xor_sync(kFull, gb, o);
            ga += __shfl_xor_sync(kFull, ga, o);
          }
          ov[k] = sg == 0 ? dtk * gb : ga + xk * gb;
          scatter_sum<2 * Q, 16, LPC>(v, lane);
          rv[k] = v[0];
        }
      }
#pragma unroll
      for (int k = 0; k < kSeg; ++k) {
        if (FULL || k < len) {
          if (sg == 0) sdx[k * CH + ch] = from_f<T>(ov[k]);
          if (sg == LPC - 1) sddt[k * CH + ch] = from_f<T>(ov[k]);
          if (writer) stage[(warp * kSeg + k) * 2 * DS + row_entry] = rv[k];
        }
      }
    };
    if (len == kSeg)
      reverse(std::true_type{});
    else
      reverse(std::false_type{});
  }
  __syncthreads();  // the last segment's rows and dx, ddt are staged
  finish(items - 1);
  if (live) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (sg * Q + q < ds) {
        dh0[sbase + sg * Q + q] = dh[q];
        dA[sbase + sg * Q + q] = dacc[q];
      }
    }
  }
}

// dB, dC (B, c, ds) = the partials of every tile, summed in tile order.
// Grid (ceil(c * 2 * ds / kReduceThreads), B).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
mamba_dbc_reduce_kernel(const float* __restrict__ part, T* __restrict__ dB,
                        T* __restrict__ dC, int c, int ds, int ntiles) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;  // (t, which, s)
  if (e >= c * 2 * ds) return;
  const int b = blockIdx.y;
  const int t = e / (2 * ds), r = e - t * 2 * ds;
  const int which = r >= ds ? 1 : 0, ss = r - which * ds;
  const size_t stride = static_cast<size_t>(c) * 2 * ds;  // a tile's row
  const float* p = part + static_cast<size_t>(b) * ntiles * stride + e;
  float v = 0.f;
  for (int tl = 0; tl < ntiles; ++tl) v += p[tl * stride];
  T* out = which == 0 ? dB : dC;
  out[(static_cast<size_t>(b) * c + t) * ds + ss] = from_f<T>(v);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// TMA boxes and 16-byte stores: full states, rows of whole 16-byte
// vectors, aligned base pointers, rows of the (B c, .) views on int
// coordinates
template <typename T>
bool vec_ok(int batch, int c, int di, int ds, int DS,
            std::initializer_list<const void*> ps) {
  if (ds != DS || di % (16 / static_cast<int>(sizeof(T))) != 0 ||
      static_cast<long long>(batch) * c >= (1ll << 31))
    return false;
  for (const void* p : ps)
    if (!aligned16(p)) return false;
  return true;
}

// The (rows, cols) row-major view of `ptr` as boxes of box_rows x box_cols
// elements, not swizzled, zero-filled outside. Returns a cudaError_t code.
template <typename U>
int box_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
            uint32_t box_rows, uint32_t box_cols) {
  const hp::EncodeTiled fn = hp::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(U)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r =
      fn(map,
         sizeof(U) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
         2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The maps of x, dt (and dy) as (B c, di) boxes of `rows` x CH and of B, C
// as (B c, DS) boxes of `rows` x DS; left zeroed when `vec` is false.
template <typename T>
int input_maps(bool vec, CUtensorMap (&m)[5], const void* x, const void* dt,
               const void* dy, const void* Bm, const void* Cm, int batch,
               int c, int di, int DS, int CH, int rows) {
  memset(m, 0, sizeof(m));
  if (!vec) return 0;
  const uint64_t n = static_cast<uint64_t>(batch) * c;
  int err = box_map<T>(&m[0], x, n, di, rows, CH);
  if (err == 0) err = box_map<T>(&m[1], dt, n, di, rows, CH);
  if (err == 0 && dy != nullptr)
    err = box_map<float>(&m[2], dy, n, di, rows, CH);
  if (err == 0) err = box_map<T>(&m[3], Bm, n, DS, rows, DS);
  if (err == 0) err = box_map<T>(&m[4], Cm, n, DS, rows, DS);
  return err;
}

// Raises a kernel's dynamic shared-memory limit on the current device to
// `smem` where it is lower: a limit only grows, so no launch can find it
// lowered by another shape's, and it is set once, not at every launch.
template <typename K>
int set_smem(K kernel, int smem) {
  constexpr int kSlots = 64;
  static const void* kernels[kSlots] = {};
  static int devices[kSlots] = {};
  static int limits[kSlots] = {};
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* k = reinterpret_cast<const void*>(kernel);
  int i = 0;
  while (i < kSlots && kernels[i] != nullptr &&
         !(kernels[i] == k && devices[i] == dev))
    ++i;
  if (i == kSlots) return static_cast<int>(cudaErrorInvalidValue);
  if (kernels[i] != nullptr && limits[i] >= smem) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernels[i] = k;
  devices[i] = dev;
  limits[i] = smem;
  return 0;
}

bool bad_shape(int batch, int c, int di, int ds) {
  return batch < 1 || batch > 65535 || c < 1 || di < 1 || ds < 1 || ds > 16;
}

// A call's launch, worked out from the shape and the constants above only
// (never from the SM count or a failure): a grid of (tiles, batch) blocks
// of `threads` threads (kFwdThreads or kBwdThreads), a thread owning q of a
// channel's DS (padded) states, a channel spanning `lanes` lanes and a
// block `channels` channels; the chunk walked in nseg tiles (forward) or
// segments (backward) of `steps` steps; the backward's checkpoints in
// shared memory where the block then fits kSmemBudget, else in a device
// scratch; `smem` the bytes a block.
struct Plan {
  int DS, q, lanes, threads, channels, tiles, steps, nseg, ckpt_smem, smem;
  Plan(int c, int di, int ds, int esize, bool backward) {
    DS = ds <= 8 ? 8 : 16;
    q = states_a_thread(DS, backward ? kQBwd : kQFwd);
    lanes = DS / q;
    threads = backward ? kBwdThreads : kFwdThreads;
    channels = threads / lanes;
    tiles = (di + channels - 1) / channels;
    steps = backward ? kSeg : kTile;
    nseg = (c + steps - 1) / steps;
    ckpt_smem = 0;
    if (!backward) {
      smem = FwdSmem(channels, DS, esize).total;
      return;
    }
    smem = BwdSmem(channels, DS, q, esize, nseg, true).total;
    ckpt_smem = smem <= kSmemBudget;
    if (!ckpt_smem) smem = BwdSmem(channels, DS, q, esize, nseg, false).total;
  }
};

template <int DS, typename T>
int launch_fwd(const void* x, const void* dt, const void* Bm, const void* Cm,
               const float* A, const float* h0, float* y, float* hout,
               int batch, int c, int di, int ds, cudaStream_t stream) {
  const Plan p(c, di, ds, sizeof(T), false);
  auto kernel = mamba_chunk_fwd_kernel<DS, T>;
  int err = set_smem(kernel, p.smem);
  if (err != 0) return err;
  const bool vec = vec_ok<T>(batch, c, di, ds, DS, {x, dt, Bm, Cm, y});
  CUtensorMap m[5];
  err = input_maps<T>(vec, m, x, dt, nullptr, Bm, Cm, batch, c, di, DS,
                      p.channels, kTile);
  if (err != 0) return err;
  kernel<<<dim3(p.tiles, batch), p.threads, p.smem, stream>>>(
      m[0], m[1], m[3], m[4], static_cast<const T*>(x),
      static_cast<const T*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), A, h0, y, hout, c, di, ds, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DS, typename T>
int launch_bwd(const void* x, const void* dt, const void* Bm, const void* Cm,
               const float* A, const float* h0, const float* dy,
               const float* dhl, void* dx, void* ddt, void* dB, void* dC,
               float* part, float* ckpt, float* dA, float* dh0, int batch,
               int c, int di, int ds, cudaStream_t stream) {
  const Plan p(c, di, ds, sizeof(T), true);
  if (!p.ckpt_smem && ckpt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = mamba_chunk_bwd_kernel<DS, T>;
  int err = set_smem(kernel, p.smem);
  if (err != 0) return err;
  const bool vec =
      vec_ok<T>(batch, c, di, ds, DS, {x, dt, Bm, Cm, dy, dx, ddt});
  CUtensorMap m[5];
  err = input_maps<T>(vec, m, x, dt, dy, Bm, Cm, batch, c, di, DS,
                      p.channels, kSeg);
  if (err != 0) return err;
  kernel<<<dim3(p.tiles, batch), p.threads, p.smem, stream>>>(
      m[0], m[1], m[2], m[3], m[4], static_cast<const T*>(x),
      static_cast<const T*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), A, h0, dy, dhl, static_cast<T*>(dx),
      static_cast<T*>(ddt), part, ckpt, dA, dh0, c, di, ds, p.ckpt_smem != 0,
      vec);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 rgrid((c * 2 * ds + kReduceThreads - 1) / kReduceThreads, batch);
  mamba_dbc_reduce_kernel<T><<<rgrid, kReduceThreads, 0, stream>>>(
      part, static_cast<T*>(dB), static_cast<T*>(dC), c, ds, p.tiles);
  return static_cast<int>(cudaGetLastError());
}

int esize_of(int dtype) {
  return dtype == port::kF32 ? 4 : dtype == port::kBF16 ? 2 : 0;
}

}  // namespace

extern "C" {

// The built constants: {kQFwd, kQBwd, kSeg, kTile, kStages, kFwdThreads,
// kBwdThreads, kFwdBlocks, kBwdBlocks, kSmemBudget}.
int mamba_scan_constants(int* out) {
  const int v[] = {kQFwd,       kQBwd,       kSeg,       kTile,
                   kStages,     kFwdThreads, kBwdThreads, kFwdBlocks,
                   kBwdBlocks,  kSmemBudget};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// The launch of a call on (batch, c, di, ds) inputs of `dtype` (Plan):
// {DS, q, lanes, threads, channels, tiles, steps, nseg, stages, ckpt_smem,
// smem}.
int mamba_scan_plan(int batch, int c, int di, int ds, int dtype, int backward,
                    int* out) {
  if (bad_shape(batch, c, di, ds) || esize_of(dtype) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p(c, di, ds, esize_of(dtype), backward != 0);
  const int v[] = {p.DS,    p.q,    p.lanes, p.threads,   p.channels, p.tiles,
                   p.steps, p.nseg, kStages, p.ckpt_smem, p.smem};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// x, dt: (batch, c, di) and Bm, Cm: (batch, c, ds) of `dtype`; A: (di, ds)
// f32; h0, hout: (batch, di, ds) f32; y: (batch, c, di) f32.
int mamba_chunk_fwd(const void* x, const void* dt, const void* Bm,
                    const void* Cm, const float* A, const float* h0, float* y,
                    float* hout, int batch, int c, int di, int ds, int dtype,
                    cudaStream_t stream) {
  if (bad_shape(batch, c, di, ds))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32) {
    if (ds <= 8)
      return launch_fwd<8, float>(x, dt, Bm, Cm, A, h0, y, hout, batch, c,
                                  di, ds, stream);
    return launch_fwd<16, float>(x, dt, Bm, Cm, A, h0, y, hout, batch, c, di,
                                 ds, stream);
  }
  if (dtype == port::kBF16) {
    if (ds <= 8)
      return launch_fwd<8, __nv_bfloat16>(x, dt, Bm, Cm, A, h0, y, hout,
                                          batch, c, di, ds, stream);
    return launch_fwd<16, __nv_bfloat16>(x, dt, Bm, Cm, A, h0, y, hout, batch,
                                         c, di, ds, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// As the forward, plus dy: (batch, c, di) f32 and dhl: (batch, di, ds) f32.
// Writes dx, ddt (batch, c, di) and dB, dC (batch, c, ds) in `dtype`, and
// dA (per batch row), dh0 (batch, di, ds) f32. part: (batch, tiles, c, 2,
// ds) f32 scratch; ckpt: (batch, nseg, di, ds) f32 scratch where the plan
// keeps the checkpoints out of shared memory (else it may be null).
int mamba_chunk_bwd(const void* x, const void* dt, const void* Bm,
                    const void* Cm, const float* A, const float* h0,
                    const float* dy, const float* dhl, void* dx, void* ddt,
                    void* dB, void* dC, float* part, float* ckpt, float* dA,
                    float* dh0, int batch, int c, int di, int ds, int dtype,
                    cudaStream_t stream) {
  if (bad_shape(batch, c, di, ds))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == port::kF32) {
    if (ds <= 8)
      return launch_bwd<8, float>(x, dt, Bm, Cm, A, h0, dy, dhl, dx, ddt, dB,
                                  dC, part, ckpt, dA, dh0, batch, c, di, ds,
                                  stream);
    return launch_bwd<16, float>(x, dt, Bm, Cm, A, h0, dy, dhl, dx, ddt, dB,
                                 dC, part, ckpt, dA, dh0, batch, c, di, ds,
                                 stream);
  }
  if (dtype == port::kBF16) {
    if (ds <= 8)
      return launch_bwd<8, __nv_bfloat16>(x, dt, Bm, Cm, A, h0, dy, dhl, dx,
                                          ddt, dB, dC, part, ckpt, dA, dh0,
                                          batch, c, di, ds, stream);
    return launch_bwd<16, __nv_bfloat16>(x, dt, Bm, Cm, A, h0, dy, dhl, dx,
                                         ddt, dB, dC, part, ckpt, dA, dh0,
                                         batch, c, di, ds, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
