// Ghost Batch Normalization forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gbn.py:
//   gbn_forward_pallas  (_stats_kernel + _normalize_kernel)
//   gbn_backward_pallas (_bwd_stats_kernel + _bwd_dx_kernel)
//
// Every kernel works on f32 tensors laid out (G, R, C): G ghost batches, R
// rows per ghost (ghost_batch * H * W for a convolution), C channels
// innermost and contiguous. There is no matrix product here, so the pair is
// bound by device-memory bytes: at least read x and write y (forward), read
// x and dy and write dx (backward). Each direction has two bodies, and
// kernels/gbn.py:plan picks one from (G, R, C), the SM count and the
// shared-memory budget.
//
// The persistent body (one kernel a call) reads each input from device
// memory once. Its grid is co-resident (a cooperative launch, refused
// rather than left to deadlock when it cannot be) and split into groups of
// P blocks; group k takes ghosts k, k + ngroups, ... in order, and block p
// of a group owns rows [p * slice_rows, (p + 1) * slice_rows) of each, its
// slice: one contiguous run of bytes, since C is innermost. A block walks
// its slices as a stream of sub-chunks (sub_rows rows each) through a ring
// of nslot shared-memory slots; thread 0 brings a sub-chunk into its slot
// with one 1-D bulk copy an input (cp.async.bulk, completing on the slot's
// mbarrier; an unaligned head or tail of fewer than four floats is copied
// by the thread itself first). For each ghost the block
//   1. reduces its staged slice to a per-channel partial (forward: the
//      slice's mean and M2 from sums shifted by its first row; backward:
//      sum dy and sum dy * xhat, rstd computed here from var) and stores it
//      to a (G, P, C) scratch;
//   2. arrives on the ghost's counter (release at device scope); when it
//      comes to merge the ghost it waits until all P blocks have
//      (acquire), then reads the P partials from L2;
//   3. merges them in one fixed order (thread j of a channel sums a range
//      of partials in index order, then the ranges are summed in order), so
//      every block of the group holds the same bits: the forward merges
//      (n, mean, M2) with Chan's formula about block 0's mean, the backward
//      sums and then forms the dx coefficients of its ghost;
//   4. normalizes its staged slice and writes y (or dx), freeing each slot
//      as it goes: thread 0 refills the slot with the sub-chunk nslot
//      further along the walk, the next ghost's. Where the ring holds more
//      than one slice, the next ghost's copies are in flight while the
//      block waits at step 2.
// Block 0 of a group writes its ghosts' mu/var (forward) or per-ghost sums
// (backward). The backward's dgamma/dbeta sum the per-ghost sums over G in
// ghost order: the last group to finish (a second counter) does that. The
// launch zeroes the counters (one memset) before the kernel runs.
//
// The two-pass body (where a ghost's slices do not fit the grid's shared
// memory) reads each input twice: blockIdx.y is the ghost, blockIdx.x a
// chunk of chunk_rows rows; a statistics kernel writes per-chunk partials,
// a small kernel merges them in chunk order (deterministic), and a third
// normalizes (forward: 3 kernels; backward: 4, the dx coefficients and the
// ghost sums of dgamma/dbeta in kernels of their own).
//
// In both bodies thread t owns the VEC consecutive channels starting at
// (t % CV) * VEC, CV = C / VEC, and the rows lane, lane + L, ... of what
// its block holds, lane = t / CV, L = blockDim.x / CV: a warp reads one
// contiguous run with 16-byte accesses (VEC = 4) and keeps its channels'
// coefficients in registers. C is never padded.
//
// Each exported function launches its kernels on the given stream and
// returns a cudaError_t code (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace hp = port::hopper;

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

// from shared memory (16-byte aligned when VEC = 4)
template <int VEC>
__device__ __forceinline__ void load_smem(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = p[k];
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

// A thread's channels and row lane (see the top of the file).
template <int VEC>
struct Lane {
  int cv;        // channel group: channels [cv * VEC, cv * VEC + VEC)
  int lane;      // row lane inside the block
  int lanes;     // number of row lanes
  bool active;   // threads past lanes * CV idle
  __device__ __forceinline__ explicit Lane(int C) {
    const int CV = C / VEC;
    lanes = blockDim.x / CV;
    cv = threadIdx.x % CV;
    lane = threadIdx.x / CV;
    active = lane < lanes;
  }
};

// ===========================================================================
// the persistent body
// ===========================================================================

struct Plan {
  int G, R, C;
  int P;            // blocks of a group: the slices of one ghost
  int ngroups;      // group k takes ghosts k, k + ngroups, ...
  int slice_rows;   // rows of a slice (the last of a ghost may be shorter)
  int sub_rows;     // rows of a sub-chunk: one bulk copy an input
  int nsub;         // sub-chunks of a slice
  int nslot;        // sub-chunks the ring holds (>= nsub)
  int slot_floats;  // floats of one input in one slot (a multiple of 4)
};

// Dynamic shared memory of a block, in this order (kernels/gbn.py:plan
// counts the same bytes):
//   ring  nslot x NIN x slot_floats floats
//   bars  nslot mbarriers
//   red   NT x 2 x VEC floats: each thread's two partial sums
//   tmp   2 x max(C, NT) floats: the merge's ranges
//   coef  3 x C floats: the merged per-channel values
template <int VEC, int NT, int NIN>
__host__ __device__ __forceinline__ size_t smem_bytes(const Plan& pl) {
  const size_t ring = static_cast<size_t>(pl.nslot) * NIN * pl.slot_floats;
  const size_t rest = static_cast<size_t>(NT) * 2 * VEC +
                      2 * static_cast<size_t>(pl.C > NT ? pl.C : NT) +
                      3 * static_cast<size_t>(pl.C);
  return 4 * ring + 8 * static_cast<size_t>(pl.nslot) + 4 * rest;
}

template <int VEC, int NT, int NIN>
struct Smem {
  float* ring;
  uint64_t* bars;
  float* red;
  float* tmp;
  float* coef;
  __device__ __forceinline__ Smem(unsigned char* base, const Plan& pl) {
    ring = reinterpret_cast<float*>(base);
    bars = reinterpret_cast<uint64_t*>(
        ring + static_cast<size_t>(pl.nslot) * NIN * pl.slot_floats);
    red = reinterpret_cast<float*>(bars + pl.nslot);
    tmp = red + NT * 2 * VEC;
    coef = tmp + 2 * max(pl.C, NT);
  }
};

struct Rows {
  int a, n;   // rows [a, a + n) of a ghost
};

__device__ __forceinline__ Rows slice_of(const Plan& pl, int p) {
  const int a = p * pl.slice_rows;
  return {a, max(0, min(pl.R, a + pl.slice_rows) - a)};
}

// Sub-chunk `it` of block p of group k's walk: ghost j = it / nsub of the
// group, sub-chunk s = it % nsub of its slice, in ring slot it % nslot.
struct Item {
  int slot;
  uint32_t parity;   // the slot's mbarrier phase of this use
  Rows rows;
  size_t off;        // element offset of the sub-chunk's first row
};

__device__ __forceinline__ Item item_of(const Plan& pl, int k, int p,
                                        int it) {
  Item t;
  const int j = it / pl.nsub, s = it % pl.nsub;
  t.slot = it % pl.nslot;
  t.parity = static_cast<uint32_t>(it / pl.nslot) & 1u;
  const int g = k + j * pl.ngroups;
  const Rows sl = slice_of(pl, p);
  const int a = sl.a + s * pl.sub_rows;
  t.rows = {a, max(0, min(sl.a + sl.n, a + pl.sub_rows) - a)};
  t.off = (static_cast<size_t>(g) * pl.R + a) * pl.C;
  return t;
}

// floats between a global address and the 16-byte boundary below it; an
// item's floats sit that far into their slot, so that the bulk part of the
// copy lands 16-byte aligned
__device__ __forceinline__ int lead_of(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

template <int NIN>
__device__ __forceinline__ float* staged(float* ring, const Plan& pl,
                                         const Item& t, int i,
                                         const float* in) {
  return ring + (static_cast<size_t>(t.slot) * NIN + i) * pl.slot_floats +
         lead_of(in + t.off);
}

// Thread 0: brings item `it` of the walk into its slot.
template <int NIN>
__device__ void stage(const Plan& pl, const float* const (&in)[NIN],
                      float* ring, uint64_t* bars, int k, int p, int it) {
  const Item t = item_of(pl, k, p, it);
  const int nf = t.rows.n * pl.C;
  uint32_t bytes = 0;
  int head[NIN], body[NIN];
#pragma unroll
  for (int i = 0; i < NIN; ++i) {
    const float* src = in[i] + t.off;
    float* dst = staged<NIN>(ring, pl, t, i, in[i]);
    head[i] = min(nf, (4 - lead_of(src)) & 3);
    body[i] = (nf - head[i]) & ~3;
    for (int e = 0; e < head[i]; ++e) dst[e] = __ldg(src + e);
    for (int e = head[i] + body[i]; e < nf; ++e) dst[e] = __ldg(src + e);
    bytes += 4u * static_cast<uint32_t>(body[i]);
  }
  hp::mbar_arrive_expect_tx(&bars[t.slot], bytes);
#pragma unroll
  for (int i = 0; i < NIN; ++i) {
    if (body[i] > 0) {
      const float* src = in[i] + t.off + head[i];
      float* dst = staged<NIN>(ring, pl, t, i, in[i]) + head[i];
      hp::bulk_load(dst, src, 4u * body[i], &bars[t.slot]);
    }
  }
}

// Initialises the ring's barriers and issues the walk's first items.
// Returns (in thread 0) how many were issued.
template <int NIN>
__device__ int start_ring(const Plan& pl, const float* const (&in)[NIN],
                          float* ring, uint64_t* bars, int k, int p,
                          int total) {
  int issued = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.nslot; ++s) hp::mbar_init(&bars[s], 1);
    hp::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (; issued < min(total, pl.nslot); ++issued)
      stage<NIN>(pl, in, ring, bars, k, p, issued);
  }
  return issued;
}

// The block's partial is stored: arrive on the ghost's counter. The
// release orders the stores of every thread of the block, which the
// barrier ordered before thread 0's.
__device__ __forceinline__ void group_arrive(int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) hp::red_release_add(counter, 1);
}

// Waits until `target` blocks have arrived. A wait of 2^35 clocks (~17 s)
// traps: a fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void group_wait(const int* counter, int target) {
  if (threadIdx.x == 0) {
    long long start = 0;
    while (hp::ld_acquire(counter) < target) {
      if (start == 0) {
        start = clock64();
      } else if (clock64() - start > (1ll << 35)) {
        __trap();
      }
    }
  }
  __syncthreads();
}

constexpr int kMergeBatch = 16;   // partials a thread loads before it adds

// outa[c], outb[c] = sums over q in [0, P) of term(q, part[q][c], a_0) for
// every channel, part (P, C) float2 partials (a_q, b_q) read from L2, in
// one fixed order: `split` threads a channel each sum a range of q in
// index order, then the ranges are summed in order. Any block that runs it
// gets the same bits. outp[c] (if given) keeps a_0.
template <int NT, class Term>
__device__ __forceinline__ void merge2(int P, int C, const float2* part,
                                       Term term, float* tmp, float* outp,
                                       float* outa, float* outb) {
  const int split = C >= NT ? 1 : NT / C;
  const int per = (P + split - 1) / split;
  for (int i = threadIdx.x; i < split * C; i += NT) {
    const int c = i % C, q0 = (i / C) * per, q1 = min(P, q0 + per);
    const float a0 = __ldcg(part + c).x;
    float a = 0.f, b = 0.f;
    for (int q = q0; q < q1; q += kMergeBatch) {
      float2 w[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        if (q + u < q1) w[u] = __ldcg(part + static_cast<size_t>(q + u) * C + c);
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (q + u < q1) {
          const float2 v = term(q + u, w[u], a0);
          a += v.x;
          b += v.y;
        }
      }
    }
    tmp[2 * i] = a;
    tmp[2 * i + 1] = b;
    if (outp != nullptr && i < C) outp[c] = a0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < split; ++j) {
      a += tmp[2 * (j * C + c)];
      b += tmp[2 * (j * C + c) + 1];
    }
    outa[c] = a;
    outb[c] = b;
  }
  __syncthreads();
}

// The lanes' sums of a channel group into the lane-0 thread's s1, s2, in
// a fixed order (red: NT x 2 x VEC floats). Where CV is a power of two
// below 32, the lanes of one group in a warp sit CV apart: a shuffle
// butterfly sums them (both operands of each addition are the same in
// every lane), then the lane-0 thread adds the warps' sums in warp order.
// Otherwise a tree over the lanes: lane l adds lane l + s for s = the
// largest power of two below `lanes`, then s / 2, ..., 1.
template <int VEC, int NT>
__device__ __forceinline__ void block_sums(const Lane<VEC>& ln, float* red,
                                           float (&s1)[VEC],
                                           float (&s2)[VEC], int C) {
  const int CV = C / VEC;
  if (CV < 32 && (CV & (CV - 1)) == 0) {
    for (int o = CV; o < 32; o *= 2) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
        s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], o);
      }
    }
    const int w = threadIdx.x / 32, l = threadIdx.x % 32;
    if (l < CV) {
      float* mine = red + (w * CV + l) * 2 * VEC;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        mine[k] = s1[k];
        mine[VEC + k] = s2[k];
      }
    }
    __syncthreads();
    if (ln.lane == 0) {
      for (int ww = 1; ww < NT / 32; ++ww) {
        const float* o = red + (ww * CV + ln.cv) * 2 * VEC;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          s1[k] += o[k];
          s2[k] += o[VEC + k];
        }
      }
    }
    __syncthreads();
    return;
  }
  float* mine = red + threadIdx.x * 2 * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mine[k] = s1[k];
    mine[VEC + k] = s2[k];
  }
  int top = 1;
  while (2 * top < ln.lanes) top *= 2;
  for (int s = top; s >= 1; s >>= 1) {
    __syncthreads();
    if (ln.active && ln.lane < s && ln.lane + s < ln.lanes) {
      const float* o = red + ((ln.lane + s) * CV + ln.cv) * 2 * VEC;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s1[k] += o[k];
        s2[k] += o[VEC + k];
        mine[k] = s1[k];
        mine[VEC + k] = s2[k];
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int VEC, int NT>
__global__ void __launch_bounds__(NT, NT <= 512 ? 2 : 1)
    gbn_fwd_persistent_kernel(const float* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta, float eps,
                              float* __restrict__ y, float* __restrict__ mu,
                              float* __restrict__ var, float2* part,
                              int* counters, const Plan pl) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<VEC, NT, 1> sm(smem_raw, pl);
  const int k = blockIdx.x / pl.P, p = blockIdx.x % pl.P;
  const Lane<VEC> ln(pl.C);
  const int C = pl.C, c0 = ln.cv * VEC;
  const float R = static_cast<float>(pl.R);
  const int nj = (pl.G - k + pl.ngroups - 1) / pl.ngroups;
  const int total = nj * pl.nsub;
  const float* const in[1] = {x};
  int issued = start_ring<1>(pl, in, sm.ring, sm.bars, k, p, total);
  const float n_p = static_cast<float>(slice_of(pl, p).n);
  float ga[VEC], be[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    ga[i] = __ldg(gamma + c0 + i);
    be[i] = __ldg(beta + c0 + i);
  }
  // 1. sums of x - shift over the staged slice, shift = its first row;
  // the slice's (mean, M2) stored; 2. arrive
  auto reduce = [&](int j) {
    const int g = k + j * pl.ngroups;
    float shift[VEC], s1[VEC], s2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
    for (int s = 0; s < pl.nsub; ++s) {
      const Item t = item_of(pl, k, p, j * pl.nsub + s);
      hp::mbar_wait(&sm.bars[t.slot], t.parity);
      const float* xs = staged<1>(sm.ring, pl, t, 0, x) + c0;
      if (s == 0) load_smem<VEC>(xs, shift);
      if (!ln.active) continue;
      for (int r = ln.lane; r < t.rows.n; r += ln.lanes) {
        float v[VEC];
        load_smem<VEC>(xs + r * C, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = v[i] - shift[i];
          s1[i] += d;
          s2[i] += d * d;
        }
      }
    }
    block_sums<VEC, NT>(ln, sm.red, s1, s2, C);
    if (ln.active && ln.lane == 0) {
      const size_t o = (static_cast<size_t>(g) * pl.P + p) * C + c0;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        part[o + i] = make_float2(shift[i] + s1[i] / n_p,
                                  fmaxf(s2[i] - s1[i] * (s1[i] / n_p), 0.f));
    }
    group_arrive(counters + g);
  };

  // 2-3. wait for the group's P partials; Chan's merge about block 0's
  // mean m0,
  // in index order: A = sum n_q (mean_q - m0), B = sum M2_q + n_q
  // (mean_q - m0)^2 (coef: m0, A, B)
  auto merge = [&](int j) {
    const int g = k + j * pl.ngroups;
    const size_t pg = static_cast<size_t>(g) * pl.P * C;
    group_wait(counters + g, pl.P);
    merge2<NT>(
        pl.P, C, part + pg,
        [&](int q, float2 w, float m0) {
          const float nq = static_cast<float>(slice_of(pl, q).n);
          const float d = w.x - m0;
          return make_float2(nq * d, w.y + nq * d * d);
        },
        sm.tmp, sm.coef, sm.coef + C, sm.coef + 2 * C);
  };

  // mean = m0 + A / R, M2 = B - A^2 / R; 4. normalize the staged slice,
  // refilling each slot as it is done
  auto write = [&](int j) {
    const int g = k + j * pl.ngroups;
    float m[VEC], rs[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float a = sm.coef[C + c0 + i], b = sm.coef[2 * C + c0 + i];
      m[i] = sm.coef[c0 + i] + a / R;
      const float v = fmaxf(b - a * (a / R), 0.f) / R;
      rs[i] = rsqrtf(v + eps);
      if (p == 0 && ln.active && ln.lane == 0) {
        mu[static_cast<size_t>(g) * C + c0 + i] = m[i];
        var[static_cast<size_t>(g) * C + c0 + i] = v;
      }
    }
    for (int s = 0; s < pl.nsub; ++s) {
      const Item t = item_of(pl, k, p, j * pl.nsub + s);
      if (ln.active) {
        const float* xs = staged<1>(sm.ring, pl, t, 0, x) + c0;
        float* yg = y + t.off + c0;
        for (int r = ln.lane; r < t.rows.n; r += ln.lanes) {
          float v[VEC];
          load_smem<VEC>(xs + r * C, v);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            v[i] = (v[i] - m[i]) * rs[i] * ga[i] + be[i];
          store_vec<VEC>(yg + static_cast<size_t>(r) * C, v);
        }
      }
      __syncthreads();   // the slot is read: refill it with the next item
      if (threadIdx.x == 0 && issued < total)
        stage<1>(pl, in, sm.ring, sm.bars, k, p, issued++);
    }
  };

  for (int j = 0; j < nj; ++j) {
    reduce(j);
    merge(j);
    write(j);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <int VEC, int NT>
__global__ void __launch_bounds__(NT, NT <= 512 ? 2 : 1)
    gbn_bwd_persistent_kernel(
        const float* __restrict__ x, const float* __restrict__ dy,
        const float* __restrict__ gamma, const float* __restrict__ mu,
        const float* __restrict__ var, const float* __restrict__ dmu,
        const float* __restrict__ dvar, float eps, float* __restrict__ dx,
        float* __restrict__ dgamma, float* __restrict__ dbeta,
        float2* part, float2* gsums, int* counters, const Plan pl) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<VEC, NT, 2> sm(smem_raw, pl);
  const int k = blockIdx.x / pl.P, p = blockIdx.x % pl.P;
  const Lane<VEC> ln(pl.C);
  const int C = pl.C, c0 = ln.cv * VEC;
  const float R = static_cast<float>(pl.R);
  const int nj = (pl.G - k + pl.ngroups - 1) / pl.ngroups;
  const int total = nj * pl.nsub;
  const float* const in[2] = {x, dy};
  int issued = start_ring<2>(pl, in, sm.ring, sm.bars, k, p, total);
  float ga[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) ga[i] = __ldg(gamma + c0 + i);
  // the saved statistics of ghost g for this thread's channels
  auto stats = [&](int g, float (&m)[VEC], float (&rs)[VEC]) {
    const size_t gc = static_cast<size_t>(g) * C + c0;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      m[i] = __ldg(mu + gc + i);
      rs[i] = rsqrtf(__ldg(var + gc + i) + eps);
    }
  };

  // 1. sum dy and sum dy * xhat over the staged slice, stored; 2. arrive
  auto reduce = [&](int j) {
    const int g = k + j * pl.ngroups;
    float m[VEC], rs[VEC], sdy[VEC], sdyxh[VEC];
    stats(g, m, rs);
#pragma unroll
    for (int i = 0; i < VEC; ++i) sdy[i] = sdyxh[i] = 0.f;
    for (int s = 0; s < pl.nsub; ++s) {
      const Item t = item_of(pl, k, p, j * pl.nsub + s);
      hp::mbar_wait(&sm.bars[t.slot], t.parity);
      if (!ln.active) continue;
      const float* xs = staged<2>(sm.ring, pl, t, 0, x) + c0;
      const float* ds = staged<2>(sm.ring, pl, t, 1, dy) + c0;
      for (int r = ln.lane; r < t.rows.n; r += ln.lanes) {
        float xv[VEC], dv[VEC];
        load_smem<VEC>(xs + r * C, xv);
        load_smem<VEC>(ds + r * C, dv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          sdy[i] += dv[i];
          sdyxh[i] += dv[i] * ((xv[i] - m[i]) * rs[i]);
        }
      }
    }
    block_sums<VEC, NT>(ln, sm.red, sdy, sdyxh, C);
    if (ln.active && ln.lane == 0) {
      const size_t o = (static_cast<size_t>(g) * pl.P + p) * C + c0;
#pragma unroll
      for (int i = 0; i < VEC; ++i) part[o + i] = make_float2(sdy[i], sdyxh[i]);
    }
    group_arrive(counters + g);
  };

  // 2-3. wait for the group's P partials; the ghost's sums over them in
  // index order (coef: sum dy, sum dy xhat)
  auto merge = [&](int j) {
    const int g = k + j * pl.ngroups;
    const size_t pg = static_cast<size_t>(g) * pl.P * C;
    group_wait(counters + g, pl.P);
    merge2<NT>(
        pl.P, C, part + pg, [](int, float2 w, float) { return w; },
        sm.tmp, nullptr, sm.coef, sm.coef + C);
  };

  // the dx coefficients: gvar = dvar - 1/2 gamma rstd^2 sum dy xhat, gmu =
  // dmu - gamma rstd sum dy; dx = dy c1 + (x - mu) c2 + c3 with c1 = gamma
  // rstd, c2 = 2 gvar / R, c3 = gmu / R; 4. dx from the staged slice,
  // refilling each slot as it is done
  auto write = [&](int j) {
    const int g = k + j * pl.ngroups;
    const size_t gc = static_cast<size_t>(g) * C + c0;
    float m[VEC], rs[VEC], c1[VEC], c2[VEC], c3[VEC];
    stats(g, m, rs);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float a = sm.coef[c0 + i], b = sm.coef[C + c0 + i];
      const float gvar =
          __ldg(dvar + gc + i) - 0.5f * ga[i] * rs[i] * rs[i] * b;
      const float gmu = __ldg(dmu + gc + i) - ga[i] * rs[i] * a;
      c1[i] = ga[i] * rs[i];
      c2[i] = 2.0f * gvar / R;
      c3[i] = gmu / R;
      if (p == 0 && ln.active && ln.lane == 0) gsums[gc + i] = make_float2(a, b);
    }
    for (int s = 0; s < pl.nsub; ++s) {
      const Item t = item_of(pl, k, p, j * pl.nsub + s);
      if (ln.active) {
        const float* xs = staged<2>(sm.ring, pl, t, 0, x) + c0;
        const float* ds = staged<2>(sm.ring, pl, t, 1, dy) + c0;
        float* dxg = dx + t.off + c0;
        for (int r = ln.lane; r < t.rows.n; r += ln.lanes) {
          float xv[VEC], dv[VEC];
          load_smem<VEC>(xs + r * C, xv);
          load_smem<VEC>(ds + r * C, dv);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            dv[i] = dv[i] * c1[i] + (xv[i] - m[i]) * c2[i] + c3[i];
          store_vec<VEC>(dxg + static_cast<size_t>(r) * C, dv);
        }
      }
      __syncthreads();   // the slot is read: refill it with the next item
      if (threadIdx.x == 0 && issued < total)
        stage<2>(pl, in, sm.ring, sm.bars, k, p, issued++);
    }
  };

  for (int j = 0; j < nj; ++j) {
    reduce(j);
    merge(j);
    write(j);
  }

  // dgamma, dbeta: the last group to finish (a second counter) sums the
  // per-ghost sums in ghost order
  if (p != 0) return;
  __syncthreads();
  int* last = reinterpret_cast<int*>(sm.tmp);
  if (threadIdx.x == 0)
    *last = hp::atom_add_acq_rel(counters + pl.G, 1) == pl.ngroups - 1;
  __syncthreads();
  if (!*last) return;
  for (int c = threadIdx.x; c < C; c += NT) {
    float a = 0.f, b = 0.f;
    for (int g0 = 0; g0 < pl.G; g0 += kMergeBatch) {
      float2 w[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        if (g0 + u < pl.G)
          w[u] = __ldcg(gsums + static_cast<size_t>(g0 + u) * C + c);
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (g0 + u < pl.G) {
          a += w[u].y;
          b += w[u].x;
        }
      }
    }
    dgamma[c] = a;
    dbeta[c] = b;
  }
}

// ===========================================================================
// the two-pass body
// ===========================================================================

template <int VEC>
struct Chunk {
  Lane<VEC> ln;
  long long r0;   // this block's rows [r0, r1)
  long long r1;
  __device__ __forceinline__ Chunk(int R, int C, int chunk_rows) : ln(C) {
    r0 = static_cast<long long>(blockIdx.x) * chunk_rows;
    r1 = min(static_cast<long long>(R), r0 + chunk_rows);
  }
};

// offset of (ghost blockIdx.y, row 0, channel cv * VEC)
template <int VEC>
__device__ __forceinline__ size_t ghost_base(const Chunk<VEC>& s, int R,
                                             int C) {
  return static_cast<size_t>(blockIdx.y) * R * C + s.ln.cv * VEC;
}

// forward statistics: per-chunk (mean, M2) partials
template <int VEC>
__global__ void gbn_fwd_partial_kernel(const float* __restrict__ x,
                                       float* __restrict__ pmean,
                                       float* __restrict__ pm2, int R, int C,
                                       int chunk_rows) {
  extern __shared__ float smem[];
  const Chunk<VEC> s(R, C, chunk_rows);
  const float* xg = x + ghost_base<VEC>(s, R, C);
  float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) mean[k] = m2[k] = 0.f;

  if (s.ln.active && s.r0 + s.ln.lane < s.r1) {
    // sums of x - shift, shift = the thread's first value: keeps the
    // per-thread sum of squares from cancelling when |mean| >> std
    float shift[VEC], sum[VEC], sq[VEC];
    load_vec<VEC>(xg + (s.r0 + s.ln.lane) * C, shift);
#pragma unroll
    for (int k = 0; k < VEC; ++k) sum[k] = sq[k] = 0.f;
    for (long long r = s.r0 + s.ln.lane; r < s.r1; r += s.ln.lanes) {
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
  if (s.ln.lane != 0) return;
  const int CV = C / VEC;
  for (int l = 1; l < s.ln.lanes; ++l) {  // Chan merge, lane order
    const int t = l * CV + s.ln.cv;
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
      s.ln.cv * VEC;
  store_vec<VEC>(pmean + o, mean);
  store_vec<VEC>(pm2 + o, m2);
}

// merge of the per-chunk (mean, M2) partials in chunk order (Chan), one
// thread per (ghost, channel) -> (mu, biased var)
__global__ void gbn_fwd_merge_kernel(const float* __restrict__ pmean,
                                     const float* __restrict__ pm2,
                                     float* __restrict__ mu,
                                     float* __restrict__ var, int G, int R,
                                     int C, int chunk_rows, int nchunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= G * C) return;
  const int g = i / C, c = i % C;
  const float* a = pmean + static_cast<size_t>(g) * nchunks * C + c;
  const float* b = pm2 + static_cast<size_t>(g) * nchunks * C + c;
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
  mu[i] = mean;
  var[i] = m2 / static_cast<float>(R);
}

// y = (x - mu) * rsqrt(var + eps) * gamma + beta
template <int VEC>
__global__ void gbn_normalize_kernel(const float* __restrict__ x,
                                     const float* __restrict__ mu,
                                     const float* __restrict__ var,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     float eps, float* __restrict__ y, int R,
                                     int C, int chunk_rows) {
  const Chunk<VEC> s(R, C, chunk_rows);
  if (!s.ln.active) return;
  const int c0 = s.ln.cv * VEC;
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
  for (long long r = s.r0 + s.ln.lane; r < s.r1; r += s.ln.lanes) {
    float v[VEC];
    load_vec<VEC>(x + base + r * C, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = (v[k] - m[k]) * rs[k] * ga[k] + be[k];
    store_vec<VEC>(y + base + r * C, v);
  }
}

// backward statistics: per-chunk sum dy and sum dy * xhat, rstd from var
template <int VEC>
__global__ void gbn_bwd_partial_kernel(const float* __restrict__ x,
                                       const float* __restrict__ dy,
                                       const float* __restrict__ mu,
                                       const float* __restrict__ var,
                                       float eps, float* __restrict__ psdy,
                                       float* __restrict__ psdyxh, int R,
                                       int C, int chunk_rows) {
  extern __shared__ float smem[];
  const Chunk<VEC> s(R, C, chunk_rows);
  float sdy[VEC], sdyxh[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) sdy[k] = sdyxh[k] = 0.f;
  if (s.ln.active) {
    const size_t gc = static_cast<size_t>(blockIdx.y) * C + s.ln.cv * VEC;
    float m[VEC], rs[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      m[k] = mu[gc + k];
      rs[k] = rsqrtf(var[gc + k] + eps);
    }
    const size_t base = ghost_base<VEC>(s, R, C);
    for (long long r = s.r0 + s.ln.lane; r < s.r1; r += s.ln.lanes) {
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
  if (s.ln.lane != 0) return;
  const int CV = C / VEC;
  for (int l = 1; l < s.ln.lanes; ++l) {
    const int t = l * CV + s.ln.cv;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sdy[k] += sa[t * VEC + k];
      sdyxh[k] += sb[t * VEC + k];
    }
  }
  const size_t o =
      (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * C +
      s.ln.cv * VEC;
  store_vec<VEC>(psdy + o, sdy);
  store_vec<VEC>(psdyxh + o, sdyxh);
}

// the chunk partials summed in chunk order, then the dx coefficients (the
// persistent body's step 3), one thread per (ghost, channel)
__global__ void gbn_bwd_coef_kernel(
    const float* __restrict__ psdy, const float* __restrict__ psdyxh,
    const float* __restrict__ gamma, const float* __restrict__ var,
    const float* __restrict__ dmu, const float* __restrict__ dvar, float eps,
    float* __restrict__ sdy, float* __restrict__ sdyxh,
    float* __restrict__ c1, float* __restrict__ c2, float* __restrict__ c3,
    int G, int R, int C, int nchunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= G * C) return;
  const int g = i / C, c = i % C;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < nchunks; ++k) {
    const size_t o = (static_cast<size_t>(g) * nchunks + k) * C + c;
    a += psdy[o];
    b += psdyxh[o];
  }
  const float ga = gamma[c], rs = rsqrtf(var[i] + eps);
  const float gvar = dvar[i] - 0.5f * ga * rs * rs * b;
  const float gmu = dmu[i] - ga * rs * a;
  sdy[i] = a;
  sdyxh[i] = b;
  c1[i] = ga * rs;
  c2[i] = 2.0f * gvar / static_cast<float>(R);
  c3[i] = gmu / static_cast<float>(R);
}

// dx = dy * c1 + (x - mu) * c2 + c3, per-(ghost, channel) coefficients
template <int VEC>
__global__ void gbn_dx_kernel(const float* __restrict__ x,
                              const float* __restrict__ dy,
                              const float* __restrict__ mu,
                              const float* __restrict__ c1,
                              const float* __restrict__ c2,
                              const float* __restrict__ c3,
                              float* __restrict__ dx, int R, int C,
                              int chunk_rows) {
  const Chunk<VEC> s(R, C, chunk_rows);
  if (!s.ln.active) return;
  const size_t gc = static_cast<size_t>(blockIdx.y) * C + s.ln.cv * VEC;
  float m[VEC], a[VEC], b[VEC], c[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    m[k] = mu[gc + k];
    a[k] = c1[gc + k];
    b[k] = c2[gc + k];
    c[k] = c3[gc + k];
  }
  const size_t base = ghost_base<VEC>(s, R, C);
  for (long long r = s.r0 + s.ln.lane; r < s.r1; r += s.ln.lanes) {
    float xv[VEC], dv[VEC];
    load_vec<VEC>(x + base + r * C, xv);
    load_vec<VEC>(dy + base + r * C, dv);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      dv[k] = dv[k] * a[k] + (xv[k] - m[k]) * b[k] + c[k];
    store_vec<VEC>(dx + base + r * C, dv);
  }
}

// dgamma, dbeta: the per-ghost sums over G in ghost order, one thread a
// channel
__global__ void gbn_sum_ghosts_kernel(const float* __restrict__ sdy,
                                      const float* __restrict__ sdyxh,
                                      float* __restrict__ dgamma,
                                      float* __restrict__ dbeta, int G,
                                      int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int g = 0; g < G; ++g) {
    a += sdyxh[static_cast<size_t>(g) * C + c];
    b += sdy[static_cast<size_t>(g) * C + c];
  }
  dgamma[c] = a;
  dbeta[c] = b;
}

constexpr int kSmallThreads = 256;

inline dim3 chunk_grid(int G, int nchunks) {
  return dim3(static_cast<unsigned>(nchunks), static_cast<unsigned>(G));
}

inline dim3 small_grid(int n) {
  return dim3(static_cast<unsigned>((n + kSmallThreads - 1) / kSmallThreads));
}

// ===========================================================================
// host side
// ===========================================================================

// Calls f with the persistent kernel of (direction, VEC, threads).
template <bool BWD, int VEC, int NT>
inline auto persistent_kernel() {
  if constexpr (BWD) {
    return &gbn_bwd_persistent_kernel<VEC, NT>;
  } else {
    return &gbn_fwd_persistent_kernel<VEC, NT>;
  }
}

template <bool BWD, int VEC, class F>
int with_threads(int threads, F&& f) {
  switch (threads) {
    case 256: return f(persistent_kernel<BWD, VEC, 256>(), 256);
    case 512: return f(persistent_kernel<BWD, VEC, 512>(), 512);
    case 1024: return f(persistent_kernel<BWD, VEC, 1024>(), 1024);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool BWD, class F>
int with_kernel(int vec, int threads, F&& f) {
  if (vec == 4) return with_threads<BWD, 4>(threads, f);
  if (vec == 1) return with_threads<BWD, 1>(threads, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int NT, int NIN>
size_t smem_for(int vec, const Plan& pl) {
  return vec == 4 ? smem_bytes<4, NT, NIN>(pl) : smem_bytes<1, NT, NIN>(pl);
}

inline size_t plan_smem(int vec, int threads, int nin, const Plan& pl) {
  const int nt = threads;
  if (nin == 1) {
    return nt == 256 ? smem_for<256, 1>(vec, pl)
                     : nt == 512 ? smem_for<512, 1>(vec, pl)
                                 : smem_for<1024, 1>(vec, pl);
  }
  return nt == 256 ? smem_for<256, 2>(vec, pl)
                   : nt == 512 ? smem_for<512, 2>(vec, pl)
                               : smem_for<1024, 2>(vec, pl);
}

inline Plan make_plan(int G, int R, int C, int P, int ngroups,
                      int slice_rows, int sub_rows, int nsub, int nslot,
                      int slot_floats) {
  return {G, R, C, P, ngroups, slice_rows, sub_rows, nsub, nslot,
          slot_floats};
}

// The plan's checks: what the kernels assume of it (kernels/gbn.py:plan
// keeps them). Returns 0 or cudaErrorInvalidValue.
inline int check_plan(const Plan& pl, int vec, int threads, int nin,
                      int smem) {
  const bool ok =
      pl.G >= 1 && pl.R >= 1 && pl.C >= 1 && pl.C % vec == 0 &&
      pl.C / vec <= threads && pl.P >= 1 && pl.ngroups >= 1 &&
      pl.ngroups <= pl.G && pl.slice_rows >= 1 &&
      static_cast<long long>(pl.P - 1) * pl.slice_rows < pl.R &&
      static_cast<long long>(pl.P) * pl.slice_rows >= pl.R &&
      pl.sub_rows >= 1 && pl.nsub >= 1 &&
      static_cast<long long>(pl.nsub) * pl.sub_rows >= pl.slice_rows &&
      pl.nslot >= pl.nsub && pl.slot_floats % 4 == 0 &&
      static_cast<long long>(pl.sub_rows) * pl.C + 3 <= pl.slot_floats &&
      plan_smem(vec, threads, nin, pl) == static_cast<size_t>(smem);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's shared-memory limit is set at every launch: it is one
// attribute of the kernel, and calls of other shapes set it too.
template <class Kernel, class... Args>
int launch_cooperative(Kernel kernel, int grid, int threads, int smem,
                       cudaStream_t stream, Args... args) {
  void* argv[] = {static_cast<void*>(&args)...};
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned>(grid)),
      dim3(static_cast<unsigned>(threads)), argv, static_cast<size_t>(smem),
      stream));
}

}  // namespace

extern "C" {

// Sets the persistent kernel's dynamic shared memory to `smem` bytes and
// stores the blocks of it an SM holds (the occupancy calculator's count)
// in *per_sm.
int gbn_fit(int backward, int vec, int threads, int smem, int* per_sm) {
  auto fit = [&](auto kernel, int nt) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, nt,
                                                          smem);
    return static_cast<int>(err);
  };
  return backward ? with_kernel<true>(vec, threads, fit)
                  : with_kernel<false>(vec, threads, fit);
}

// Ints of a persistent call's counters (one a ghost, and the backward's
// count of finished groups), padded to 16 bytes: the head of its scratch.
inline size_t counter_ints(int G) {
  return (static_cast<size_t>(G) + 4) / 4 * 4;
}

// The persistent forward: x (G, R, C) -> y, mu, var (G, C). scratch holds
// the counters (counter_ints(G) ints, zeroed here) then the partials,
// (G, P, C) float2.
int gbn_fwd_persistent(const float* x, const float* gamma, const float* beta,
                       float eps, float* y, float* mu, float* var,
                       float* scratch, long long scratch_floats, int G, int R,
                       int C, int P, int ngroups, int slice_rows,
                       int sub_rows, int nsub, int nslot, int slot_floats,
                       int vec, int threads, int smem, cudaStream_t stream) {
  const Plan pl = make_plan(G, R, C, P, ngroups, slice_rows, sub_rows, nsub,
                            nslot, slot_floats);
  const size_t nctr = counter_ints(G);
  const size_t pairs = static_cast<size_t>(G) * P * C;
  int err = check_plan(pl, vec, threads, 1, smem);
  if (err == 0 && static_cast<size_t>(scratch_floats) < nctr + 2 * pairs)
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  int* counters = reinterpret_cast<int*>(scratch);
  auto* part = reinterpret_cast<float2*>(scratch + nctr);
  cudaError_t e = cudaMemsetAsync(counters, 0, nctr * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return with_kernel<false>(vec, threads, [&](auto kernel, int nt) {
    return launch_cooperative(kernel, P * ngroups, nt, smem, stream, x, gamma,
                              beta, eps, y, mu, var, part, counters, pl);
  });
}

// The persistent backward: x, dy (G, R, C); gamma (C); mu, var, dmu, dvar
// (G, C) -> dx (G, R, C), dgamma, dbeta (C). scratch holds the counters
// (counter_ints(G) ints, zeroed here), the partials, (G, P, C) float2,
// then the per-ghost sums, (G, C) float2.
int gbn_bwd_persistent(const float* x, const float* dy, const float* gamma,
                       const float* mu, const float* var, const float* dmu,
                       const float* dvar, float eps, float* dx,
                       float* dgamma, float* dbeta, float* scratch,
                       long long scratch_floats, int G, int R, int C, int P,
                       int ngroups, int slice_rows, int sub_rows, int nsub,
                       int nslot, int slot_floats, int vec, int threads,
                       int smem, cudaStream_t stream) {
  const Plan pl = make_plan(G, R, C, P, ngroups, slice_rows, sub_rows, nsub,
                            nslot, slot_floats);
  const size_t nctr = counter_ints(G);
  const size_t pairs = static_cast<size_t>(G) * P * C;
  const size_t gcs = static_cast<size_t>(G) * C;
  int err = check_plan(pl, vec, threads, 2, smem);
  if (err == 0 &&
      static_cast<size_t>(scratch_floats) < nctr + 2 * (pairs + gcs))
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  int* counters = reinterpret_cast<int*>(scratch);
  auto* part = reinterpret_cast<float2*>(scratch + nctr);
  float2* gsums = part + pairs;
  cudaError_t e = cudaMemsetAsync(counters, 0, nctr * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return with_kernel<true>(vec, threads, [&](auto kernel, int nt) {
    return launch_cooperative(kernel, P * ngroups, nt, smem, stream, x, dy,
                              gamma, mu, var, dmu, dvar, eps, dx, dgamma,
                              dbeta, part, gsums, counters, pl);
  });
}

// The two-pass forward. scratch holds pmean, pm2 (G, nchunks, C).
int gbn_fwd_two_pass(const float* x, const float* gamma, const float* beta,
                     float eps, float* y, float* mu, float* var,
                     float* scratch, long long scratch_floats, int G, int R,
                     int C, int chunk_rows, int nchunks, int vec,
                     int threads, cudaStream_t stream) {
  const size_t part = static_cast<size_t>(G) * nchunks * C;
  if (static_cast<size_t>(scratch_floats) < 2 * part || (vec != 4 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pmean = scratch;
  float* pm2 = scratch + part;
  const size_t smem = static_cast<size_t>(threads) * (1 + 2 * vec) * sizeof(float);
  if (vec == 4) {
    gbn_fwd_partial_kernel<4><<<chunk_grid(G, nchunks), threads, smem, stream>>>(
        x, pmean, pm2, R, C, chunk_rows);
  } else {
    gbn_fwd_partial_kernel<1><<<chunk_grid(G, nchunks), threads, smem, stream>>>(
        x, pmean, pm2, R, C, chunk_rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gbn_fwd_merge_kernel<<<small_grid(G * C), kSmallThreads, 0, stream>>>(
      pmean, pm2, mu, var, G, R, C, chunk_rows, nchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec == 4) {
    gbn_normalize_kernel<4><<<chunk_grid(G, nchunks), threads, 0, stream>>>(
        x, mu, var, gamma, beta, eps, y, R, C, chunk_rows);
  } else {
    gbn_normalize_kernel<1><<<chunk_grid(G, nchunks), threads, 0, stream>>>(
        x, mu, var, gamma, beta, eps, y, R, C, chunk_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The two-pass backward. scratch holds psdy, psdyxh (G, nchunks, C), then
// sdy, sdyxh, c1, c2, c3 (G, C).
int gbn_bwd_two_pass(const float* x, const float* dy, const float* gamma,
                     const float* mu, const float* var, const float* dmu,
                     const float* dvar, float eps, float* dx, float* dgamma,
                     float* dbeta, float* scratch, long long scratch_floats,
                     int G, int R, int C, int chunk_rows, int nchunks,
                     int vec, int threads, cudaStream_t stream) {
  const size_t part = static_cast<size_t>(G) * nchunks * C;
  const size_t gcs = static_cast<size_t>(G) * C;
  if (static_cast<size_t>(scratch_floats) < 2 * part + 5 * gcs ||
      (vec != 4 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  float* psdy = scratch;
  float* psdyxh = psdy + part;
  float* sdy = psdyxh + part;
  float* sdyxh = sdy + gcs;
  float* c1 = sdyxh + gcs;
  float* c2 = c1 + gcs;
  float* c3 = c2 + gcs;
  const size_t smem = static_cast<size_t>(threads) * 2 * vec * sizeof(float);
  if (vec == 4) {
    gbn_bwd_partial_kernel<4><<<chunk_grid(G, nchunks), threads, smem, stream>>>(
        x, dy, mu, var, eps, psdy, psdyxh, R, C, chunk_rows);
  } else {
    gbn_bwd_partial_kernel<1><<<chunk_grid(G, nchunks), threads, smem, stream>>>(
        x, dy, mu, var, eps, psdy, psdyxh, R, C, chunk_rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gbn_bwd_coef_kernel<<<small_grid(G * C), kSmallThreads, 0, stream>>>(
      psdy, psdyxh, gamma, var, dmu, dvar, eps, sdy, sdyxh, c1, c2, c3, G, R,
      C, nchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec == 4) {
    gbn_dx_kernel<4><<<chunk_grid(G, nchunks), threads, 0, stream>>>(
        x, dy, mu, c1, c2, c3, dx, R, C, chunk_rows);
  } else {
    gbn_dx_kernel<1><<<chunk_grid(G, nchunks), threads, 0, stream>>>(
        x, dy, mu, c1, c2, c3, dx, R, C, chunk_rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gbn_sum_ghosts_kernel<<<small_grid(C), kSmallThreads, 0, stream>>>(
      sdy, sdyxh, dgamma, dbeta, G, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
