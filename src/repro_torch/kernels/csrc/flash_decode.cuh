// The body shared by the flash decode kernels (flash_decode.cu: a
// contiguous head-major cache; flash_decode_paged.cu: a page pool behind a
// block table, bf16/f32 or int8 with per-slot scales), for Hopper.
//
// Split-KV over a thread block cluster. The slots of one (kv head, row)
// split into chunks of Chunk::SLOTS consecutive logical slot indices: 64,
// fewer where a chunk's keys would pass kChunkBytes (8 KB: 32 slots of a
// bf16 row of 128, 16 of an f32 one), always a power of two (32 of a bf16
// row of 120, not 34), so that a left pad that is a multiple of 64 slots
// moves the chunk boundaries with the row's first slot. A cluster of CL = 8 blocks of 128
// threads handles one (kv head, row): the grid is (CL, KV, B). Cluster
// rank r takes the chunks r, r + CL, r + 2 CL, ... that meet the row's
// visible slots [s_lo, s_hi), in ascending order; a chunk wholly outside
// that range is never touched.
//
// Bytes in flight. A block copies a chunk's keys and values into shared
// memory as 16-byte cp.async copies (8-byte ones for an int8 row of 120,
// whose rows are only 8-byte aligned), all of the chunk's copies issued at
// once, two chunks in flight (STAGES): the next chunk arrives while the
// current one is computed. A slot that is not visible is zero-filled, not
// read. The paged source reads the block-table entries of a chunk once,
// before its copies (a chunk ahead, so that the load overlaps the current
// chunk's arithmetic); an int8 pool's per-slot f32 scales arrive as
// 16-byte copies of four slots of one page (4-byte copies a slot where the
// page size is not a multiple of 4). The query rows (f32, scaled by 1/sqrt(HD), rotated
// by RoPE when asked) load while the first chunks are in flight.
//
// Arithmetic, in f32 from shared memory, per chunk: the G x SLOTS logits
// (a thread a (query row, slot) dot product, four partial sums over the
// columns); each query row's chunk max, probabilities and sum (a warp a
// row, fixed shuffle order); P.V, where a thread holds 8 output columns of
// one query row for one of NG slot groups (slots g, g + NG, ...), carried
// across the block's chunks as an online softmax. At the end the groups'
// accumulators are summed in group order.
//
// The merge is fixed-order and needs no atomics: each block stores its
// (m, l, acc) into its slot of rank 0's inbox (distributed shared memory);
// after one cluster barrier rank 0 merges the slots in rank order and
// writes the output. A rank that saw no slot has m = -inf, l = 0, acc = 0:
// its terms are fmaf(0, 0, x) = x, so it leaves the result bit-identical.
// A row that sees no slot is the mean of V over the S slots (the softmax
// of equal masked logits, as the reference's oracle gives it), which rank 0
// reads through the slot source in logical slot order, so the paged kernel
// still equals the contiguous one bit for bit there.
//
// Chunks, the chunk-to-rank map and the merge order depend only on logical
// slot indices and (HD, dtype), and the slot source only changes where a
// slot's bytes come from. So the paged kernel equals the contiguous one bit
// for bit on the same cache contents, a row equals its solo run at any B,
// and a cache padded with slots past pos gives the same bits.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace port {
namespace decode {

// CL, STAGES, kChunkBytes and kScaleCopy are what
// scripts/decode_chunk_sweep.py measured best among the values it builds
// (PERF.md).
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CL = 8;          // blocks (ranks) of one (kv head, row)
constexpr int STAGES = 2;      // chunks in flight a block
constexpr int MAX_GHD = 1024;  // G * HD: query rows of a group times width
constexpr int kChunkBytes = 8192;  // most bytes of a chunk's keys
constexpr int kScaleCopy = 16;     // bytes of an int8 pool's scale copy

__host__ __device__ constexpr int floor_pow2(int n) {
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}

// A chunk of slots whose rows are HD elements of ESIZE bytes. A row is
// copied in 16-byte units, or in 8-byte ones where its bytes are not a
// multiple of 16 (an int8 row of 120: row r starts at byte 120 r, only
// 8-byte aligned; the pool keeps the reference's layout, unpadded).
template <int HD, int ESIZE>
struct Chunk {
  static constexpr int ROW = HD * ESIZE;  // bytes of one slot's key (value)
  static_assert(ROW % 8 == 0, "rows are whole 8-byte units");
  static constexpr int SLOTS = floor_pow2(
      ROW * 64 <= kChunkBytes ? 64 : kChunkBytes / ROW);
  static constexpr int LD = ROW + 16;  // shared row stride: 16 bytes of pad,
                                       // so 8 rows at one column miss banks
  static constexpr int UNIT = ROW % 16 == 0 ? 16 : 8;  // bytes a copy
  static constexpr int UNITS = ROW / UNIT;              // copies a row
};

constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// P.V: a thread holds CPT consecutive output columns of one query row for
// one of NG slot groups (slots g, g + NG, ...); TG threads cover a slot.
// Where TG does not divide the block (HD = 112 or 120: TG = 14 G or 15 G),
// the THREADS - NG * TG threads past the last whole group take no part.
constexpr int CPT = 8;

template <int HD, int G>
struct PV {
  static constexpr int TG = G * HD / CPT;  // 4 .. 128
  static constexpr int NG = THREADS / TG;
  static_assert(HD % CPT == 0 && TG <= THREADS, "a slot group fits");
};

// Byte offsets into the block's dynamic shared memory.
template <int HD, int ESIZE, int G, bool SCALED, bool PAGED>
struct Smem {
  using C = Chunk<HD, ESIZE>;
  static constexpr int N = C::SLOTS;
  static constexpr size_t Q = 0;                      // G * HD f32
  static constexpr size_t K = align16(Q + 4 * G * HD);  // STAGES chunks
  static constexpr size_t V = K + size_t(STAGES) * N * C::LD;
  static constexpr size_t KS = V + size_t(STAGES) * N * C::LD;  // f32 scales
  static constexpr size_t VS = KS + (SCALED ? 4 * STAGES * N : 0);
  static constexpr size_t P = VS + (SCALED ? 4 * STAGES * N : 0);  // G x N
  static constexpr size_t ROWS = P + 4 * G * N;  // m, l, alpha: G f32 each
  // rank 0's inbox: each rank's (m[G], l[G], acc[G * HD]) in f32
  static constexpr int BOX = 2 * G + G * HD;
  static constexpr size_t INBOX = align16(ROWS + 4 * 3 * G);
  static constexpr size_t TAB = INBOX + 4 * CL * BOX;  // STAGES x N int
  static constexpr size_t BYTES = align16(TAB + (PAGED ? 4 * STAGES * N : 0));
  // the slot groups' partial acc (NG x G * HD) reuses the key and value
  // stages once every chunk is done
  static_assert(2 * size_t(STAGES) * N * C::LD >= 4 * size_t(THREADS) * CPT,
                "the groups' partials fit in the stages");
};

__device__ __forceinline__ float load_f(float x) { return x; }
__device__ __forceinline__ float load_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float load_f(int8_t x) {
  return static_cast<float>(x);
}

// 16 bytes of shared memory as 16 / sizeof(T) f32 values.
template <typename T>
__device__ __forceinline__ void unpack16(const unsigned char* p,
                                         float (&v)[16 / sizeof(T)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i)
    v[i] = load_f(e[i]);
}

// UNIT (16 or 8) bytes of shared memory, aligned to UNIT, as f32 values.
template <typename T, int UNIT>
__device__ __forceinline__ void unpack(const unsigned char* p,
                                       float (&v)[UNIT / sizeof(T)]) {
  if constexpr (UNIT == 16) {
    unpack16<T>(p, v);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < UNIT / static_cast<int>(sizeof(T)); ++i)
      v[i] = load_f(e[i]);
  }
}

// UNIT (16 or 8) bytes global -> shared, asynchronously.
template <int UNIT>
__device__ __forceinline__ void cp_async_unit(void* dst, const void* src,
                                              bool valid) {
  if constexpr (UNIT == 16)
    cp_async16(dst, src, valid);
  else
    cp_async8(dst, src, valid);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 consecutive elements of T in shared memory (8-byte aligned) as f32.
template <typename T>
__device__ __forceinline__ void load8(const unsigned char* p, float (&v)[8]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else if constexpr (sizeof(T) == 2) {
    unpack16<T>(p, v);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = load_f(e[i]);
  }
}

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// Slot s of a head-major (B, KV, S, HD) cache: element (row + s) * HD.
template <typename T>
struct ContiguousSlots {
  static constexpr bool kScaled = false;
  static constexpr bool kPaged = false;
  const T* __restrict__ k;
  const T* __restrict__ v;
  size_t row;  // (b * KV + kvh) * S

  __device__ __forceinline__ int fetch_table(int, int) const { return 0; }
  __device__ __forceinline__ void stash(int, int*, int, int) const {}

  // Columns [c0, c0 + 8) of slot s's value as f32.
  template <int HD>
  __device__ __forceinline__ void value8(int s, int c0, float (&x)[8]) const {
    const T* p = v + (row + s) * HD + c0;
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = load_f(p[e]);
  }

  // Copies slots [s0, s0 + N) into the stage as UNIT-byte copies: slot
  // i's key row at kd + i * LD. A slot that `vis` rejects is zero-filled,
  // not read (its copy names row 0, any mapped address).
  template <int N, int UNIT, int UNITS, int LD, typename Vis>
  __device__ __forceinline__ void issue(unsigned char* kd, unsigned char* vd,
                                        float*, float*, const int*, int s0,
                                        int, Vis vis) const {
    constexpr int EPU = UNIT / sizeof(T);
    for (int idx = threadIdx.x; idx < N * UNITS; idx += THREADS) {
      const int i = idx / UNITS, u = idx % UNITS;
      const bool ok = vis(s0 + i);
      const size_t at = (row + (ok ? s0 + i : 0)) * (UNITS * EPU) + u * EPU;
      cp_async_unit<UNIT>(kd + i * LD + u * UNIT, k + at, ok);
      cp_async_unit<UNIT>(vd + i * LD + u * UNIT, v + at, ok);
    }
  }
};

// Logical slot s of row b lives in page pt[b, s / ps] at slot s % ps of a
// (pages, KV, ps, HD) pool. With T = int8_t the pool holds codes and
// ks/vs (pages, KV, ps) f32 the per-slot scales: k = code * scale.
template <typename T>
struct PagedSlots {
  static constexpr bool kScaled = sizeof(T) == 1;
  static constexpr bool kPaged = true;
  const T* __restrict__ k;
  const T* __restrict__ v;
  const float* __restrict__ ks;
  const float* __restrict__ vs;
  const int* __restrict__ pt_row;  // pt + b * NB
  int KV, kvh, ps;
  // the scales arrive 4 slots a copy: ps % 4 == 0 and ks, vs 16-byte
  // aligned, so 4 slots from a multiple of 4 are 16 bytes of one page
  bool wide_scales;

  // The block-table entries of the pages that hold visible slots
  // [first, last] of a chunk: thread t loads entry first / ps + t.
  __device__ __forceinline__ int fetch_table(int first, int last) const {
    const int t = threadIdx.x, p0 = first / ps;
    return t <= last / ps - p0 ? pt_row[p0 + t] : 0;
  }
  __device__ __forceinline__ void stash(int entry, int* tab, int first,
                                        int last) const {
    if (static_cast<int>(threadIdx.x) <= last / ps - first / ps)
      tab[threadIdx.x] = entry;
  }

  // The pool row of slot s, whose page is tab[s / ps - p0]; row 0 (any
  // mapped address: the copy reads nothing) for a slot that is not visible.
  __device__ __forceinline__ size_t pool_row(const int* tab, int s, int p0,
                                             bool ok) const {
    return ok ? (static_cast<size_t>(tab[s / ps - p0]) * KV + kvh) * ps +
                    s % ps
              : 0;
  }

  // Columns [c0, c0 + 8) of logical slot s's value as f32 (dequantized).
  template <int HD>
  __device__ __forceinline__ void value8(int s, int c0, float (&x)[8]) const {
    const size_t r =
        (static_cast<size_t>(pt_row[s / ps]) * KV + kvh) * ps + s % ps;
    const T* p = v + r * HD + c0;
    const float sc = kScaled ? vs[r] : 1.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = load_f(p[e]) * sc;
  }

  // As ContiguousSlots::issue, each slot's rows from its page. An int8
  // pool's scales arrive 4 slots of one page a 16-byte copy (wide_scales;
  // a copy with one visible slot reads all four, and the body ignores the
  // scales of slots it does not see), else a 4-byte copy a slot.
  template <int N, int UNIT, int UNITS, int LD, typename Vis>
  __device__ __forceinline__ void issue(unsigned char* kd, unsigned char* vd,
                                        float* ksd, float* vsd,
                                        const int* tab, int s0, int first,
                                        Vis vis) const {
    constexpr int EPU = UNIT / sizeof(T);
    const int p0 = first / ps;
    for (int idx = threadIdx.x; idx < N * UNITS; idx += THREADS) {
      const int i = idx / UNITS, u = idx % UNITS;
      const bool ok = vis(s0 + i);
      const size_t at = pool_row(tab, s0 + i, p0, ok) * (UNITS * EPU) +
                        u * EPU;
      cp_async_unit<UNIT>(kd + i * LD + u * UNIT, k + at, ok);
      cp_async_unit<UNIT>(vd + i * LD + u * UNIT, v + at, ok);
    }
    if constexpr (kScaled) {
      if (wide_scales) {
        for (int idx = threadIdx.x; idx < N / 2; idx += THREADS) {
          const int i = idx % (N / 4) * 4;
          const bool ok = vis(s0 + i) || vis(s0 + i + 1) ||
                          vis(s0 + i + 2) || vis(s0 + i + 3);
          const size_t r = pool_row(tab, s0 + i, p0, ok);
          if (idx < N / 4)
            cp_async16(ksd + i, ks + r, ok);
          else
            cp_async16(vsd + i, vs + r, ok);
        }
      } else {
        for (int idx = threadIdx.x; idx < 2 * N; idx += THREADS) {
          const int i = idx % N;
          const bool ok = vis(s0 + i);
          const size_t r = pool_row(tab, s0 + i, p0, ok);
          if (idx < N)
            cp_async4(ksd + i, ks + r, ok);
          else
            cp_async4(vsd + i, vs + r, ok);
        }
      }
    }
  }
};

// One block of the cluster of (kv head kvh, row b). q, o: (B, H, HD) of Q.
// Slots [0, S) of row b; slot s holds global position s, or
// pos - ((pos - s) mod S) for a ring. A slot is visible iff
// 0 <= gp <= pos, gp > pos - window (window > 0) and gp >= off.
template <typename Q, typename T, int HD, int G, typename Slots>
__device__ __forceinline__ void decode_cluster(
    const Q* __restrict__ q, Q* __restrict__ o, const Slots& slots, int b,
    int kvh, int pos, int off, int H, int S, int window, int ring, int rope,
    float log_theta, float scale) {
  using C = Chunk<HD, sizeof(T)>;
  using L = Smem<HD, sizeof(T), G, Slots::kScaled, Slots::kPaged>;
  constexpr int N = C::SLOTS;
  constexpr int LD = C::LD;
  constexpr int UNIT = C::UNIT;
  constexpr int EPU = UNIT / sizeof(T);  // elements of a copy unit
  constexpr int GHD = G * HD;
  constexpr int NG = PV<HD, G>::NG;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::Q);
  unsigned char* kb = smem + L::K;
  unsigned char* vb = smem + L::V;
  float* ksc = reinterpret_cast<float*>(smem + L::KS);
  float* vsc = reinterpret_cast<float*>(smem + L::VS);
  float* lg = reinterpret_cast<float*>(smem + L::P);
  float* row_m = reinterpret_cast<float*>(smem + L::ROWS);
  float* row_l = row_m + G;
  float* row_a = row_l + G;
  float* inbox = reinterpret_cast<float*>(smem + L::INBOX);
  int* tab = reinterpret_cast<int*>(smem + L::TAB);

  // every block of the cluster has started once this phase completes (the
  // wait comes before the first store into rank 0's shared memory)
  cluster_arrive_relaxed();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t rank = cluster_rank();
  const size_t q_base = (static_cast<size_t>(b) * H + kvh * G) * HD;
  if (tid < G) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  // slots worth visiting; a ring visits all and masks per slot
  int s_lo = 0, s_hi = S;
  if (!ring) {
    s_hi = min(S, pos + 1);
    s_lo = max(0, off);
    if (window > 0) s_lo = max(s_lo, pos - window + 1);
  }
  const auto visible = [&](int s) {
    if (s < s_lo || s >= s_hi) return false;
    if (!ring) return true;
    const int gp = pos - floor_mod(pos - s, S);
    bool ok = gp >= 0 && gp <= pos && gp >= off;
    if (window > 0) ok = ok && gp > pos - window;
    return ok;
  };
  // this rank's chunks: c_first, c_first + CL, ... below c_hi
  int n_mine = 0, c_first = 0;
  if (s_hi > s_lo) {
    const int c_lo = s_lo / N, c_hi = (s_hi - 1) / N + 1;
    c_first = c_lo + floor_mod(static_cast<int>(rank) - c_lo, CL);
    if (c_first < c_hi) n_mine = (c_hi - 1 - c_first) / CL + 1;
  }
  // visible slots [first, last] of the block's chunk j
  const auto first_of = [&](int j) {
    return max((c_first + j * CL) * N, s_lo);
  };
  const auto last_of = [&](int j) {
    return min((c_first + j * CL + 1) * N, s_hi) - 1;
  };
  const auto issue = [&](int j) {  // chunk j into stage j % STAGES
    if (j < n_mine) {
      const int st = j % STAGES;
      slots.template issue<N, UNIT, C::UNITS, LD>(
          kb + st * N * LD, vb + st * N * LD, ksc + st * N, vsc + st * N,
          tab + st * N, (c_first + j * CL) * N, first_of(j), visible);
    }
    cp_async_commit();
  };

  if constexpr (Slots::kPaged) {
#pragma unroll
    for (int j = 0; j < STAGES; ++j)
      if (j < n_mine)
        slots.stash(slots.fetch_table(first_of(j), last_of(j)), tab + j * N,
                    first_of(j), last_of(j));
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < STAGES; ++j) issue(j);

  // the query rows, while the first chunks are in flight
  for (int i = tid; i < GHD; i += THREADS) qs[i] = load_f(q[q_base + i]);
  __syncthreads();
  if (rope) {
    constexpr int HALF = HD / 2;
    const float qpos = static_cast<float>(pos - off);
    for (int i = tid; i < G * HALF; i += THREADS) {
      const int r = i / HALF, j = i % HALF;
      float x1 = qs[r * HD + j], x2 = qs[r * HD + j + HALF];
      rope_pair(x1, x2, qpos, j, HALF, log_theta);
      qs[r * HD + j] = x1 * scale;
      qs[r * HD + j + HALF] = x2 * scale;
    }
  } else {
    for (int i = tid; i < GHD; i += THREADS) qs[i] *= scale;
  }

  // this thread's part of P.V: columns [c0, c0 + CPT) of query row r over
  // the slots of group g (g, g + NG, ...)
  const int g = tid / PV<HD, G>::TG;  // NG: past the last whole group
  const int r = tid % PV<HD, G>::TG / (HD / CPT);
  const int c0 = tid % (HD / CPT) * CPT;
  float acc[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) acc[e] = 0.f;

  for (int j = 0; j < n_mine; ++j) {
    const int st = j % STAGES;
    const int s0 = (c_first + j * CL) * N;
    int next = 0;  // the block-table entry of chunk j + STAGES, loading
    if constexpr (Slots::kPaged)
      if (j + STAGES < n_mine)
        next = slots.fetch_table(first_of(j + STAGES), last_of(j + STAGES));
    cp_async_wait<STAGES - 1>();
    __syncthreads();

    // logits: a thread a (query row, slot), four partial sums over columns
    const unsigned char* kst = kb + st * N * LD;
    for (int item = tid; item < G * N; item += THREADS) {
      const int rr = item / N, i = item % N;
      const float* qr = qs + rr * HD;
      const unsigned char* krow = kst + i * LD;
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;  // columns mod 4
#pragma unroll 4
      for (int u = 0; u < C::UNITS; ++u) {
        float kk[EPU];
        unpack<T, UNIT>(krow + u * UNIT, kk);
#pragma unroll
        for (int e = 0; e < EPU; e += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qr + u * EPU + e);
          d0 = fmaf(q4.x, kk[e], d0);
          d1 = fmaf(q4.y, kk[e + 1], d1);
          d2 = fmaf(q4.z, kk[e + 2], d2);
          d3 = fmaf(q4.w, kk[e + 3], d3);
        }
      }
      float dot = (d0 + d1) + (d2 + d3);
      if constexpr (Slots::kScaled) dot *= ksc[st * N + i];
      lg[rr * N + i] = visible(s0 + i) ? dot : -INFINITY;
    }
    __syncthreads();

    // each query row's chunk max, probabilities and sum: a warp a row
    for (int rr = warp; rr < G; rr += WARPS) {
      float cm = -INFINITY;
      for (int i = lane; i < N; i += 32) cm = fmaxf(cm, lg[rr * N + i]);
      cm = warp_max(cm);
      const float m_old = row_m[rr];
      const float m_new = fmaxf(m_old, cm);
      const bool any = m_new != -INFINITY;
      float psum = 0.f;
      for (int i = lane; i < N; i += 32) {
        const float p = any ? expf(lg[rr * N + i] - m_new) : 0.f;
        psum += p;
        // an int8 pool's value scale folds into the weight of P.V (a
        // hidden slot's scale may be any bits: its weight is 0)
        if constexpr (Slots::kScaled)
          lg[rr * N + i] = visible(s0 + i) ? p * vsc[st * N + i] : 0.f;
        else
          lg[rr * N + i] = p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = any ? expf(m_old - m_new) : 1.f;  // 0 at -inf
        row_a[rr] = alpha;
        row_l[rr] = row_l[rr] * alpha + psum;
        row_m[rr] = m_new;
      }
    }
    __syncthreads();

    // P.V over the group's slots, in slot order
    const float alpha = row_a[r];
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[e] *= alpha;
    const float* prow = lg + r * N;
    const unsigned char* vst =
        vb + st * N * LD + c0 * static_cast<int>(sizeof(T));
    if (g < NG) {
#pragma unroll
      for (int t = 0; t < (N + NG - 1) / NG; ++t) {
        const int i = g + t * NG;
        if (N % NG != 0 && i >= N) break;
        const float w = prow[i];
        float vv[CPT];
        load8<T>(vst + i * LD, vv);
#pragma unroll
        for (int e = 0; e < CPT; ++e) acc[e] = fmaf(w, vv[e], acc[e]);
      }
    }
    __syncthreads();  // stage st and the probabilities are free again

    if constexpr (Slots::kPaged) {
      if (j + STAGES < n_mine)
        slots.stash(next, tab + st * N, first_of(j + STAGES),
                    last_of(j + STAGES));
      __syncthreads();
    }
    issue(j + STAGES);
  }

  // the block's partial: the slot groups' acc summed in group order
  // (through the key and value stages: every copy has landed)
  float* gacc = reinterpret_cast<float*>(kb);  // NG x GHD
  if (g < NG) {
#pragma unroll
    for (int e = 0; e < CPT; ++e) gacc[g * GHD + r * HD + c0 + e] = acc[e];
  }
  __syncthreads();
  // into slot `rank` of rank 0's inbox: m[G], l[G], acc[GHD]
  cluster_wait();
  const uint32_t box = cluster_map(inbox + rank * L::BOX, 0);
  for (int i = tid; i < GHD; i += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) a += gacc[gg * GHD + i];
    cluster_store(box + 4 * (2 * G + i), a);
  }
  if (tid < G) {
    cluster_store(box + 4 * tid, row_m[tid]);
    cluster_store(box + 4 * (G + tid), row_l[tid]);
  }
  cluster_sync();  // rank 0's inbox is complete

  // rank 0 merges the ranks' partials in rank order. When no rank saw a
  // slot (the G rows share their slots), the rows take the mean of V over
  // the S slots instead, read once more through the slot source.
  if (rank == 0) {
    bool none = true;
#pragma unroll
    for (int w = 0; w < CL; ++w)
      none = none && inbox[w * L::BOX] == -INFINITY;
    if (none) {
      column_mean<HD, THREADS>(
          [&](int s, int c0, float (&x)[8]) {
            slots.template value8<HD>(s, c0, x);
          },
          S, reinterpret_cast<float*>(kb), qs);
      for (int i = tid; i < GHD; i += THREADS)
        o[q_base + i] = from_f<Q>(qs[i % HD]);
      return;
    }
    for (int i = tid; i < GHD; i += THREADS) {
      const int rr = i / HD;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < CL; ++w) mx = fmaxf(mx, inbox[w * L::BOX + rr]);
      float lsum = 0.f, a = 0.f;
      if (mx != -INFINITY) {
#pragma unroll
        for (int w = 0; w < CL; ++w) {
          const float* bx = inbox + w * L::BOX;
          const float f = expf(bx[rr] - mx);  // 0 for a rank that saw none
          lsum = fmaf(bx[G + rr], f, lsum);
          a = fmaf(bx[2 * G + i], f, a);
        }
      }
      o[q_base + i] = from_f<Q>(lsum > 0.f ? a / lsum : 0.f);
    }
  }
}

}  // namespace decode
}  // namespace port
