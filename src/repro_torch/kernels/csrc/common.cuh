// Shared helpers of the port's CUDA kernels: element types, conversions to
// and from f32, 16-byte vector loads and stores, a block-wide sum, a named
// barrier over some warps of a block, the RoPE rotation, the sm_80+
// tensor-core building blocks the bf16 flash attention kernels use
// (cp.async, ldmatrix, mma.sync m16n8k16), and the sm_90 cluster barrier
// and distributed shared-memory store of the decode kernels.
//
// Every kernel takes f32 or bf16 tensors (a dtype code from the wrapper:
// 0 = float32, 1 = bfloat16) and computes in f32. bf16 values are rounded
// to nearest even, as PyTorch and XLA round them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// N consecutive elements of T (N * sizeof(T) = 4, 8 or 16 bytes) at an
// address aligned to their size: where a row's halves or chunks are not
// 16-byte aligned (bf16 rows of 120, whose second half starts at byte 120).
template <typename T, int N>
struct alignas(N * sizeof(T)) VecN {
  T e[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[N]) {
  const VecN<T, N> raw = *reinterpret_cast<const VecN<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = to_f(raw.e[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[N]) {
  VecN<T, N> raw;
#pragma unroll
  for (int i = 0; i < N; ++i) raw.e[i] = from_f<T>(v[i]);
  *reinterpret_cast<VecN<T, N>*>(p) = raw;
}

// Column pairs (c, c + HD/2) of a half-split RoPE row that one vector of
// each half holds: a 16-byte vector where HD/2 divides into them, else
// the widest smaller one that does (bf16 HD = 120: 4 pairs, 8 bytes), so
// both halves' vectors stay aligned to their size.
template <typename T, int HD>
__host__ __device__ constexpr int rope_pairs() {
  int n = Vec16<T>::N;
  while ((HD / 2) % n != 0) n /= 2;
  return n;
}

// The width of the bf16 tensor-core tiles for a head width HD: HD rounded
// up to a multiple of 32 (112 and 120 take tiles of 128). The columns past
// HD are zeros in every q, k, v, do tile, so q k^T, p v, ds k and ds^T q
// are unchanged, and they are never stored.
template <int HD>
__host__ __device__ constexpr int padded_width() {
  return (HD + 31) / 32 * 32;
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

// Barrier over `threads` threads (whole warps) of the block on hardware
// barrier `id` (1..15; __syncthreads uses 0): a team of warps meets
// without stopping the block's other teams.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Frequency of pair j of a half-split RoPE row: exp(-(j / half) * log_theta).
__device__ __forceinline__ float rope_freq(int j, int half, float log_theta) {
  return expf(-(static_cast<float>(j) / static_cast<float>(half)) *
              log_theta);
}

// Rotates one pair (x1 = element j, x2 = element j + half of a row) by the
// angle pos * freq. Every product and sum is spelled out (no contraction
// left to the compiler), so every kernel that rotates the same value gets
// the same bits: the flash backward re-rotates q and k exactly as the
// forward did, and its recomputed probabilities match the forward's lse.
__device__ __forceinline__ void rope_rotate(float& x1, float& x2, float pos,
                                            float freq) {
  float sn, cs;
  sincosf(__fmul_rn(pos, freq), &sn, &cs);
  const float a = x1, b = x2;
  x1 = __fmaf_rn(a, cs, -__fmul_rn(b, sn));
  x2 = __fmaf_rn(a, sn, __fmul_rn(b, cs));
}

// Half-split RoPE of one pair at position pos with freq_j = rope_freq(j):
// the rotation of repro.kernels.flash_attention._rope_rotate. The decode
// kernels (the query row) and the flash attention kernels (their q and k
// tiles, and dq, dk rotated back by -pos) all rotate through rope_rotate,
// so they cannot drift apart.
__device__ __forceinline__ void rope_pair(float& x1, float& x2, float pos,
                                          int j, int half, float log_theta) {
  rope_rotate(x1, x2, pos, rope_freq(j, half, log_theta));
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks (sm_80 and later; the bf16 flash attention
// kernels). Fragment layouts are those of the PTX ISA for
// mma.m16n8k16 with .bf16 inputs: lane = 4 * group + t (group = lane / 4,
// t = lane % 4);
//   A (16 x 16, row-major): a0 = (group, 2t..2t+1), a1 = (group + 8, 2t..),
//     a2 = (group, 2t + 8..), a3 = (group + 8, 2t + 8..);
//   B (16 x 8, k x n): b0 = (2t..2t+1, group), b1 = (2t + 8.., group);
//   C (16 x 8, f32): c0, c1 = (group, 2t..2t+1), c2, c3 = (group + 8, ..).
// A C tile's pair (c0, c1) or (c2, c3), packed to bf16, is the A fragment
// of the next product whose k runs over those columns.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `valid` false writes zeros
// (src must still be a mapped address; it is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes global -> shared, asynchronously (8-byte aligned addresses).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously (any 4-byte aligned address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Thread block clusters (sm_90): a block's rank in its cluster, a barrier
// over every thread of the cluster (release/acquire: shared-memory writes
// before it are visible to the cluster's blocks after it), and stores into
// another block's shared memory (distributed shared memory).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The two halves of a barrier that orders no memory: a block arrives when
// it starts and waits before its first store into another block's shared
// memory, which is then sure to be running.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` (a shared variable of this block) in
// the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_map(const void* p,
                                                uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_store(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and receives in r[i] its fragment of matrix i
// (row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1; with .trans the matrix
// is transposed first).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b on the tensor cores: bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (to nearest even) in one register, `lo` in the
// low half: the element with the smaller column index of a fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 64-row bf16 tiles of the flash attention kernels: rows of HD elements at
// a shared-memory row stride of HD + 8 (16 bytes of padding, so the eight
// rows one ldmatrix phase reads fall into distinct banks).
template <int HD>
struct Tile {
  static constexpr int LD = HD + 8;          // row stride, elements
  static constexpr int ELEMS = 64 * LD;
  static constexpr size_t BYTES = sizeof(__nv_bfloat16) * ELEMS;
};

// Rows [r0, r0 + 64) of a row-major (n, HD) bf16 matrix into a shared tile
// of HP = padded_width<HD>() columns, as 16-byte cp.async copies issued by
// the NTHREADS threads of the block (the caller commits the group); rows
// at or past n, and columns at or past HD, are zeros.
template <int HD, int NTHREADS>
__device__ __forceinline__ void tile_load_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int r0, int n) {
  constexpr int HP = padded_width<HD>();
  static_assert(HD % 8 == 0, "rows are whole 16-byte chunks");
  constexpr int CPR = HP / 8;  // 16-byte chunks a tile row
  for (int c = threadIdx.x; c < 64 * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int row = r0 + r;
    const bool ok = row < n && col < HD;
    cp_async16(dst + r * Tile<HP>::LD + col,
               src + (ok ? static_cast<size_t>(row) * HD + col : 0), ok);
  }
}

// The column means of S rows of HD values into out[HD] (shared memory),
// with all NTHREADS threads of the block: row(s, c0, x) loads columns
// [c0, c0 + 8) of row s into x as f32. Thread i < R * (HD / 8) sums column
// group i % (HD / 8) over rows i / (HD / 8), + R, ... (R = NTHREADS /
// (HD / 8) row lanes; the threads past them idle where HD / 8 does not
// divide NTHREADS); the lanes' partials (part: shared, NTHREADS * 8
// floats) then add in lane order, so the result depends on S and the
// values only. Ends with a barrier. The attention kernels write it to a
// query row that sees no key: the softmax of equal masked logits, as the
// reference's attention gives it.
template <int HD, int NTHREADS, typename Row>
__device__ __forceinline__ void column_mean(const Row& row, int S,
                                            float* part, float* out) {
  constexpr int CG = HD / 8;  // column groups of 8
  static_assert(HD % 8 == 0 && CG <= NTHREADS, "groups fit the block");
  constexpr int R = NTHREADS / CG;
  const int c0 = threadIdx.x % CG * 8, lane = threadIdx.x / CG;
  if (lane < R) {
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = lane; s < S; s += R) {
      float x[8];
      row(s, c0, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] += x[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) part[lane * HD + c0 + e] = a[e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < HD; c += NTHREADS) {
    float m = 0.f;
    for (int w = 0; w < R; ++w) m += part[w * HD + c];
    out[c] = m / static_cast<float>(S);
  }
  __syncthreads();
}

// RoPE of head-major q (B, H, T, HD) and k (B, KV, T, HD) by the positions
// pos (B, T) into qr and kr, for thread i of a 1-D grid of
// B * (H + KV) * T * HD / (2 N) threads: each rotates N = rope_pairs<T,
// HD>() pairs (columns c..c+N-1 and c+HD/2..c+HD/2+N-1) of one row, rows
// of q first, then rows of k. Each value is widened to f32, rotated and
// stored in T once, so every kernel that rotates through here gets the
// same operands.
template <typename T, int HD>
__device__ __forceinline__ void rope_qk(size_t i, const T* __restrict__ q,
                                        const T* __restrict__ k,
                                        T* __restrict__ qr,
                                        T* __restrict__ kr,
                                        const float* __restrict__ pos, int B,
                                        int H, int KV, int T_,
                                        float log_theta) {
  constexpr int N = rope_pairs<T, HD>(), HALF = HD / 2, CPR = HALF / N;
  const size_t q_rows = static_cast<size_t>(B) * H * T_;
  const size_t rows = q_rows + static_cast<size_t>(B) * KV * T_;
  if (i >= rows * CPR) return;
  size_t row = i / CPR;
  const int c = static_cast<int>(i % CPR) * N;
  const T* src = q;
  T* dst = qr;
  int nh = H;
  if (row >= q_rows) {
    row -= q_rows;
    src = k;
    dst = kr;
    nh = KV;
  }
  const int t = static_cast<int>(row % T_);
  const size_t b = row / (static_cast<size_t>(nh) * T_);
  const float p = pos[b * T_ + t];
  float x1[N], x2[N];
  load_vec<T, N>(src + row * HD + c, x1);
  load_vec<T, N>(src + row * HD + c + HALF, x2);
#pragma unroll
  for (int e = 0; e < N; ++e)
    rope_rotate(x1[e], x2[e], p, rope_freq(c + e, HALF, log_theta));
  store_vec<T, N>(dst + row * HD + c, x1);
  store_vec<T, N>(dst + row * HD + c + HALF, x2);
}

}  // namespace port
