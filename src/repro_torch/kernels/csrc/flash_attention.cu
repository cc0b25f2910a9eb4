// Flash attention forward (streaming softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/flash_attention.py:
//   flash_attention_pallas (_flash_kernel without RoPE), forward
//   flash_attention_rope_pallas (_flash_kernel with RoPE on the loads)
// Their backward is flash_attention_bwd.cu.
//
// q: (B, H, T, HD); k, v: (B, KV, S, HD), head-major, f32 or bf16. Head h
// reads kv head h / (H / KV) (GQA). Key s is visible to query t iff
//   s < S, s <= t (causal), s > t - window (window > 0), s >= kv_offsets[b]
// (the left pad of a ragged prompt), the mask of _visibility_mask in the
// Pallas kernel. Writes o (B, H, T, HD) and, when asked, the f32 row
// logsumexp lse (B, H, T).
//
// With positions pos (B, T) f32 (self-attention, S == T: the training
// path's attention_full), flash_fwd_rope_kernel first rotates q and k into
// scratch the wrapper allocates (port::rope_qk: half-split RoPE through
// port::rope_rotate, the rotation the decode kernels use; each value
// widened to f32, rotated with one accurate sincosf a pair and stored in
// the input dtype once; flash_attention_bwd.cu rotates through the same
// function, so its recomputed probabilities match this lse), and the body
// runs on the rotated operands. Rotating each k tile in shared memory
// after its copy lands would repeat the rotation for every q block and
// head that visits the tile, ~1,300 instructions a thread a tile against
// ~500 for the tile's products and softmax: 0.160 ms a call against 0.082
// ms with the pass (bf16, H100, qwen3 shapes). Without pos the body is the
// one serving runs.
//
// A query row that sees no key at all (a left-pad row t < kv_offsets[b]) is
// written as the mean of V over the S keys, with lse = -inf: the softmax of
// equal masked logits, which the reference's attention gives there (its
// Pallas kernel too where one of its blocks holds exactly the S keys).
// Left pads route in an MoE layer and take capacity slots before the real
// tokens, so this value reaches real rows there. A block holding such a
// row reads its kv head's V once more for it (port::column_mean); other
// blocks do not.
//
// What bounds it: at the qwen3-1.7b shapes (B = 8, H = 16, KV = 8, T = S =
// 512, HD = 128, causal) a call moves 50 MB of q, k, v and o in bf16
// (15 us at 3.35 TB/s) and does 8.6 GFLOP of products (8.7 us at the bf16
// tensor-core peak): the bytes bound it, the products close behind.
//
// The dtype chooses the body (the C entry point dispatches on it; neither
// is a fallback of the other):
//
// bf16 -- flash_fwd_bf16_kernel, FlashAttention-2's design on mma.sync:
// - one block of 4 warps per (q block of 64 rows, head, batch row), each
//   warp 16 query rows; the q-block index is the slowest of the 1-D grid,
//   so under causal the longest blocks start first. The block walks the
//   key tiles of 64 that intersect its visible band (tiles wholly above
//   the causal frontier, older than the window or before the row's offset
//   are skipped), masking only tiles that cross an edge of the band.
// - q is copied once; k and v tiles are double-buffered in shared memory
//   with 16-byte cp.async, the next tile's copy in flight under this
//   tile's math. Rows are padded by 8 bf16, so the 8 rows an ldmatrix
//   phase reads fall into distinct banks. Shared memory: 5 tiles of
//   64 x (HD + 8) bf16, 87,040 bytes at HD = 128 (2 blocks an SM), 168,960
//   at HD = 256.
// - HD = 112 and 120 run on the tiles of 128 (port::padded_width): the
//   copies zero-fill the columns past HD, so q k^T and p v are unchanged,
//   only the real columns are stored, and the scale is the real width's
//   1/sqrt(HD). A bf16 row of 120 is 240 bytes (16-byte chunks stay
//   aligned); the RoPE pass moves 4 pairs (8 bytes a half) at a time
//   there, since the second half starts at byte 120 (port::rope_pairs).
// - s = q k^T with ldmatrix and mma.sync m16n8k16 (bf16 in, f32 out); q's
//   fragments stay in registers for HD <= 128. The online softmax runs on
//   the f32 accumulators (a quad of lanes holds a row: two shuffles for its
//   max and sum), with 1/sqrt(HD) applied in f32 inside exp2f (never to q
//   before its rounding). p, rounded to bf16, is the A operand of o += p v
//   straight from the registers (the m16n8 C layout is the A layout), v
//   read through ldmatrix.trans; o stays in f32 registers and is
//   normalised and stored through shared memory with 16-byte stores.
// - Registers (ptxas -v): 114 / 138 / 186 / 243 at HD = 32 / 64 / 128 /
//   256, no spills.
// - BK = 64: the serving prefill left-pads rows by multiples of 64, so a
//   padded row's real keys sit at the same column of the same tile as in
//   its unpadded run, and the sums meet the same operands in the same
//   order: rows equal their solo runs bit for bit.
//
// f32 -- flash_fwd_kernel, FMA in f32 (tensor cores take f32 only as TF32,
// which the f32 tolerances and the card-vs-CPU checks do not allow): one
// block of 256 threads per (q block of 64 rows, head, batch row) with an
// online softmax in f32. q (pre-scaled by 1/sqrt(HD)), k and v tiles are
// staged in shared memory as f32, rows padded by one float. Four threads
// own one query row: each computes 16 of the 64 logits, the row max and
// sum are combined with warp shuffles, and each thread accumulates HD/4
// output columns in registers, reading the probabilities of its row's
// other three threads by shuffle.

#include <math.h>

#include "common.cuh"

namespace {

using port::from_f;
using port::to_f;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 4 threads per query row

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * (HD + 1) + BK * (HD + 1) + BK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse,
                     const int* __restrict__ kv_offsets, int H, int KV,
                     int T_, int S, int causal, int window, float scale) {
  constexpr int QS = HD + 1;         // padded row stride of qs and ks
  constexpr int CPT = HD / 4;        // output columns per thread
  constexpr int JPT = BK / 4;        // logits per thread per key block
  extern __shared__ float smem[];
  float* qs = smem;                  // BQ x QS
  float* ks = qs + BQ * QS;          // BK x QS
  float* vs = ks + BK * QS;          // BK x HD

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 2;          // query row in the block
  const int qtr = tid & 3;           // which quarter of the row
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q_start = blockIdx.x * BQ;
  const int kvh = h / (H / KV);
  const size_t q_base = (static_cast<size_t>(b) * H + h) * T_;
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S;
  const int off = kv_offsets != nullptr ? kv_offsets[b] : 0;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    const int t = q_start + r;
    qs[r * QS + c] = t < T_ ? to_f(q[(q_base + t) * HD + c]) * scale : 0.f;
  }

  // the band of keys any row of this block can see
  const int q_last = min(q_start + BQ, T_) - 1;
  int k_hi = S;
  if (causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = max(0, off);
  if (window > 0) k_lo = max(k_lo, q_start - window + 1);

  const int t = q_start + row;
  float m = -INFINITY, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // qs is written; ks/vs of the last block are consumed
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, c = i % HD;
      const int s = k0 + r;
      const bool in = s < S;
      ks[r * QS + c] = in ? to_f(k[(kv_base + s) * HD + c]) : 0.f;
      vs[r * HD + c] = in ? to_f(v[(kv_base + s) * HD + c]) : 0.f;
    }
    __syncthreads();

    float sc[JPT];
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) sc[jj] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < HD; d0 += 8) {
      float qv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[e] = qs[row * QS + d0 + e];
#pragma unroll
      for (int jj = 0; jj < JPT; ++jj) {
        const float* kr = ks + (jj * 4 + qtr) * QS + d0;
#pragma unroll
        for (int e = 0; e < 8; ++e) sc[jj] = fmaf(qv[e], kr[e], sc[jj]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int s = k0 + jj * 4 + qtr;
      bool ok = s < S && s >= off;
      if (causal) ok = ok && s <= t;
      if (window > 0) ok = ok && s > t - window;
      sc[jj] = ok ? sc[jj] : -INFINITY;
      mx = fmaxf(mx, sc[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);  // 0 while m is -inf
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      sc[jj] = expf(sc[jj] - m_use);  // 0 for masked keys
      psum += sc[jj];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float p =
            __shfl_sync(0xffffffffu, sc[jj], (lane & ~3) | src);
        const float* vr = vs + (jj * 4 + src) * HD + qtr;
#pragma unroll
        for (int i = 0; i < CPT; ++i) acc[i] = fmaf(p, vr[4 * i], acc[i]);
      }
    }
  }

  // a row that sees no key (a left pad) takes the mean of V over the S
  // keys; ks and vs are free once every thread has left the loop
  float* mean = vs;
  if (__syncthreads_or(t < T_ && !(l > 0.f)))
    port::column_mean<HD, THREADS>(
        [&](int s, int c0, float (&x)[8]) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            x[e] = to_f(v[(kv_base + s) * HD + c0 + e]);
        },
        S, ks, mean);
  if (t < T_) {
    const size_t o_base = (q_base + t) * HD;
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      o[o_base + qtr + 4 * i] =
          from_f<T>(l > 0.f ? acc[i] / l : mean[qtr + 4 * i]);
    if (lse != nullptr && qtr == 0)
      lse[q_base + t] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_THREADS = 128;  // 4 warps, 16 query rows each
constexpr int ROPE_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
constexpr size_t tc_smem_bytes() {  // q, k[2], v[2]
  return 5 * port::Tile<port::padded_width<HD>()>::BYTES;
}


template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse,
                          const int* __restrict__ kv_offsets, int B, int H,
                          int KV, int T_, int S, int causal, int window,
                          float scale) {
  constexpr int HP = port::padded_width<HD>();  // tile width
  constexpr int LD = port::Tile<HP>::LD;
  constexpr int ELEMS = port::Tile<HP>::ELEMS;
  constexpr int KC = HP / 16;        // k steps of q k^T
  constexpr int NT = HP / 8;         // n tiles of o
  constexpr bool QREG = HP <= 128;   // q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + ELEMS;             // 2 stages
  bf16* vs = ks + 2 * ELEMS;         // 2 stages

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tq = lane & 3;
  // the q-block rank is the slowest index of the grid, so under causal the
  // longest blocks (the last q blocks) are issued first
  const int n_qblk = (T_ + BQ - 1) / BQ;
  const int rank = blockIdx.x / (H * B), rem = blockIdx.x % (H * B);
  const int h = rem % H, b = rem / H;
  const int q_start = (causal ? n_qblk - 1 - rank : rank) * BQ;
  const int kvh = h / (H / KV);
  const size_t q_base = (static_cast<size_t>(b) * H + h) * T_;
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S;
  const int off = kv_offsets != nullptr ? kv_offsets[b] : 0;

  // the band of keys any row of this block can see, as for the f32 body
  const int q_last = min(q_start + BQ, T_) - 1;
  int k_hi = S;
  if (causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = max(0, off);
  if (window > 0) k_lo = max(k_lo, q_start - window + 1);
  const int k_begin = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_begin ? (k_hi - k_begin + BK - 1) / BK : 0;

  const int row0 = warp * 16 + grp;  // this thread's rows: row0, row0 + 8
  const float sl2 = scale * LOG2E;   // exp(x * scale) = exp2(x * sl2)
  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  uint32_t qf[QREG ? KC : 1][4];

  if (n_tiles > 0) {
    port::tile_load_async<HD, TC_THREADS>(qs, q + q_base * HD, q_start, T_);
    port::tile_load_async<HD, TC_THREADS>(ks, k + kv_base * HD, k_begin, S);
    port::tile_load_async<HD, TC_THREADS>(vs, v + kv_base * HD, k_begin, S);
    port::cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = k_begin + it * BK;
    const bf16* kst = ks + st * ELEMS;
    const bf16* vst = vs + st * ELEMS;
    if (it + 1 < n_tiles) {  // the next tile's copy runs under this tile's math
      port::tile_load_async<HD, TC_THREADS>(ks + (st ^ 1) * ELEMS,
                                            k + kv_base * HD, k0 + BK, S);
      port::tile_load_async<HD, TC_THREADS>(vs + (st ^ 1) * ELEMS,
                                            v + kv_base * HD, k0 + BK, S);
      port::cp_async_commit();
      port::cp_async_wait<1>();
    } else {
      port::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          port::ldsm_x4(qf[kc], qs + (warp * 16 + (lane & 15)) * LD +
                                    kc * 16 + (lane >> 4) * 8);
      }
    }

    // s = q k^T: 16 rows x 64 keys a warp
    float sacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kc][i];
      } else {
        port::ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * LD + kc * 16 +
                             (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        port::ldsm_x4(bk, kst + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                    LD +
                                kc * 16 + ((lane >> 3) & 1) * 8);
        port::mma_bf16(sacc[2 * np], a, bk[0], bk[1]);
        port::mma_bf16(sacc[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // mask (only tiles that cross an edge of the band)
    const bool edge = k0 + BK > S || k0 < off ||
                      (causal && k0 + BK - 1 > q_start) ||
                      (window > 0 && k0 <= q_last - window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = k0 + n * 8 + 2 * tq + (e & 1);
          const int t = q_start + row0 + (e >> 1) * 8;
          bool ok = s < S && s >= off;
          if (causal) ok = ok && s <= t;
          if (window > 0) ok = ok && s > t - window;
          if (!ok) sacc[n][e] = -INFINITY;
        }
    }

    // online softmax, in f32 on the accumulators; a quad holds a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(sacc[n][2 * r], sacc[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f((m_r[r] - m_use) * sl2);  // 0 while m is -inf
      const float ms = m_use * sl2;
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float pe = exp2f(fmaf(sacc[n][e], sl2, -ms));  // 0 if masked
          sacc[n][e] = pe;
          psum += pe;
        }
      l_r[r] = l_r[r] * alpha + psum;  // this thread's part of the row sum
      m_r[r] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        oacc[n][2 * r] *= alpha;
        oacc[n][2 * r + 1] *= alpha;
      }
    }

    // o += p v: p (bf16) is the A operand straight from the accumulators
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t a[4] = {
          port::pack_bf16(sacc[2 * kc][0], sacc[2 * kc][1]),
          port::pack_bf16(sacc[2 * kc][2], sacc[2 * kc][3]),
          port::pack_bf16(sacc[2 * kc + 1][0], sacc[2 * kc + 1][1]),
          port::pack_bf16(sacc[2 * kc + 1][2], sacc[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        port::ldsm_x4_trans(
            bv, vst + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    np * 16 + (lane >> 4) * 8);
        port::mma_bf16(oacc[2 * np], a, bv[0], bv[1]);
        port::mma_bf16(oacc[2 * np + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // stage st is read; the copy of tile it + 2 may land
  }

  // epilogue: o / l through this warp's own rows of qs, 16-byte stores
  float inv[2];
  bool keyless[2], any_keyless = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;
    const int t = q_start + row0 + 8 * r;
    keyless[r] = !(l > 0.f);
    any_keyless = any_keyless || (keyless[r] && t < T_);
    if (lse != nullptr && tq == 0 && t < T_)
      lse[q_base + t] = l > 0.f ? m_r[r] * scale + logf(l) : -INFINITY;
  }
  // a row that sees no key (a left pad) takes the mean of V over the S
  // keys; the k stages are free once every thread has left the loop
  float* part = reinterpret_cast<float*>(ks);
  float* mean = part + TC_THREADS * 8;
  if (__syncthreads_or(any_keyless))
    port::column_mean<HD, TC_THREADS>(
        [&](int s, int c0, float (&x)[8]) {
          port::load16(v + (kv_base + s) * HD + c0, x);
        },
        S, part, mean);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(qs + row0 * LD + c) =
        keyless[0] ? port::pack_bf16(mean[c], mean[c + 1])
                   : port::pack_bf16(oacc[n][0] * inv[0], oacc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(qs + (row0 + 8) * LD + c) =
        keyless[1] ? port::pack_bf16(mean[c], mean[c + 1])
                   : port::pack_bf16(oacc[n][2] * inv[1], oacc[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CPR = HD / 8;  // the real columns' 16-byte chunks
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = warp * 16 + c / CPR, col = (c % CPR) * 8;
    const int t = q_start + r;
    if (t < T_)
      *reinterpret_cast<uint4*>(o + (q_base + t) * HD + col) =
          *reinterpret_cast<const uint4*>(qs + r * LD + col);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, const int* kv_offsets, int B, int H, int KV,
                int T_, int S, int causal, int window, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HD>();
  auto kernel = flash_fwd_bf16_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((T_ + BQ - 1) / BQ) * H * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, kv_offsets, B,
      H, KV, T_, S, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// RoPE and dispatch: f32 -> the FMA body, bf16 -> the tensor-core body
// ---------------------------------------------------------------------------

// q and k rotated by pos into the scratch qr, kr (the RoPE forward's first
// kernel; the attention body then reads the rotated operands).
template <typename T, int HD>
__global__ void __launch_bounds__(ROPE_THREADS)
    flash_fwd_rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          T* __restrict__ qr, T* __restrict__ kr,
                          const float* __restrict__ pos, int B, int H, int KV,
                          int T_, float log_theta) {
  port::rope_qk<T, HD>(
      static_cast<size_t>(blockIdx.x) * ROPE_THREADS + threadIdx.x, q, k, qr,
      kr, pos, B, H, KV, T_, log_theta);
}

template <typename T, int HD>
int launch_rope_pass(const void* q, const void* k, void* rot,
                     const float* pos, int B, int H, int KV, int T_,
                     float log_theta, cudaStream_t stream) {
  constexpr int PAIRS = port::rope_pairs<T, HD>();  // pairs a thread
  const long long threads =
      static_cast<long long>(B) * (H + KV) * T_ * (HD / 2 / PAIRS);
  const long long blocks = (threads + ROPE_THREADS - 1) / ROPE_THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  T* qr = static_cast<T*>(rot);
  flash_fwd_rope_kernel<T, HD>
      <<<static_cast<unsigned>(blocks), ROPE_THREADS, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), qr,
          qr + static_cast<size_t>(B) * H * T_ * HD, pos, B, H, KV, T_,
          log_theta);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const int* kv_offsets, int B, int H, int KV,
               int T_, int S, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<float, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_ + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, kv_offsets,
      H, KV, T_, S, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// With pos: q and k rotated into rot (qr then kr) first, then the body on
// the rotated operands.
template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, const int* kv_offsets, const float* pos, void* rot,
           int B, int H, int KV, int T_, int S, int causal, int window,
           float scale, float log_theta, cudaStream_t stream) {
  if (dtype != port::kF32 && dtype != port::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pos != nullptr) {
    if (rot == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int err =
        dtype == port::kF32
            ? launch_rope_pass<float, HD>(q, k, rot, pos, B, H, KV, T_,
                                          log_theta, stream)
            : launch_rope_pass<bf16, HD>(q, k, rot, pos, B, H, KV, T_,
                                         log_theta, stream);
    if (err != 0) return err;
    const size_t esize = dtype == port::kF32 ? sizeof(float) : sizeof(bf16);
    q = rot;
    k = static_cast<const char*>(rot) +
        static_cast<size_t>(B) * H * T_ * HD * esize;
  }
  if (dtype == port::kF32)
    return launch_f32<HD>(q, k, v, o, lse, kv_offsets, B, H, KV, T_, S,
                          causal, window, scale, stream);
  return launch_bf16<HD>(q, k, v, o, lse, kv_offsets, B, H, KV, T_, S,
                         causal, window, scale, stream);
}

}  // namespace

extern "C" {

// q (B, H, T, hd); k, v (B, KV, S, hd); o like q; all of `dtype`,
// contiguous. lse (B, H, T) f32 or null; kv_offsets (B,) int32 or null;
// pos (B, T) f32 positions or null (no RoPE); with pos, S == T and
// log_theta = log(rope_theta), and `rot` is scratch of B * (H + KV) * T * hd
// elements of `dtype` for the rotated q and k. window <= 0 means no window.
// hd is 32, 64, 112, 120, 128 or 256.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, const int* kv_offsets, const float* pos,
                        void* rot, int B, int H, int KV, int T_, int S,
                        int hd, int causal, int window, float scale,
                        float log_theta, int dtype, cudaStream_t stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || T_ < 1 || S < 1 ||
      B > 65535 || H > 65535 || (pos != nullptr && S != T_))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch<32>(dtype, q, k, v, o, lse, kv_offsets, pos, rot, B, H,
                        KV, T_, S, causal, window, scale, log_theta, stream);
    case 64:
      return launch<64>(dtype, q, k, v, o, lse, kv_offsets, pos, rot, B, H,
                        KV, T_, S, causal, window, scale, log_theta, stream);
    case 112:
      return launch<112>(dtype, q, k, v, o, lse, kv_offsets, pos, rot, B, H,
                         KV, T_, S, causal, window, scale, log_theta, stream);
    case 120:
      return launch<120>(dtype, q, k, v, o, lse, kv_offsets, pos, rot, B, H,
                         KV, T_, S, causal, window, scale, log_theta, stream);
    case 128:
      return launch<128>(dtype, q, k, v, o, lse, kv_offsets, pos, rot, B, H,
                         KV, T_, S, causal, window, scale, log_theta, stream);
    case 256:
      return launch<256>(dtype, q, k, v, o, lse, kv_offsets, pos, rot, B, H,
                         KV, T_, S, causal, window, scale, log_theta, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
