// Flash attention backward (recomputation from the row logsumexp) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/flash_attention.py:
//   flash_attention_backward_pallas (_recompute_p_ds, _flash_bwd_dq_kernel,
//   _flash_bwd_dkv_kernel; the split path), and with its RoPE flag the
//   RoPE wrapper flash_attention_rope_backward (:629)
//
// q, o, do: (B, H, T, HD); k, v: (B, KV, S, HD), head-major, f32 or bf16;
// lse: (B, H, T) f32, the forward's row logsumexp. Head h reads kv head
// h / (H / KV). Key s is visible to query t iff s < S, s <= t (causal) and
// s > t - window (window > 0), the mask of flash_attention.cu. With
// scale = 1/sqrt(HD), everything accumulated in f32:
//
//   delta = rowsum(do * o)
//   p  = exp(q k^T * scale - lse)    (0 where not visible)
//   ds = p * (do v^T - delta)
//   dv = p^T do,  dk = ds^T q * scale,  dq = ds k * scale
//
// dq, dk, dv are written in the input dtype. Nothing (T, S)-sized is ever
// stored: each kernel rebuilds its p and ds tiles from q, k, v, do, lse and
// delta. With positions pos (B, T) (RoPE attention, S == T) q and k are the
// UNROTATED inputs: flash_bwd_rope_kernel rotates them once into scratch
// through port::rope_qk, the forward's rotation (the same operands bit for
// bit), the bodies run on the rotated operands, and each rotates its dq or
// dk back by -pos in its epilogue: the RoPE backward is one call with no
// plain-torch pass.
//
// Deterministic, with no atomics: dq is owned by one block per (q block,
// head), and dk, dv by one block per (key block, kv head) that sums its
// GQA group's heads in a fixed order. Two calls give the same bits, so a
// remat step equals the plain one.
//
// What bounds it: at the qwen3-1.7b shapes (B = 8, H = 16, KV = 8, T = S =
// 512, HD = 128, causal) a call moves 100 MB of inputs and outputs in bf16
// (30 us at 3.35 TB/s) and the five products of the algorithm are 22
// GFLOP (22 us at the bf16 tensor-core peak): bytes and products nearly
// balance. These kernels compute seven products (s and dp twice, once for
// dq and once for dk, dv).
//
// The dtype chooses the bodies (the C entry point dispatches on it;
// neither is a fallback of the other):
//
// bf16 -- two kernels on mma.sync m16n8k16 (bf16 in, f32 accumulators),
// ldmatrix, and 16-byte cp.async double buffers; tile rows padded by 8
// bf16 for conflict-free ldmatrix:
// - flash_bwd_dq_bf16_kernel, first: one block of 4 warps per (q block of
//   64, head, batch row), the longest (last) q blocks first. q and do stay
//   in shared memory; k and v tiles of 64 stream through two stages. Each
//   warp computes s and dp for its 16 rows x 64 keys, p and ds in
//   registers, and dq += ds k with ds as the A operand straight from the
//   accumulators (k through ldmatrix.trans). It also computes delta for its
//   64 rows from o and do and writes it for the second kernel. dq is
//   staged in f32 through the q and do tiles and rotated back there, after
//   the accumulators are dead. Shared memory 104,704 bytes at HD = 128 (2
//   blocks an SM); 169 registers (238 with RoPE, still 2 blocks an SM), no
//   spills.
// - flash_bwd_dkv_bf16_kernel: one block of 8 warps per (key block of 64,
//   kv head, batch row), all key blocks 0 (under causal the longest) first.
//   k and v stay in shared memory; (q, do, lse, delta) tiles of the group's
//   heads and visible q blocks stream through two stages. Warp (g, c)
//   computes s^T = k q^T and dp^T = v do^T for keys 16g..16g+15 and queries
//   32c..32c+31, then p^T and ds^T, which go to shared memory in bf16; then
//   dv += p^T do and dk += ds^T q for its 16 keys and half c of the
//   columns. dk and dv are staged in f32 through the free q and do stages
//   and stored a column pair (j, j + HD/2) at a time, dk rotated back by
//   -pos there (RoPE), as dq is. 123,904 bytes at HD = 128 (1 block an
//   SM).
// - HD = 112 and 120 run on tiles of 128 columns (port::padded_width): the
//   columns past HD are zero-filled by the copies, so every product is
//   unchanged, and only the HD real columns are stored; 1/sqrt(HD) is the
//   real width's. A bf16 row of 120 is 240 bytes, so rows stay 16-byte
//   aligned for the copies, but its halves are not: the RoPE pass and the
//   epilogues move 4 column pairs (8 bytes a half) at a time there
//   (port::rope_pairs).
// HD = 256 is not taken: its dk and dv accumulators would not fit in the
// registers without spills.
//
// f32 -- three kernels, FMA in f32 (tensor cores take f32 only as TF32):
// - flash_bwd_delta_kernel: one warp a row;
// - flash_bwd_dkv_kernel: one block of 256 threads per (key block of 64,
//   kv head, batch row), k and v tiles in shared memory, walking every q
//   head of its GQA group and every q block that sees the key block. Four
//   threads own one key row: each scores 16 of the 64 query rows (q.k and
//   do.v), and the row's p and ds are exchanged by warp shuffles for the
//   HD/4 output columns each thread accumulates.
// - flash_bwd_dq_kernel: one block per (q block of 64, head, batch row)
//   walks the key blocks of its band, as the forward does, recomputing p
//   and ds; four threads own one query row.
// Tiles are staged as f32 in shared memory, rows padded by one float: 4
// tiles of 64 x (HD + 1), 132 KB at HD = 128, so HD <= 128; any HD that
// is a multiple of 8 (four threads a row, each HD/4 columns, RoPE pairs
// (qtr + 4i, qtr + 4i + HD/2) in one thread).

#include <math.h>

#include "common.cuh"

namespace {

using port::from_f;
using port::to_f;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 4 threads per tile row
constexpr int ROW_WARPS = 8;  // flash_bwd_delta_kernel: one warp per row

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ + BK) * 2 * (HD + 1) + 2 * BQ);
}

__device__ __forceinline__ bool visible(int t, int s, int T_, int S,
                                        int causal, int window) {
  bool ok = t < T_ && s < S;
  if (causal) ok = ok && s <= t;
  if (window > 0) ok = ok && s > t - window;
  return ok;
}

// Loads rows [r0, r0 + 64) of a (rows, HD) matrix into a padded f32 tile;
// rows at or past n are 0.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          size_t base, int r0, int n) {
  constexpr int QS = HD + 1;
  for (int i = threadIdx.x; i < 64 * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    const int t = r0 + r;
    dst[r * QS + c] = t < n ? to_f(src[(base + t) * HD + c]) : 0.f;
  }
}

// delta[row] = sum_c do[row, c] * o[row, c] over rows = B * H * T.
template <typename T, int HD>
__global__ void __launch_bounds__(ROW_WARPS * 32)
    flash_bwd_delta_kernel(const T* __restrict__ o,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, size_t rows) {
  constexpr int C = (HD + 31) / 32;  // columns a lane (the last may be short)
  const size_t row = static_cast<size_t>(blockIdx.x) * ROW_WARPS +
                     (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (HD % 32 != 0 && lane + 32 * c >= HD) break;
    const size_t at = row * HD + lane + 32 * c;
    acc = fmaf(to_f(dout[at]), to_f(o[at]), acc);
  }
  acc = port::warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int HD, bool ROPE>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv,
               const float* __restrict__ pos, int H, int KV, int T_, int S,
               int causal, int window, float scale, float log_theta) {
  constexpr int QS = HD + 1;
  constexpr int CPT = HD / 4;  // output columns per thread
  constexpr int JPT = BQ / 4;  // query rows scored per thread per q block
  extern __shared__ float smem[];
  float* ks = smem;            // BK x QS
  float* vs = ks + BK * QS;    // BK x QS
  float* qs = vs + BK * QS;    // BQ x QS
  float* dos = qs + BQ * QS;   // BQ x QS
  float* lses = dos + BQ * QS; // BQ
  float* dls = lses + BQ;      // BQ

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 2;    // key row in the block
  const int qtr = tid & 3;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int k_start = blockIdx.x * BK;
  const int G = H / KV;
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S;
  load_tile<T, HD>(ks, k, kv_base, k_start, S);
  load_tile<T, HD>(vs, v, kv_base, k_start, S);
  const float* posb = ROPE ? pos + static_cast<size_t>(b) * T_ : nullptr;

  // the queries any key of this block is visible to
  const int k_last = min(k_start + BK, S) - 1;
  const int q_lo = causal ? k_start : 0;
  int q_hi = T_;
  if (window > 0) q_hi = min(q_hi, k_last + window);
  const int s = k_start + row;

  float acc_k[CPT], acc_v[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const size_t q_base = (static_cast<size_t>(b) * H + kvh * G + g) * T_;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // k/v are staged; the last q block is consumed
      load_tile<T, HD>(qs, q, q_base, q0, T_);
      load_tile<T, HD>(dos, dout, q_base, q0, T_);
      if (tid < BQ) {
        const int t = q0 + tid;
        lses[tid] = t < T_ ? lse[q_base + t] : 0.f;
        dls[tid] = t < T_ ? delta[q_base + t] : 0.f;
      }
      __syncthreads();

      float sc[JPT], dp[JPT];
#pragma unroll
      for (int jj = 0; jj < JPT; ++jj) sc[jj] = dp[jj] = 0.f;
#pragma unroll 2
      for (int d0 = 0; d0 < HD; d0 += 8) {
        float kv[8], vv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          kv[e] = ks[row * QS + d0 + e];
          vv[e] = vs[row * QS + d0 + e];
        }
#pragma unroll
        for (int jj = 0; jj < JPT; ++jj) {
          const float* qr = qs + (jj * 4 + qtr) * QS + d0;
          const float* dr = dos + (jj * 4 + qtr) * QS + d0;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            sc[jj] = fmaf(kv[e], qr[e], sc[jj]);
            dp[jj] = fmaf(vv[e], dr[e], dp[jj]);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < JPT; ++jj) {
        const int j = jj * 4 + qtr;
        const float p = visible(q0 + j, s, T_, S, causal, window)
                            ? expf(sc[jj] * scale - lses[j])
                            : 0.f;
        sc[jj] = p;
        dp[jj] = p * (dp[jj] - dls[j]);
      }
      // dv[s] += sum_j p_j do_j; dk[s] += sum_j ds_j q_j (scaled at the end)
#pragma unroll
      for (int jj = 0; jj < JPT; ++jj) {
#pragma unroll
        for (int src = 0; src < 4; ++src) {
          const float p = __shfl_sync(0xffffffffu, sc[jj], (lane & ~3) | src);
          const float ds = __shfl_sync(0xffffffffu, dp[jj], (lane & ~3) | src);
          const int j = jj * 4 + src;
          const float* dor = dos + j * QS + qtr;
          const float* qr = qs + j * QS + qtr;
#pragma unroll
          for (int i = 0; i < CPT; ++i) {
            acc_v[i] = fmaf(p, dor[4 * i], acc_v[i]);
            acc_k[i] = fmaf(ds, qr[4 * i], acc_k[i]);
          }
        }
      }
    }
  }

  if (s < S) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc_k[i] *= scale;
    if constexpr (ROPE) {  // back to the unrotated k: rotate by -pos
#pragma unroll
      for (int i = 0; i < CPT / 2; ++i)
        port::rope_pair(acc_k[i], acc_k[i + CPT / 2], -posb[s], qtr + 4 * i,
                        HD / 2, log_theta);
    }
    const size_t at = (kv_base + s) * HD + qtr;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      dk[at + 4 * i] = from_f<T>(acc_k[i]);
      dv[at + 4 * i] = from_f<T>(acc_v[i]);
    }
  }
}

template <typename T, int HD, bool ROPE>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, const float* __restrict__ pos, int H,
              int KV, int T_, int S, int causal, int window, float scale,
              float log_theta) {
  constexpr int QS = HD + 1;
  constexpr int CPT = HD / 4;
  constexpr int JPT = BK / 4;  // keys scored per thread per key block
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x QS
  float* dos = qs + BQ * QS;   // BQ x QS
  float* ks = dos + BQ * QS;   // BK x QS
  float* vs = ks + BK * QS;    // BK x QS
  float* lses = vs + BK * QS;  // BQ
  float* dls = lses + BQ;      // BQ

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 2;    // query row in the block
  const int qtr = tid & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q_start = blockIdx.x * BQ;
  const int kvh = h / (H / KV);
  const size_t q_base = (static_cast<size_t>(b) * H + h) * T_;
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S;
  load_tile<T, HD>(qs, q, q_base, q_start, T_);
  load_tile<T, HD>(dos, dout, q_base, q_start, T_);
  if (tid < BQ) {
    const int t = q_start + tid;
    lses[tid] = t < T_ ? lse[q_base + t] : 0.f;
    dls[tid] = t < T_ ? delta[q_base + t] : 0.f;
  }
  const float* posb = ROPE ? pos + static_cast<size_t>(b) * T_ : nullptr;

  // the band of keys any row of this block can see
  const int q_last = min(q_start + BQ, T_) - 1;
  int k_hi = S;
  if (causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(k_lo, q_start - window + 1);
  const int t = q_start + row;

  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // q/do are staged; the last k/v block is consumed
    load_tile<T, HD>(ks, k, kv_base, k0, S);
    load_tile<T, HD>(vs, v, kv_base, k0, S);
    __syncthreads();
    const float lrow = lses[row], drow = dls[row];

    float sc[JPT], dp[JPT];
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) sc[jj] = dp[jj] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < HD; d0 += 8) {
      float qv[8], dv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qv[e] = qs[row * QS + d0 + e];
        dv[e] = dos[row * QS + d0 + e];
      }
#pragma unroll
      for (int jj = 0; jj < JPT; ++jj) {
        const float* kr = ks + (jj * 4 + qtr) * QS + d0;
        const float* vr = vs + (jj * 4 + qtr) * QS + d0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sc[jj] = fmaf(qv[e], kr[e], sc[jj]);
          dp[jj] = fmaf(dv[e], vr[e], dp[jj]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const float p = visible(t, k0 + jj * 4 + qtr, T_, S, causal, window)
                          ? expf(sc[jj] * scale - lrow)
                          : 0.f;
      dp[jj] = p * (dp[jj] - drow);
    }
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float ds = __shfl_sync(0xffffffffu, dp[jj], (lane & ~3) | src);
        const float* kr = ks + (jj * 4 + src) * QS + qtr;
#pragma unroll
        for (int i = 0; i < CPT; ++i) acc[i] = fmaf(ds, kr[4 * i], acc[i]);
      }
    }
  }

  if (t < T_) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[i] *= scale;
    if constexpr (ROPE) {  // back to the unrotated q: rotate by -pos
#pragma unroll
      for (int i = 0; i < CPT / 2; ++i)
        port::rope_pair(acc[i], acc[i + CPT / 2], -posb[t], qtr + 4 * i,
                        HD / 2, log_theta);
    }
    const size_t at = (q_base + t) * HD + qtr;
#pragma unroll
    for (int i = 0; i < CPT; ++i) dq[at + 4 * i] = from_f<T>(acc[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core bodies
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int DQ_THREADS = 128;   // 4 warps, 16 query rows each
constexpr int DKV_THREADS = 256;  // 8 warps: 4 groups of 16 keys, x 2
constexpr int PLD = BQ + 8;       // row stride of the p^T and ds^T tiles
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
constexpr size_t dq_smem_bytes() {  // q, do, k[2], v[2], delta
  return 6 * port::Tile<port::padded_width<HD>()>::BYTES +
         sizeof(float) * BQ;
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  // k, v, q[2], do[2], p^T, ds^T, lse[2], delta[2]
  return 6 * port::Tile<port::padded_width<HD>()>::BYTES +
         2 * sizeof(bf16) * BK * PLD + sizeof(float) * 4 * BQ;
}

// Rows r0 + r (r < n, r += step from r_first) of an f32 tile (row stride
// FLD) into bf16 rows base_row + r of dst (HD columns a row), a thread
// taking CP column pairs (c, c + HD/2) at a time, CP = rope_pairs: with
// ROPE each pair is first rotated back by -pos of its row (posb[base_row +
// r]). Rows at or past `limit` (T or S) are not stored. Each half's CP
// columns are read as 16-byte vectors (src and FLD keep them aligned: FLD
// is a multiple of 4 floats, and so is HD/2) and stored as one aligned
// vector.
template <int HD, bool ROPE>
__device__ __forceinline__ void store_pair_rows(
    const float* src, int fld, int r0, int n, int r_first, int step,
    int base_row, int limit, bf16* __restrict__ dst, size_t dst_row0,
    const float* posb, float log_theta) {
  constexpr int HALF = HD / 2, CP = port::rope_pairs<bf16, HD>();
  constexpr int CPH = HALF / CP;  // pair chunks a row
  static_assert(CP % 4 == 0 && HALF % 4 == 0, "16-byte f32 reads");
  for (int i = r_first; i < n * CPH; i += step) {
    const int r = r0 + i / CPH, c = (i % CPH) * CP;
    const int t = base_row + r;
    if (t >= limit) continue;
    float x1[CP], x2[CP];
#pragma unroll
    for (int e = 0; e < CP; e += 4) {
      const float4 a =
          *reinterpret_cast<const float4*>(src + r * fld + c + e);
      const float4 b =
          *reinterpret_cast<const float4*>(src + r * fld + c + HALF + e);
      x1[e] = a.x, x1[e + 1] = a.y, x1[e + 2] = a.z, x1[e + 3] = a.w;
      x2[e] = b.x, x2[e + 1] = b.y, x2[e + 2] = b.z, x2[e + 3] = b.w;
    }
    if constexpr (ROPE) {
#pragma unroll
      for (int e = 0; e < CP; ++e)
        port::rope_pair(x1[e], x2[e], -posb[t], c + e, HALF, log_theta);
    }
    bf16* row = dst + (dst_row0 + t) * HD;
    port::store_vec<bf16, CP>(row + c, x1);
    port::store_vec<bf16, CP>(row + c + HALF, x2);
  }
}

// dq, and delta = rowsum(do * o) for the block's rows on the way (written
// for flash_bwd_dkv_bf16_kernel, which runs after it on the stream). With
// ROPE, q and k are the rotated operands and dq is rotated back by -pos.
template <int HD, bool ROPE>
__global__ void __launch_bounds__(DQ_THREADS)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ o,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ delta, bf16* __restrict__ dq,
                             const float* __restrict__ pos, int B, int H,
                             int KV, int T_, int S, int causal, int window,
                             float scale, float log_theta) {
  constexpr int HP = port::padded_width<HD>();  // tile width
  constexpr int LD = port::Tile<HP>::LD;
  constexpr int ELEMS = port::Tile<HP>::ELEMS;
  constexpr int KC = HP / 16;  // k steps of q k^T and do v^T
  constexpr int NT = HP / 8;   // n tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + ELEMS;
  bf16* ks = dos + ELEMS;      // 2 stages
  bf16* vs = ks + 2 * ELEMS;   // 2 stages
  float* dls = reinterpret_cast<float*>(vs + 2 * ELEMS);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tq = lane & 3;
  // the q-block rank is the slowest grid index: under causal the longest
  // blocks (the last q blocks) are issued first
  const int n_qblk = (T_ + BQ - 1) / BQ;
  const int rank = blockIdx.x / (H * B), rem = blockIdx.x % (H * B);
  const int h = rem % H, b = rem / H;
  const int q_start = (causal ? n_qblk - 1 - rank : rank) * BQ;
  const int kvh = h / (H / KV);
  const size_t q_base = (static_cast<size_t>(b) * H + h) * T_;
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S;
  const float* posb = ROPE ? pos + static_cast<size_t>(b) * T_ : nullptr;

  const int q_last = min(q_start + BQ, T_) - 1;
  int k_hi = S;
  if (causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(k_lo, q_start - window + 1);
  const int k_begin = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_begin ? (k_hi - k_begin + BK - 1) / BK : 0;

  port::tile_load_async<HD, DQ_THREADS>(qs, q + q_base * HD, q_start, T_);
  port::tile_load_async<HD, DQ_THREADS>(dos, dout + q_base * HD, q_start, T_);
  if (n_tiles > 0) {
    port::tile_load_async<HD, DQ_THREADS>(ks, k + kv_base * HD, k_begin, S);
    port::tile_load_async<HD, DQ_THREADS>(vs, v + kv_base * HD, k_begin, S);
  }
  port::cp_async_commit();

  {  // delta under the copies: two threads a row, each half of the
     // row's 16-byte chunks (the first thread the extra one of an odd count)
    constexpr int CH = HD / 8, CH0 = (CH + 1) / 2;
    const int r = threadIdx.x >> 1, part = threadIdx.x & 1;
    const int t = q_start + r;
    float acc = 0.f;
    if (t < T_) {
      const size_t at = (q_base + t) * HD;
#pragma unroll
      for (int ch = part * CH0; ch < (part ? CH : CH0); ++ch) {
        float ov[8], dv[8];
        port::load16(o + at + ch * 8, ov);
        port::load16(dout + at + ch * 8, dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(dv[e], ov[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      dls[r] = acc;
      if (t < T_) delta[q_base + t] = acc;
    }
  }

  const int row0 = warp * 16 + grp;  // this thread's rows: row0, row0 + 8
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q_start + row0 + 8 * r;
    lse2[r] = t < T_ ? lse[q_base + t] * LOG2E : 0.f;
  }
  float dqacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    dqacc[n][0] = dqacc[n][1] = dqacc[n][2] = dqacc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = k_begin + it * BK;
    bf16* kst = ks + st * ELEMS;
    bf16* vst = vs + st * ELEMS;
    if (it + 1 < n_tiles) {
      port::tile_load_async<HD, DQ_THREADS>(ks + (st ^ 1) * ELEMS,
                                            k + kv_base * HD, k0 + BK, S);
      port::tile_load_async<HD, DQ_THREADS>(vs + (st ^ 1) * ELEMS,
                                            v + kv_base * HD, k0 + BK, S);
      port::cp_async_commit();
      port::cp_async_wait<1>();
    } else {
      port::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      dl[0] = dls[row0];
      dl[1] = dls[row0 + 8];
    }

    // s = q k^T and dp = do v^T: 16 rows x 64 keys a warp
    float sacc[8][4], pacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = pacc[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t aq[4], ad[4];
      const int a_off = (warp * 16 + (lane & 15)) * LD + kc * 16 +
                        (lane >> 4) * 8;
      port::ldsm_x4(aq, qs + a_off);
      port::ldsm_x4(ad, dos + a_off);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kc * 16 + ((lane >> 3) & 1) * 8;
        port::ldsm_x4(bk, kst + b_off);
        port::ldsm_x4(bv, vst + b_off);
        port::mma_bf16(sacc[2 * np], aq, bk[0], bk[1]);
        port::mma_bf16(sacc[2 * np + 1], aq, bk[2], bk[3]);
        port::mma_bf16(pacc[2 * np], ad, bv[0], bv[1]);
        port::mma_bf16(pacc[2 * np + 1], ad, bv[2], bv[3]);
      }
    }

    // p = exp(s scale - lse), ds = p (dp - delta); ds replaces s
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q_start) ||
                      (window > 0 && k0 <= q_last - window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(sacc[n][e], sl2, -lse2[e >> 1]));
        if (edge && !visible(q_start + row0 + (e >> 1) * 8,
                                  k0 + n * 8 + 2 * tq + (e & 1), T_, S,
                                  causal, window))
          p = 0.f;
        sacc[n][e] = p * (pacc[n][e] - dl[e >> 1]);
      }

    // dq += ds k: ds (bf16) is the A operand straight from the registers
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t a[4] = {
          port::pack_bf16(sacc[2 * kc][0], sacc[2 * kc][1]),
          port::pack_bf16(sacc[2 * kc][2], sacc[2 * kc][3]),
          port::pack_bf16(sacc[2 * kc + 1][0], sacc[2 * kc + 1][1]),
          port::pack_bf16(sacc[2 * kc + 1][2], sacc[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        port::ldsm_x4_trans(
            bk, kst + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    np * 16 + (lane >> 4) * 8);
        port::mma_bf16(dqacc[2 * np], a, bk[0], bk[1]);
        port::mma_bf16(dqacc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // stage st is read; the copy of tile it + 2 may land
  }
  port::cp_async_wait<0>();
  __syncthreads();

  // epilogue: dq * scale staged in f32 through the q and do tiles (no
  // longer read), this warp's 16 rows at a stride of HP + 4 floats; then,
  // the accumulators dead, each lane rotates column pairs (c, c + HD/2)
  // of a row back by -pos (RoPE) and stores them as bf16
  constexpr int FLD = HP + 4;
  static_assert(BQ * FLD * sizeof(float) <= 2 * port::Tile<HP>::BYTES,
                "the f32 dq tile fits in the q and do tiles");
  float* dqs = reinterpret_cast<float*>(qs);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * tq;
    *reinterpret_cast<float2*>(dqs + row0 * FLD + c) =
        make_float2(dqacc[n][0] * scale, dqacc[n][1] * scale);
    *reinterpret_cast<float2*>(dqs + (row0 + 8) * FLD + c) =
        make_float2(dqacc[n][2] * scale, dqacc[n][3] * scale);
  }
  __syncwarp();
  store_pair_rows<HD, ROPE>(dqs, FLD, warp * 16, 16, lane, 32, q_start, T_,
                            dq, q_base, posb, log_theta);
}

// dk and dv of one key block, summed over its GQA group in a fixed order.
// With ROPE, q and k are the rotated operands and dk is rotated back.
template <int HD, bool ROPE>
__global__ void __launch_bounds__(DKV_THREADS)
    flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              const float* __restrict__ pos, int B, int H,
                              int KV, int T_, int S, int causal, int window,
                              float scale, float log_theta) {
  constexpr int HP = port::padded_width<HD>();  // tile width
  constexpr int LD = port::Tile<HP>::LD;
  constexpr int ELEMS = port::Tile<HP>::ELEMS;
  constexpr int KC = HP / 16;  // k steps of k q^T and v do^T
  constexpr int NT = HP / 8;   // n tiles of dk, dv
  constexpr int NW = NT / 2;   // n tiles a warp holds: its half of HP
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + ELEMS;
  bf16* qs = vs + ELEMS;       // 2 stages
  bf16* dos = qs + 2 * ELEMS;  // 2 stages
  bf16* ps = dos + 2 * ELEMS;  // p^T, 64 keys x 64 queries
  bf16* dss = ps + BK * PLD;   // ds^T
  float* lses = reinterpret_cast<float*>(dss + BK * PLD);  // 2 stages
  float* dls = lses + 2 * BQ;                              // 2 stages

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tq = lane & 3;
  const int kg = warp & 3;   // 16-key group of the warp
  const int ch = warp >> 2;  // its half of the queries (s^T), of HD (dk, dv)
  // the key-block rank is the slowest grid index: under causal key block 0
  // sees the most queries, and all key blocks 0 are issued first
  const int rank = blockIdx.x / (KV * B), rem = blockIdx.x % (KV * B);
  const int kvh = rem % KV, b = rem / KV;
  const int k_start = rank * BK;
  const int G = H / KV;
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S;
  const float* posb = ROPE ? pos + static_cast<size_t>(b) * T_ : nullptr;

  // the queries any key of this block is visible to
  const int k_last = min(k_start + BK, S) - 1;
  const int q_lo = causal ? k_start : 0;
  int q_hi = T_;
  if (window > 0) q_hi = min(q_hi, k_last + window);
  const int q_begin = (q_lo / BQ) * BQ;
  const int nq = q_hi > q_begin ? (q_hi - q_begin + BQ - 1) / BQ : 0;
  const int n_it = G * nq;  // (head of the group, q block), heads outer

  auto load_q = [&](int it, int st) {
    const int q0 = q_begin + (it % nq) * BQ;
    const size_t q_base =
        (static_cast<size_t>(b) * H + kvh * G + it / nq) * T_;
    port::tile_load_async<HD, DKV_THREADS>(qs + st * ELEMS, q + q_base * HD,
                                           q0, T_);
    port::tile_load_async<HD, DKV_THREADS>(dos + st * ELEMS,
                                           dout + q_base * HD, q0, T_);
    if (tid < 2 * BQ) {  // lse (threads 0-63) and delta (64-127), 4 bytes
      const int i = tid % BQ, t = q0 + i;
      const bool ok = t < T_;
      const float* src = (tid < BQ ? lse : delta) + q_base + (ok ? t : 0);
      port::cp_async4((tid < BQ ? lses : dls) + st * BQ + i, src, ok);
    }
  };
  port::tile_load_async<HD, DKV_THREADS>(ks, k + kv_base * HD, k_start, S);
  port::tile_load_async<HD, DKV_THREADS>(vs, v + kv_base * HD, k_start, S);
  if (n_it > 0) load_q(0, 0);
  port::cp_async_commit();

  const float sl2 = scale * LOG2E;
  float dkacc[NW][4], dvacc[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[n][e] = dvacc[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int q0 = q_begin + (it % nq) * BQ;
    bf16* qst = qs + st * ELEMS;
    bf16* dost = dos + st * ELEMS;
    const float* lst = lses + st * BQ;
    const float* dlst = dls + st * BQ;
    if (it + 1 < n_it) {
      load_q(it + 1, st ^ 1);
      port::cp_async_commit();
      port::cp_async_wait<1>();
    } else {
      port::cp_async_wait<0>();
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T: 16 keys x 32 queries a warp
    float sacc[4][4], pacc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = pacc[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ak[4], av[4];
      const int a_off = (kg * 16 + (lane & 15)) * LD + kc * 16 +
                        (lane >> 4) * 8;
      port::ldsm_x4(ak, ks + a_off);
      port::ldsm_x4(av, vs + a_off);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4], bd[4];
        const int b_off =
            (ch * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
            kc * 16 + ((lane >> 3) & 1) * 8;
        port::ldsm_x4(bq, qst + b_off);
        port::ldsm_x4(bd, dost + b_off);
        port::mma_bf16(sacc[2 * np], ak, bq[0], bq[1]);
        port::mma_bf16(sacc[2 * np + 1], ak, bq[2], bq[3]);
        port::mma_bf16(pacc[2 * np], av, bd[0], bd[1]);
        port::mma_bf16(pacc[2 * np + 1], av, bd[2], bd[3]);
      }
    }

    // p^T and ds^T, rounded to bf16 into shared memory
    const bool edge = q0 + BQ > T_ || k_start + BK > S ||
                      (causal && q0 < k_start + BK - 1) ||
                      (window > 0 && k_start <= q0 + BQ - 1 - window);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = ch * 32 + n * 8 + 2 * tq + (e & 1);
        float p = exp2f(fmaf(sacc[n][e], sl2, -lst[ql] * LOG2E));
        if (edge && !visible(q0 + ql, k_start + kg * 16 + grp +
                                               (e >> 1) * 8,
                                  T_, S, causal, window))
          p = 0.f;
        sacc[n][e] = p;
        pacc[n][e] = p * (pacc[n][e] - dlst[ql]);
      }
      const int r = kg * 16 + grp, c = ch * 32 + n * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(ps + r * PLD + c) =
          port::pack_bf16(sacc[n][0], sacc[n][1]);
      *reinterpret_cast<uint32_t*>(ps + (r + 8) * PLD + c) =
          port::pack_bf16(sacc[n][2], sacc[n][3]);
      *reinterpret_cast<uint32_t*>(dss + r * PLD + c) =
          port::pack_bf16(pacc[n][0], pacc[n][1]);
      *reinterpret_cast<uint32_t*>(dss + (r + 8) * PLD + c) =
          port::pack_bf16(pacc[n][2], pacc[n][3]);
    }
    __syncthreads();

    // dv += p^T do and dk += ds^T q over the 64 queries: the warp's 16 keys
    // x the n tiles of its half of the columns, ch * NW + j
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ap[4], ad[4];
      const int a_off = (kg * 16 + (lane & 15)) * PLD + kc * 16 +
                        (lane >> 4) * 8;
      port::ldsm_x4(ap, ps + a_off);
      port::ldsm_x4(ad, dss + a_off);
      const int b_row = (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD;
#pragma unroll
      for (int j = 0; j < NW; j += 2) {
        const int col = (ch * NW + j) * 8 + (lane >> 4) * 8;
        uint32_t bd[4], bq[4];
        port::ldsm_x4_trans(bd, dost + b_row + col);
        port::ldsm_x4_trans(bq, qst + b_row + col);
        port::mma_bf16(dvacc[j], ap, bd[0], bd[1]);
        port::mma_bf16(dvacc[j + 1], ap, bd[2], bd[3]);
        port::mma_bf16(dkacc[j], ad, bq[0], bq[1]);
        port::mma_bf16(dkacc[j + 1], ad, bq[2], bq[3]);
      }
    }
    __syncthreads();  // p^T, ds^T and stage st are read
  }
  port::cp_async_wait<0>();
  __syncthreads();

  // epilogue: dk * scale and dv staged in f32 through the q and do stages
  // (no longer read) at a stride of HP + 4 floats; then each thread takes
  // column pairs (c, c + HD/2) of a key row, rotates dk's back by -pos
  // (RoPE) and stores both as bf16
  constexpr int FLD = HP + 4;
  static_assert(2 * BK * FLD * sizeof(float) <= 4 * port::Tile<HP>::BYTES,
                "the f32 dk and dv tiles fit in the q and do stages");
  float* dks = reinterpret_cast<float*>(qs);
  float* dvs = dks + BK * FLD;
  const int r = kg * 16 + grp;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int c = (ch * NW + j) * 8 + 2 * tq;
    *reinterpret_cast<float2*>(dks + r * FLD + c) =
        make_float2(dkacc[j][0] * scale, dkacc[j][1] * scale);
    *reinterpret_cast<float2*>(dks + (r + 8) * FLD + c) =
        make_float2(dkacc[j][2] * scale, dkacc[j][3] * scale);
    *reinterpret_cast<float2*>(dvs + r * FLD + c) =
        make_float2(dvacc[j][0], dvacc[j][1]);
    *reinterpret_cast<float2*>(dvs + (r + 8) * FLD + c) =
        make_float2(dvacc[j][2], dvacc[j][3]);
  }
  __syncthreads();
  store_pair_rows<HD, ROPE>(dks, FLD, 0, BK, tid, DKV_THREADS, k_start, S,
                            dk, kv_base, posb, log_theta);
  store_pair_rows<HD, false>(dvs, FLD, 0, BK, tid, DKV_THREADS, k_start, S,
                             dv, kv_base, nullptr, 0.f);
}

// ---------------------------------------------------------------------------
// launches: f32 -> the FMA bodies (three kernels), bf16 -> the tensor-core
// bodies (two kernels); with RoPE the rotation pass first
// ---------------------------------------------------------------------------

constexpr int ROPE_THREADS = 256;

// q and k rotated by pos into the scratch qr, kr (the RoPE backward's first
// kernel; the bodies then read the rotated operands, the same values the
// forward's rotation pass made).
template <typename T, int HD>
__global__ void __launch_bounds__(ROPE_THREADS)
    flash_bwd_rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  flash_bwd_rope_kernel<T, HD>
      <<<static_cast<unsigned>(blocks), ROPE_THREADS, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), qr,
          qr + static_cast<size_t>(B) * H * T_ * HD, pos, B, H, KV, T_,
          log_theta);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool ROPE>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* delta, const float* pos, int B, int H,
               int KV, int T_, int S, int causal, int window, float scale,
               float log_theta, cudaStream_t stream) {
  using T = float;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const size_t rows = static_cast<size_t>(B) * H * T_;
  const size_t nblk = (rows + ROW_WARPS - 1) / ROW_WARPS;
  if (nblk > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_delta_kernel<T, HD>
      <<<static_cast<unsigned>(nblk), ROW_WARPS * 32, 0, stream>>>(
          static_cast<const T*>(o), dot, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t smem = smem_bytes<HD>();
  auto dkv_kernel = flash_bwd_dkv_kernel<T, HD, ROPE>;
  auto dq_kernel = flash_bwd_dq_kernel<T, HD, ROPE>;
  err = cudaFuncSetAttribute(dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  dkv_kernel<<<dim3((S + BK - 1) / BK, KV, B), THREADS, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      pos, H, KV, T_, S, causal, window, scale, log_theta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<dim3((T_ + BQ - 1) / BQ, H, B), THREADS, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), pos, H, KV, T_, S,
      causal, window, scale, log_theta);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool ROPE>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* dout, void* dq, void* dk,
                void* dv, float* delta, const float* pos, int B, int H,
                int KV, int T_, int S, int causal, int window, float scale,
                float log_theta, cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  auto dq_kernel = flash_bwd_dq_bf16_kernel<HD, ROPE>;
  auto dkv_kernel = flash_bwd_dkv_bf16_kernel<HD, ROPE>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem_bytes<HD>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkv_smem_bytes<HD>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long dq_blocks =
      static_cast<long long>((T_ + BQ - 1) / BQ) * H * B;
  const long long dkv_blocks =
      static_cast<long long>((S + BK - 1) / BK) * KV * B;
  if (dq_blocks > 0x7fffffffLL || dkv_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  dq_kernel<<<static_cast<unsigned>(dq_blocks), DQ_THREADS,
              dq_smem_bytes<HD>(), stream>>>(
      qt, kt, vt, static_cast<const bf16*>(o), dot, lse, delta,
      static_cast<bf16*>(dq), pos, B, H, KV, T_, S, causal, window, scale,
      log_theta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<static_cast<unsigned>(dkv_blocks), DKV_THREADS,
               dkv_smem_bytes<HD>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), pos, B, H, KV, T_, S, causal, window, scale,
      log_theta);
  return static_cast<int>(cudaGetLastError());
}

// With ROPE: q and k rotated into rot (qr then kr) first; the bodies run on
// the rotated operands and rotate dq, dk back in their epilogues.
template <int HD, bool ROPE>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* o, const float* lse, const void* dout, void* dq,
           void* dk, void* dv, float* delta, const float* pos, void* rot,
           int B, int H, int KV, int T_, int S, int causal, int window,
           float scale, float log_theta, cudaStream_t stream) {
  if (dtype != port::kF32 && dtype != port::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (ROPE) {
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
    return launch_f32<HD, ROPE>(q, k, v, o, lse, dout, dq, dk, dv, delta, pos,
                                B, H, KV, T_, S, causal, window, scale,
                                log_theta, stream);
  return launch_bf16<HD, ROPE>(q, k, v, o, lse, dout, dq, dk, dv, delta, pos,
                               B, H, KV, T_, S, causal, window, scale,
                               log_theta, stream);
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              const void* o, const float* lse, const void* dout, void* dq,
              void* dk, void* dv, float* delta, const float* pos, void* rot,
              int B, int H, int KV, int T_, int S, int causal, int window,
              float scale, float log_theta, cudaStream_t stream) {
  if (pos != nullptr)
    return launch<HD, true>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta,
                            pos, rot, B, H, KV, T_, S, causal, window, scale,
                            log_theta, stream);
  return launch<HD, false>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta,
                           pos, rot, B, H, KV, T_, S, causal, window, scale,
                           log_theta, stream);
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, H, T, hd); k, v, dk, dv (B, KV, S, hd); all of
// `dtype`, contiguous. lse (B, H, T) f32; delta (B, H, T) f32 scratch.
// pos (B, T) f32 positions or null: with pos (RoPE attention, S == T) q and
// k are the UNROTATED inputs, rotated inside, and dq, dk are returned for
// them; log_theta = log(rope_theta); for bf16 `rot` is scratch of
// B * (H + KV) * T * hd bf16 for the rotated q and k. window <= 0 means no
// window. hd is 32, 64, 112, 120 or 128.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const float* lse, const void* dout,
                        void* dq, void* dk, void* dv, float* delta,
                        const float* pos, void* rot, int B, int H, int KV,
                        int T_, int S, int hd, int causal, int window,
                        float scale, float log_theta, int dtype,
                        cudaStream_t stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || T_ < 1 || S < 1 ||
      B > 65535 || H > 65535 || (pos != nullptr && S != T_))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch_hd<32>(dtype, q, k, v, o, lse, dout, dq, dk, dv,
                           delta, pos, rot, B, H, KV, T_, S, causal,
                           window, scale, log_theta, stream);
    case 64:
      return launch_hd<64>(dtype, q, k, v, o, lse, dout, dq, dk, dv,
                           delta, pos, rot, B, H, KV, T_, S, causal,
                           window, scale, log_theta, stream);
    case 112:
      return launch_hd<112>(dtype, q, k, v, o, lse, dout, dq, dk, dv,
                            delta, pos, rot, B, H, KV, T_, S, causal,
                            window, scale, log_theta, stream);
    case 120:
      return launch_hd<120>(dtype, q, k, v, o, lse, dout, dq, dk, dv,
                            delta, pos, rot, B, H, KV, T_, S, causal,
                            window, scale, log_theta, stream);
    case 128:
      return launch_hd<128>(dtype, q, k, v, o, lse, dout, dq, dk, dv,
                            delta, pos, rot, B, H, KV, T_, S, causal,
                            window, scale, log_theta, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
