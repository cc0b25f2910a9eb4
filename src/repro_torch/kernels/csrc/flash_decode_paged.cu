// Paged flash decode: one query row per sequence against a page pool
// reached through per-row block tables, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:
//   flash_decode_paged_pallas (_flash_decode_paged_kernel)
//
// q: (B, H, HD), f32 or bf16. kp, vp: (pages, KV, ps, HD) of q's dtype, or
// int8 codes with ks, vs (pages, KV, ps) f32 per-slot scales (an int8 pool
// dequantizes at the load: k = code * scale, in f32). pt: (B, NB) int32;
// row b's logical slot s lives at kp[pt[b, s / ps], kvh, s % ps]. pos (per
// row on the device, or one scalar) and offsets as in flash_decode.cu; a
// logical slot s is visible iff s <= pos, s > pos - window (window > 0)
// and s >= offsets[b]. With rope, q is rotated in-kernel by pos -
// offsets[b]. The output is in q's dtype; a row that sees no slot is the
// mean of V over the NB * ps logical slots.
// Every pt entry a visible slot reaches (every entry of a row that sees no
// slot) must lie in [0, pages): the caller's contract (the wrapper cannot
// check it without a host sync).
//
// What bounds it: per step it must read the visible slots of every row,
// 2 * KV * visible * HD elements (plus 2 * KV * visible f32 scales for
// int8), for 4 FLOPs per element per query head: bytes.
//
// Design: the split-KV body of flash_decode.cuh with a slot source that
// reads a chunk's block-table entries once, before the chunk's copies (one
// entry a thread, loaded a chunk ahead), and copies each visible slot's
// HD-element key and value rows from their pages as 16-byte cp.async
// copies (an int8 row is 16 codes a copy; the f32 scales of 4 slots of
// one page arrive as one 16-byte copy when the page size is a multiple of
// 4, else as 4-byte copies a slot). A cluster of 8 blocks per (kv head, row) -- a grid of
// (8, KV, B), 1,024 blocks for the engine's 16 rows and 8 kv heads -- two
// chunks in flight a block; the blocks store their partials into rank 0's
// shared memory, which merges them in rank order. Slots past pos are never
// read, so block-table entries past pos (the trash page 0 of the serving
// engine) cost nothing. Chunks, their map to ranks and the merge order are
// the contiguous kernel's, so on the same cache contents the output equals
// flash_decode.cu's bit for bit.

#include "flash_decode.cuh"

namespace {

using port::decode::CL;
using port::decode::MAX_GHD;
using port::decode::PagedSlots;
using port::decode::Smem;
using port::decode::THREADS;

template <typename Q, typename T, int HD, int G>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
    flash_decode_paged_kernel(const Q* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const int* __restrict__ pt, Q* __restrict__ o,
                              const int* __restrict__ pos_rows, int pos_scalar,
                              const int* __restrict__ offsets, int H, int KV,
                              int NB, int ps, int window, int rope,
                              float log_theta, float scale) {
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int pos = pos_rows != nullptr ? pos_rows[b] : pos_scalar;
  const int off = offsets != nullptr ? offsets[b] : 0;
  const bool wide_scales =
      port::decode::kScaleCopy == 16 && ps % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(ks) | reinterpret_cast<uintptr_t>(vs)) &
       15) == 0;
  const PagedSlots<T> slots{k, v, ks, vs, pt + static_cast<size_t>(b) * NB,
                            KV, kvh, ps, wide_scales};
  port::decode::decode_cluster<Q, T, HD, G>(q, o, slots, b, kvh, pos, off, H,
                                            NB * ps, window, /*ring=*/0, rope,
                                            log_theta, scale);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pt;
  void* o;
  const int* pos_rows;
  int pos_scalar;
  const int* offsets;
  int B, H, KV, NB, ps, window, rope;
  float log_theta, scale;
  cudaStream_t stream;
};

template <typename Q, typename T, int HD, int G>
int launch(const Args& a) {
  if constexpr (G * HD > MAX_GHD) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr size_t smem =
        Smem<HD, sizeof(T), G, sizeof(T) == 1, true>::BYTES;
    const auto kernel = flash_decode_paged_kernel<Q, T, HD, G>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(CL, a.KV, a.B);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        static_cast<const Q*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.ks, a.vs, a.pt, static_cast<Q*>(a.o),
        a.pos_rows, a.pos_scalar, a.offsets, a.H, a.KV, a.NB, a.ps,
        a.window, a.rope, a.log_theta, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename Q, typename T, int HD>
int dispatch_g(int g, const Args& a) {
  switch (g) {
    case 1: return launch<Q, T, HD, 1>(a);
    case 2: return launch<Q, T, HD, 2>(a);
    case 4: return launch<Q, T, HD, 4>(a);
    case 8: return launch<Q, T, HD, 8>(a);
    case 16: return launch<Q, T, HD, 16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Q, typename T>
int dispatch_hd(int hd, int g, const Args& a) {
  switch (hd) {
    case 32: return dispatch_g<Q, T, 32>(g, a);
    case 64: return dispatch_g<Q, T, 64>(g, a);
    case 112: return dispatch_g<Q, T, 112>(g, a);
    case 120: return dispatch_g<Q, T, 120>(g, a);
    case 128: return dispatch_g<Q, T, 128>(g, a);
    case 256: return dispatch_g<Q, T, 256>(g, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B, H, hd) of `dtype`; kp, vp (pages, KV, ps, hd) of `dtype`, or int8
// when kv_int8 (then ks, vs (pages, KV, ps) f32, else null); pt (B, NB)
// int32; o like q; all contiguous. pos_rows (B,) int32 or null (then every
// row is at pos_scalar); offsets (B,) int32 or null. window <= 0 means
// none. hd is 32, 64, 112, 120, 128 or 256; H / KV is 1, 2, 4, 8 or 16
// with (H / KV) * hd <= 1024.
int flash_decode_paged_fwd(const void* q, const void* kp, const void* vp,
                           const float* ks, const float* vs, const int* pt,
                           void* o, const int* pos_rows, int pos_scalar,
                           const int* offsets, int B, int H, int KV, int NB,
                           int ps, int hd, int window, int rope,
                           float log_theta, float scale, int dtype,
                           int kv_int8, cudaStream_t stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || NB < 1 || ps < 1 || B > 65535 ||
      KV > 65535 || (kv_int8 != 0) != (ks != nullptr && vs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kp, vp, ks, vs, pt, o, pos_rows, pos_scalar, offsets, B,
               H, KV, NB, ps, window, rope, log_theta, scale, stream};
  const int g = H / KV;
  if (dtype == port::kF32)
    return kv_int8 ? dispatch_hd<float, int8_t>(hd, g, a)
                   : dispatch_hd<float, float>(hd, g, a);
  if (dtype == port::kBF16)
    return kv_int8 ? dispatch_hd<__nv_bfloat16, int8_t>(hd, g, a)
                   : dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, g, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
