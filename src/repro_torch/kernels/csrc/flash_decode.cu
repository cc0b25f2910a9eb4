// Flash decode: one query row per sequence against a head-major KV cache,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:
//   flash_decode_pallas (_flash_decode_kernel, with _slot_visibility)
//
// q: (B, H, HD); k, v: (B, KV, S, HD), f32 or bf16. pos: each row's query
// position, a scalar or a per-row (B,) int32 array read on the device.
// Slot s holds global position gp = s, or gp = pos - ((pos - s) mod S) for
// a ring buffer; it is visible iff 0 <= gp <= pos, gp > pos - window
// (window > 0) and gp >= offsets[b] (left pad). With rope, q is rotated
// in-kernel by pos - offsets[b] (half-split RoPE, freq_i =
// exp(-(i / (HD/2)) * log(theta)), as _rope_rotate of the Pallas kernels);
// the cached keys were rotated when they were written. A row that sees no
// slot is written as the mean of V over the S slots.
//
// What bounds it: per step it must read the visible part of the cache,
// 2 * KV * (pos + 1) * HD elements per row, for 4 FLOPs per element per
// query head: bytes (at B = 8, KV = 8, S = 544, HD = 128 in bf16, 18 MB).
//
// Design: the split-KV body of flash_decode.cuh, where a chunk (32
// consecutive slots of a bf16 row of 128) is one contiguous run of each of
// k and v. A cluster of 8 blocks per (kv head, row) -- a grid of (8, KV,
// B), 512 blocks at B = 8, KV = 8 -- streams the visible chunks with
// 16-byte cp.async copies, two chunks in flight a block; the blocks store
// their partial softmaxes into rank 0's shared memory, which merges them
// in rank order. Chunks outside [offset, pos] (or outside the window) are
// never touched unless the cache is a ring, whose slot order is not
// monotone in position (a ring's hidden slots are zero-filled, not read).

#include "flash_decode.cuh"

namespace {

using port::decode::Chunk;
using port::decode::CL;
using port::decode::ContiguousSlots;
using port::decode::MAX_GHD;
using port::decode::Smem;
using port::decode::THREADS;

template <typename T, int HD, int G>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        const int* __restrict__ pos_rows, int pos_scalar,
                        const int* __restrict__ offsets, int H, int KV, int S,
                        int window, int ring, int rope, float log_theta,
                        float scale) {
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int pos = pos_rows != nullptr ? pos_rows[b] : pos_scalar;
  const int off = offsets != nullptr ? offsets[b] : 0;
  const ContiguousSlots<T> slots{k, v,
                                 (static_cast<size_t>(b) * KV + kvh) * S};
  port::decode::decode_cluster<T, T, HD, G>(q, o, slots, b, kvh, pos, off, H,
                                            S, window, ring, rope, log_theta,
                                            scale);
}

template <typename T, int HD, int G>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* pos_rows, int pos_scalar, const int* offsets, int B,
           int H, int KV, int S, int window, int ring, int rope,
           float log_theta, float scale, cudaStream_t stream) {
  if constexpr (G * HD > MAX_GHD) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr size_t smem = Smem<HD, sizeof(T), G, false, false>::BYTES;
    const auto kernel = flash_decode_kernel<T, HD, G>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(CL, KV, B);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), pos_rows, pos_scalar,
        offsets, H, KV, S, window, ring, rope, log_theta, scale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int HD>
int dispatch_g(int g, const void* q, const void* k, const void* v, void* o,
               const int* pos_rows, int pos_scalar, const int* offsets, int B,
               int H, int KV, int S, int window, int ring, int rope,
               float log_theta, float scale, cudaStream_t stream) {
#define PORT_DECODE_G(GV)                                                    \
  case GV:                                                                   \
    return launch<T, HD, GV>(q, k, v, o, pos_rows, pos_scalar, offsets, B,  \
                             H, KV, S, window, ring, rope, log_theta, scale, \
                             stream);
  switch (g) {
    PORT_DECODE_G(1)
    PORT_DECODE_G(2)
    PORT_DECODE_G(4)
    PORT_DECODE_G(8)
    PORT_DECODE_G(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PORT_DECODE_G
}

template <typename T>
int dispatch_hd(int hd, int g, const void* q, const void* k, const void* v,
                void* o, const int* pos_rows, int pos_scalar,
                const int* offsets, int B, int H, int KV, int S, int window,
                int ring, int rope, float log_theta, float scale,
                cudaStream_t stream) {
#define PORT_DECODE_HD(HV)                                                  \
  case HV:                                                                  \
    return dispatch_g<T, HV>(g, q, k, v, o, pos_rows, pos_scalar, offsets, \
                             B, H, KV, S, window, ring, rope, log_theta,   \
                             scale, stream);
  switch (hd) {
    PORT_DECODE_HD(32)
    PORT_DECODE_HD(64)
    PORT_DECODE_HD(112)
    PORT_DECODE_HD(120)
    PORT_DECODE_HD(128)
    PORT_DECODE_HD(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PORT_DECODE_HD
}

template <int HD>
int chunk_slots(int esize) {
  switch (esize) {
    case 1: return Chunk<HD, 1>::SLOTS;
    case 2: return Chunk<HD, 2>::SLOTS;
    case 4: return Chunk<HD, 4>::SLOTS;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Slots of the kernels' chunk for rows of hd elements of esize bytes (the
// wrapper's chunk_slots asks here); 0 for a width they do not take.
int flash_decode_chunk_slots(int hd, int esize) {
  switch (hd) {
    case 32: return chunk_slots<32>(esize);
    case 64: return chunk_slots<64>(esize);
    case 112: return chunk_slots<112>(esize);
    case 120: return chunk_slots<120>(esize);
    case 128: return chunk_slots<128>(esize);
    case 256: return chunk_slots<256>(esize);
    default: return 0;
  }
}

// q (B, H, hd); k, v (B, KV, S, hd); o like q; all of `dtype`, contiguous.
// pos_rows (B,) int32 or null (then every row is at pos_scalar); offsets
// (B,) int32 or null. window <= 0 means none. hd is 32, 64, 112, 120, 128
// or 256;
// H / KV is 1, 2, 4, 8 or 16 with (H / KV) * hd <= 1024.
int flash_decode_fwd(const void* q, const void* k, const void* v, void* o,
                     const int* pos_rows, int pos_scalar, const int* offsets,
                     int B, int H, int KV, int S, int hd, int window, int ring,
                     int rope, float log_theta, float scale, int dtype,
                     cudaStream_t stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || S < 1 || B > 65535 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = H / KV;
  if (dtype == port::kF32)
    return dispatch_hd<float>(hd, g, q, k, v, o, pos_rows, pos_scalar, offsets,
                              B, H, KV, S, window, ring, rope, log_theta,
                              scale, stream);
  if (dtype == port::kBF16)
    return dispatch_hd<__nv_bfloat16>(hd, g, q, k, v, o, pos_rows, pos_scalar,
                                      offsets, B, H, KV, S, window, ring, rope,
                                      log_theta, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
