// Hopper (sm_90a) building blocks of the bf16 GEMM-shaped kernels (the
// SwiGLU pair): TMA loads of 2-D tiles into shared memory, completing on
// mbarriers; wgmma (m64n128k16, bf16 in, f32 accumulators) on 128-byte
// swizzled tiles; setmaxnreg; and one warp-specialised block that runs
// them as a pipeline. The GBN pair (gbn.cu) takes the mbarriers, 1-D bulk
// copies and the device-scope counters from here.
//
// The block (kThreads = 384, one an SM, persistent over output tiles):
// warpgroups 0 and 1 consume, each owning 64 of a tile's kBM = 128 rows;
// warpgroup 2 produces, and only its first thread works: it walks each
// tile's depth in stages of kBK = 64, and for each stage waits until the
// ring slot is free, then asks TMA for the stage's three 16 KB tiles (A:
// 128 rows x 64 deep; B0 and B1: 64 deep x 128 columns each), all
// completing on the slot's `full` barrier. A consumer waits on `full`,
// issues 4 x 2 wgmmas (A x B0 into acc0, A x B1 into acc1) as one group,
// and frees the slot of the stage before once that group has completed
// (one group stays in flight). kStages = 4 slots of 48 KB; the ring runs
// on across tiles, so the next tile's stages load during an epilogue.
// Every row is summed in the same order whatever the number of rows: the
// depth walk, the tile shapes and the instruction shape are constants.
//
// Shared tiles are in TMA's 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B):
// a box row of 64 bf16 (128 bytes) is 8 chunks of 16 bytes, and chunk c of
// row r lands at chunk c ^ (r % 8); rows are 128 bytes apart, so 8 rows
// make one 1024-byte swizzle atom. wgmma reads them through a descriptor
// (PTX ISA, "Matrix Descriptor"; canonical layouts in units of elements,
// T = 8 bf16 a 16-byte chunk):
//   K-major (the depth is contiguous: the rows of A, and B stored as
//     (columns, depth)): ((8, m), (T, 2k)) : ((8T, SBO), (1, T)); SBO is
//     the step between 8-row groups, 1024 bytes; LBO is unused. The k16
//     step kk starts 32 * kk bytes into the row.
//   MN-major (the columns are contiguous: B stored as (depth, columns), as
//     the (d, F) weights are; wgmma's imm-trans-b = 1):
//     ((T, 8, m), (8, k)) : ((1, T, LBO), (8T, SBO)); LBO is the step
//     between 64-column blocks (the two 8 KB boxes of a B tile, 8192
//     bytes), SBO the step between 8-deep groups (1024 bytes). The k16
//     step kk starts 16 rows, 2048 bytes, further.
// Every tile starts on a 1024-byte boundary, so the swizzle's phase is the
// row's and the descriptors' base offset is 0.
//
// Accumulators of m64nNk16 (f32, N / 2 a thread): warp w of the warpgroup
// holds rows 16w .. 16w + 15; lane l = 4 * q + t holds, for each 8-column
// chunk j, d[4j], d[4j + 1] at (row 16w + q, columns 8j + 2t, 8j + 2t + 1)
// and d[4j + 2], d[4j + 3] at row 16w + q + 8, the same columns.
//
// Host side: tensor maps are encoded for each call with
// cuTensorMapEncodeTiled, reached through the runtime's
// cudaGetDriverEntryPoint(ByVersion) (no link against libcuda), and passed
// to the kernel by value as __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace port {
namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;     // rows of a block: two consumer warpgroups
constexpr int kBK = 64;      // depth of a stage: one 128-byte swizzle row
constexpr int kBN = 128;     // columns of each of a stage's two B tiles
constexpr int kStages = 4;
constexpr int kTileElems = kBM * kBK;          // A, B0 and B1 alike
constexpr int kTileBytes = 2 * kTileElems;     // 16 KB
constexpr int kStageBytes = 3 * kTileBytes;    // the expected TMA bytes
constexpr int kThreads = 384;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;   // 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr size_t kSmemBytes =
    static_cast<size_t>(kStages) * kStageBytes + 2 * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives when `pred` holds: a predicated instruction, not a branch, so
// the wgmmas around it stay on a path the compiler sees as uniform.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

// Arrives and adds `bytes` to the transaction count of the current phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed. A barrier starts
// in phase 0, so parity 1 passes at once (the "previous" phase). A wait
// that lasts 2^35 clocks (~17 s) traps: a fault in the pipeline ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// The box of `map` at element coordinates (c0 = column, c1 = row) into
// shared memory at dst; its bytes complete on `bar`. Elements outside the
// tensor are written as zeros and read from nowhere.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes from global memory at src into shared memory at
// dst (both 16-byte aligned, bytes a multiple of 16); they complete on
// `bar`. A 1-D bulk copy: no tensor map, one instruction.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// device-scope counters: blocks of one grid waiting on each other (the
// grid must be co-resident: a cooperative launch)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Asks TMA to bring the box of `map` at (c0, c1) into L2, without waiting.
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int c0,
                                                int c1) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.2d.L2.global [%0, {%1, %2}];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (smem_addr(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// A K-major tile (rows of 64 deep): the k16 step kk of its first row `p`.
__device__ __forceinline__ uint64_t desc_k_major(const bf16* p, int kk) {
  return wgmma_desc(p + 16 * kk, 16, 1024);
}

// An MN-major B tile (two 64 deep x 64 column boxes): the k16 step kk.
__device__ __forceinline__ uint64_t desc_mn_major(const bf16* p, int kk) {
  return wgmma_desc(p + 16 * kk * 64, 2 * 64 * 64, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of the warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, f32) += A (64 x 16, K-major) x B (16 x 128); B is MN-major
// when kTransB (imm-trans-b = 1), K-major otherwise.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// The warp-specialised block
// ---------------------------------------------------------------------------

// The tile (row block, column block) numbered t of m_blocks x n_blocks
// tiles, grouped kGroupM row blocks at a time: the tiles in flight together
// share a few row blocks of A and a few column blocks of B, which stay in
// L2 (in row-major order they would span every column block of B, and B
// would be read from memory again for every two or three row blocks).
// Which block computes a tile changes no sum.
constexpr int kGroupM = 8;
__device__ __forceinline__ void tile_of(int t, int m_blocks, int n_blocks,
                                        int& mb, int& nb) {
  const int group = kGroupM * n_blocks;
  const int first = (t / group) * kGroupM;
  const int rows = min(m_blocks - first, kGroupM);
  mb = first + (t % group) % rows;
  nb = (t % group) / rows;
}

// Where accumulator element e of a consumer thread lies in its
// warpgroup's 64 x 128 tile (the layout above): row and (even) column.
__device__ __forceinline__ int acc_row(int e) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  return 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
}
__device__ __forceinline__ int acc_col(int e) {
  return 8 * (e / 4) + 2 * (threadIdx.x % 4);
}

// Transposes 4 x 4 words across a quad (lanes 4q .. 4q + 3, t = lane % 4):
// w[j] of lane t becomes w[t] of lane j. With w[j] the word of accumulator
// chunk 4m + j (columns 8 (4m + j) + 2t, + 1, packed), lane t ends with the
// four words of chunk 4m + t in column order: 16 bytes it can store at
// once. Its own inverse: 16 bytes loaded by lane t from chunk 4m + t end as
// the words of the accumulator layout.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j & m) continue;
      const bool hi = (t & m) != 0;
      const uint32_t got =
          __shfl_xor_sync(0xffffffffu, hi ? w[j] : w[j | m], m);
      if (hi) {
        w[j] = got;
      } else {
        w[j | m] = got;
      }
    }
  }
}

// One stage's products of a consumer warpgroup: its 64 rows of A against
// B0 and B1.
template <bool kMN>
__device__ __forceinline__ void mma_stage(float (&acc0)[64],
                                          float (&acc1)[64], const bf16* a,
                                          const bf16* b0, const bf16* b1) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t da = desc_k_major(a, kk);
    const uint64_t d0 = kMN ? desc_mn_major(b0, kk) : desc_k_major(b0, kk);
    const uint64_t d1 = kMN ? desc_mn_major(b1, kk) : desc_k_major(b1, kk);
    wgmma_m64n128k16<kMN ? 1 : 0>(acc0, da, d0);
    wgmma_m64n128k16<kMN ? 1 : 0>(acc1, da, d1);
  }
}

// The persistent block: it walks the output tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... (tile_of's order) of a problem P with
//   p.m_blocks x p.n_blocks tiles of kBM rows and P::kCols columns, p.n
//     rows in all, each p.ktiles stages deep;
//   p.load(m0, n0, i, a, b0, b1, bar): stage i's TMA loads of the tile at
//     (m0, n0) into the three tiles, kStageBytes in all, completing on bar
//     (run by the producer's one thread);
//   p.epilogue(m0, n0, wg, acc0, acc1): a consumer warpgroup's results
//     (rows m0 + 64 wg .. m0 + 64 wg + 63);
//   p.prefetch(m0, n0): issued by the producer halfway through the tile's
//     stages, for what the epilogue will read (into L2).
// The producer runs ahead across tiles, so the next tile's first stages
// arrive while the consumers run the epilogue. A warpgroup whose 64 rows
// all lie past p.n takes part in the pipeline but issues no products and
// calls no epilogue. B tiles are MN-major when kMN, else K-major.
template <bool kMN, class P>
__device__ __forceinline__ void gemm_persistent(const P& p) {
  extern __shared__ __align__(1024) uint8_t hopper_smem[];
  uint8_t* base =
      hopper_smem + ((1024 - (smem_addr(hopper_smem) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  auto tile = [base](int s, int which) {
    return reinterpret_cast<bf16*>(base + s * kStageBytes +
                                   which * kTileBytes);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int tiles = p.m_blocks * p.n_blocks;
  // the warpgroup, broadcast from lane 0 so that the compiler knows it is
  // the same across the warp (wgmma on a path it cannot prove uniform is
  // serialised)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      int it = 0;   // stages loaded so far: slot it % kStages
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mb, nb;
        tile_of(t, p.m_blocks, p.n_blocks, mb, nb);
        for (int i = 0; i < p.ktiles; ++i, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          p.load(mb * kBM, nb * P::kCols, i, tile(s, 0), tile(s, 1),
                 tile(s, 2), &full[s]);
          if (i == p.ktiles / 2) p.prefetch(mb * kBM, nb * P::kCols);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const bool lane0 = threadIdx.x % 32 == 0;
    float acc0[64], acc1[64];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mb, nb;
      tile_of(t, p.m_blocks, p.n_blocks, mb, nb);
      const bool active = p.n > mb * kBM + 64 * wg;
#pragma unroll
      for (int e = 0; e < 64; ++e) acc0[e] = acc1[e] = 0.f;
      for (int i = 0; i < p.ktiles; ++i, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        if (active) {
          wgmma_fence();
          mma_stage<kMN>(acc0, acc1, tile(s, 0) + 64 * kBK * wg, tile(s, 1),
                         tile(s, 2));
          wgmma_commit();
          wgmma_wait<1>();   // the stage before is read: free its slot
        }
        if (i > 0) mbar_arrive_if(&empty[(it - 1) % kStages], lane0);
      }
      if (active) wgmma_wait<0>();
      mbar_arrive_if(&empty[(it - 1) % kStages], lane0);
      if (active) p.epilogue(mb * kBM, nb * P::kCols, wg, acc0, acc1);
    }
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix at `ptr` (16-byte aligned, cols a
// multiple of 8) as boxes of box_rows x box_cols (box_cols = 64: one
// 128-byte swizzle row), zero-filled outside. Returns a cudaError_t code.
inline int tensor_map(CUtensorMap* map, const void* ptr, uint64_t rows,
                      uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(bf16)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launches a gemm_persistent kernel on min(tiles, SMs) blocks with
// kSmemBytes of dynamic shared memory.
template <class Kernel, class... Args>
inline int launch_persistent(Kernel kernel, int tiles, cudaStream_t stream,
                             Args... args) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tiles < sms ? tiles : sms, kThreads, kSmemBytes, stream>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper
}  // namespace port
