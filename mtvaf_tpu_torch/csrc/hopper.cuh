// Hopper (sm_90a) building blocks shared by the bf16 prefix-attention
// kernels: TMA tensor maps and loads, mbarriers, wgmma shared-memory
// descriptors and the m64n64k16 bf16 products, and the Philox keep masks in
// the wgmma accumulator's layout.  Raw PTX, no CUTLASS, so a build takes
// seconds.
//
// Tiles.  Every operand tile is 64 rows of 64 bf16 (128 bytes), written by
// TMA into shared memory with the 128-byte swizzle, 8 KB, 1024-byte aligned.
// A tile read along its rows (the reduction runs over the 64 columns) is
// "K-major"; a tile read down its columns (the reduction runs over the 64
// rows, as V in P.V) is "MN-major" and takes wgmma's transpose bit.
//
// Accumulator layout of wgmma m64n64k16 (fp32, 32 registers a thread): in a
// warpgroup, thread (warp w, lane l) holds acc[j] at
//   row 16 w + l / 4 + 8 ((j >> 1) & 1),   col 8 (j >> 2) + 2 (l % 4) + (j & 1).
// The A operand from registers (four 32-bit registers of two bf16 each, for
// one 16-column step kk) takes the same (row, col) places, so a probability
// tile in the accumulator becomes the A operand of the next product in place
// (pack_a below).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace mtvaf {
namespace hopper {

constexpr int TILE = 64;                       // rows of a tile (and width)
constexpr int TILE_BYTES = TILE * TILE * 2;    // 8 KB of bf16

// ---------------------------------------------------------------------------
// Host: tensor maps.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the runtime hands out its
// address, so the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess)
      p = nullptr;
#endif
    if (found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous bf16 (planes, rows, 64) tensor, as (64, rows,
// planes) innermost first, loaded in (64, 64, 1) boxes with the 128-byte
// swizzle.  A box that runs past `rows` is zero-filled there and never
// reaches into the next plane (the next head's rows).  Returns false when
// the driver refuses (a pointer not 16-byte aligned, for one).
inline bool make_tile_map(CUtensorMap* map, const void* base, int rows,
                          int planes) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)TILE, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)TILE * 2,
                                 (cuuint64_t)rows * TILE * 2};
  const cuuint32_t box[3] = {TILE, TILE, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Device: mbarriers and TMA.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Tiles start on a 1024-byte boundary (the 128-byte swizzle's period).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the TMA unit.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the barrier's phase `parity` has completed.  A load that never
// completes (a wrong byte count) traps after ~2^26 polls instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// One (64, 64, 1) box at (col 0, row, plane) into `dst`; completes on `bar`.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row,
                                              int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0),
      "r"(row), "r"(plane)
      : "memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma.

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start address
// and the 1024-byte stride between 8-row groups (in 16-byte units); the
// leading offset is unused by these layouts (one swizzle atom wide).
__device__ __forceinline__ uint64_t desc(const void* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}
// Step kk (16 columns of the reduction) of a K-major tile: 32 bytes along
// the swizzled row.  Of an MN-major tile: 16 rows of 128 bytes.
__device__ __forceinline__ uint64_t kmajor_step(uint64_t d, int kk) {
  return d + (uint64_t)(2 * kk);
}
__device__ __forceinline__ uint64_t mnmajor_step(uint64_t d, int kk) {
  return d + (uint64_t)(128 * kk);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous product (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define MTVAF_ACC32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define MTVAF_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (+)= A B over one 16-deep step, A and B both K-major in shared memory.
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MTVAF_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MTVAF_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B over one 16-deep step, A from registers (four bf16 pairs), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MTVAF_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MTVAF_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

#undef MTVAF_ACC32
#undef MTVAF_D32

// d = A B over a 64-deep reduction, both tiles K-major (four steps).
__device__ __forceinline__ void gemm_ss(float (&d)[32], uint64_t a,
                                        uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(d, kmajor_step(a, kk), kmajor_step(b, kk), kk > 0);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 tile in accumulator layout, rounded to bf16, as the A operands
// of the four 16-deep steps (a[4 kk .. 4 kk + 3] for step kk).  Packed
// before wgmma_fence, so no register of an issued product is written while
// it runs.
__device__ __forceinline__ void pack_a(uint32_t (&a)[16],
                                       const float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
  fence_regs(a);
}

// X as an unevaluated bf16 pair, hi = bf16(X) and lo = bf16(X - hi): two
// products over hi and lo carry X to about 16 bits, where one bf16 operand
// carries 8 (the backward's gradients are held to the plain fp32 backward).
__device__ __forceinline__ void pack_a_split(uint32_t (&hi)[16],
                                             uint32_t (&lo)[16],
                                             const float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
  }
  fence_regs(hi);
  fence_regs(lo);
}

// d += X B over a 64-deep reduction: X packed by pack_a, B an MN-major tile.
__device__ __forceinline__ void gemm_rs(float (&d)[32], const uint32_t (&a)[16],
                                        uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
             mnmajor_step(b, kk));
}

// ---------------------------------------------------------------------------
// Device: the softmax's exponential.

// 2^x on the SFU (one MUFU.EX2), denormal results flushed to zero: a
// probability below 2^-126 becomes 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Device: the Philox keep bits of one 64 x 64 accumulator tile, as a 32-bit
// mask (bit j for acc[j]), with each Philox call shared between lanes.  The
// eight calls of a thread are independent and unrolled, so they interleave;
// skipping the calls of a ragged tile's empty columns (an early exit in the
// loop) took that away and cost more than it saved on the H100.

// Rows are queries, columns keys (forward, dq pass).  A call covers four
// consecutive keys of one query: lanes l and l ^ 1 hold two keys each of
// it.  The even lane computes row0's call, the odd lane row1's, and each
// passes the other the two words it needs: 8 calls per thread per tile.
__device__ __forceinline__ uint32_t keep_mask_query_rows(
    int b, int h, int row0, int row1, int col0, unsigned seed_lo,
    unsigned seed_hi, unsigned threshold) {
  const int lane = threadIdx.x & 31;
  const bool odd = lane & 1;
  const int c = lane & 3;
  uint32_t mask = 0;
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    const int col4 = (col0 + 8 * n8 + 2 * c) >> 2;
    const uint4 r = keep_bits4(b, h, odd ? row1 : row0, col4, seed_lo,
                               seed_hi);
    const unsigned s0 = odd ? r.x : r.z, s1 = odd ? r.y : r.w;
    const unsigned g0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const unsigned g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    // words for (row0: cols 2c, 2c+1) and (row1: the same cols)
    const unsigned w00 = odd ? g0 : r.x, w01 = odd ? g1 : r.y;
    const unsigned w10 = odd ? r.z : g0, w11 = odd ? r.w : g1;
    mask |= (unsigned)(w00 >= threshold) << (4 * n8 + 0);
    mask |= (unsigned)(w01 >= threshold) << (4 * n8 + 1);
    mask |= (unsigned)(w10 >= threshold) << (4 * n8 + 2);
    mask |= (unsigned)(w11 >= threshold) << (4 * n8 + 3);
  }
  return mask;
}

}  // namespace hopper
}  // namespace mtvaf
