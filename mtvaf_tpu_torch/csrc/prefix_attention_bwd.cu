// Prefix-KV attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` in mtvaf_tpu/kernels/prefix_attention.py
// (launched by the pallas_call in `_attention_bwd`).  Given the forward's
// inputs, its output o, its dropout-free lse and the output gradient do, per
// (batch b, head h):
//
//   p     = exp(q k^T * scale + bias - lse)       recomputed, never stored
//   y     = p * keep                              keep: 1/(1-rate) or 0
//   delta = rowsum(do * o)
//   dv    = y^T do
//   ds    = p * ((do v^T) * keep - delta)
//   dq    = ds k * scale,   dk = ds^T q * scale
//
// (dbias is zero: the bias is a constant mask.)  keep is the forward's: the
// forward kernel hands over its keep bits as keep words (one 32-bit word per
// thread and tile pair, layout in hopper.cuh), and this kernel reads them and
// draws no random bits.
// Types as in the forward: q, k, v, o, do and the gradients all bf16 or all
// fp32; bias, lse and every sum fp32.
//
// What bounds it: at the train shape (B=32, H=12, S=128, T=144, D=64, bf16)
// the function must read q, o, do (S rows), k, v (T rows), lse and bias and
// write dq, dk, dv: about 53.7 MB, 16.0 us at 3.35 TB/s, against 4.5 GFLOP of
// products (five S x T x D products per (b, h)), 4.6 us of bf16 tensor-core
// time.  So it is memory-bound on the card's budget: the design keeps p, dp
// and ds in registers, never in device memory, puts the products on the
// tensor cores, and keeps the per-element work between them short.
//
// The TPU kernel's grid runs in order on one core and carries dq across KV
// chunks; Hopper blocks run in no order.  So both routes make two passes,
// each block owning its outputs: no atomics, and the result is bitwise the
// same from run to run (a trainer resumed from (seed, step) relies on it).
// The dq pass also writes delta = rowsum(do * o) to an fp32 scratch for the
// dk/dv pass; each pass recomputes p from the lse.
//
// bf16 (the model's type): one warpgroup (128 threads) per tile of 64 rows,
// operand tiles loaded by TMA (3-D tensor maps, zero-filled past the ragged
// edge of a head) into 128-byte-swizzled shared memory, a two-stage ring
// completing on mbarriers, and every product a wgmma.m64n64k16 (hopper.cuh):
//   (a) dq pass, per (64-query tile, h, b), looping over 64-key K/V tiles:
//       S = Q K^T and dP = dO V^T (both tiles in shared memory, K-major);
//       P, dS = P (dP keep - delta) on the accumulator's fragment; then
//       dQ += dS K with dS from registers and K MN-major.
//   (b) dk/dv pass, per (64-key tile, h, b), looping over 64-query Q/dO
//       tiles in the transposed orientation, so the accumulator's rows are
//       keys: S^T = K Q^T, dP^T = V dO^T; dV += (P^T keep) dO and
//       dK += dS^T Q, the register operands from the accumulators, dO and Q
//       MN-major.
// The vectors a streamed tile needs (the dq pass: the key tile's bias row
// times log2 e, -inf past T; the dk/dv pass: the query tile's lse times
// log2 e, +inf past S, and delta) are staged in shared memory with the
// tile's stage, by threads 0-63, one step ahead, so the element-wise work
// between two products reads no global memory and takes no branch (p is 0
// past the ragged edges by those infinities); it was the largest part of a
// tile's time while it did.  A per-row bias (B, S, T), which the model does
// not use, is read from global memory per element instead.
// The mask is drawn once per forward, by the forward kernel, which stores
// it as keep words (1.2 MB at the train shape).  The dq pass loads a
// thread's word of a tile (one coalesced 512-byte read a tile, started
// before the tile's wait), in its own accumulator layout; the dk/dv pass
// stages a tile's 128 words with its stage and picks its own bits out by a
// fixed transpose.  Drawing the mask again in the dq pass (8 Philox calls
// per thread and tile) set that pass's pace with dropout; drawing it in the
// dk/dv pass, where the four words of a Philox call fall in four lanes,
// took most of that pass's dropout time.
// A dk/dv block holds two 64 x 64 fp32 accumulators across its loop; it
// keeps dV's in shared memory outside dV's products, so that it fits in
// 168 registers, three blocks to an SM, without spilling (at two blocks to
// an SM the pass ran in five waves at the train shape).
// dS and P enter their products as bf16 pairs (hi + lo, two wgmmas each):
// rounded to one bf16, as the forward's P is, they moved the gradients by
// one bf16 ulp against the plain fp32 backward (0.0156 at |g| >= 2) past
// its 1e-2 tolerance.
//
// fp32 (dq_tf32x3_kernel, dkdv_tf32x3_kernel; the --no_bf16 route of the
// parity runs): every product is split TF32 (3xTF32, hopper.cuh: each
// operand as TF32 hi + lo, three wgmma.m64n64k8 TF32 products into the
// fp32 accumulator), since one TF32 product misses the fp32 tolerances.  At
// the train shape the function moves 107.17 MB in fp32 (32.0 us at 3.35
// TB/s) against 4.53 GFLOP, 27.5 us at a third of the 494.7 TFLOP/s TF32
// peak: bound by bytes, the split's tensor time just under it.  The passes,
// the keep words read back and the staged vectors are bf16's;
// the tiles are fp32 (16 KB, two TMA boxes of 32 columns).  TF32 wgmma
// reads shared-memory operands K-major only, so a product that reduces
// over a tile's rows takes that tile transposed by the threads: K^T for dQ
// = dS K, dO^T for dV = Y^T dO and Q^T for dK = dS^T Q; their rows are
// permuted so that dS, Y^T and dS^T enter from the accumulators unmoved
// (kperm).  Own tiles land once and are split in place (hi) and beside
// (lo); the streamed pair lands in a one-tile landing pair, is split into
// its operand tiles (K-major and, where needed, transposed), and the next
// pair loads into the landing buffers while this pair's products run.
// Shared memory bounds the block: 192 KB (dq pass) and 224 KB (dk/dv
// pass), one block of 128 threads to an SM; the dk/dv pass finishes dV's
// products before it splits dS^T, so that only one product's split operand
// is live in registers.  Two warpgroups to a block, each taking half of a
// tile's columns (eight warps to an SM), ran no faster on the H100: bound
// to the block's barriers, they split and multiply in step, not beside
// each other, and re-read the shared A operand once each.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// The bf16 route: wgmma fed by TMA.

namespace hp = mtvaf::hopper;
constexpr int STAGES = 2;   // ring depth of the streamed tiles
// A dq-pass block: 2 own tiles + 2 streamed tiles per stage, barriers, 2 KB
// of per-tile vectors (delta, bias by stage), alignment.  A dk/dv-pass block
// has the same (its vectors: lse, delta and keep words by stage) and dV's
// accumulator between steps.
constexpr int DQ_SMEM = (2 + 2 * STAGES) * hp::TILE_BYTES + 64 + 2048 + 1024;
constexpr int DV_BYTES = 128 * 32 * 4;
constexpr int DKDV_SMEM = DQ_SMEM + DV_BYTES;

// A 64 x 64 accumulator to and from shared memory, float4 k of thread t at
// [k][t]: each thread reads back only its own slots, and a warp's float4s
// are consecutive (no bank conflicts).
__device__ __forceinline__ void load_acc(float (&d)[32], const float4* buf) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 x = buf[k * 128 + threadIdx.x];
    d[4 * k] = x.x;
    d[4 * k + 1] = x.y;
    d[4 * k + 2] = x.z;
    d[4 * k + 3] = x.w;
  }
}
__device__ __forceinline__ void store_acc(float4* buf, const float (&d)[32]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    buf[k * 128 + threadIdx.x] =
        make_float4(d[4 * k], d[4 * k + 1], d[4 * k + 2], d[4 * k + 3]);
}

// Loads the two streamed tiles of step `i` into stage `s` (one thread).
__device__ __forceinline__ void load_pair(unsigned char* a, unsigned char* b,
                                          const CUtensorMap* amap,
                                          const CUtensorMap* bmap,
                                          uint64_t* bar, int row, int plane) {
  hp::mbar_expect_tx(bar, 2 * hp::TILE_BYTES);
  hp::tma_load_tile(a, amap, bar, row, plane);
  hp::tma_load_tile(b, bmap, bar, row, plane);
}

// Pass (a): dq, and delta for pass (b).  Own tiles: q, do; streamed: k, v.
template <bool DROPOUT>
__global__ void __launch_bounds__(128)
dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap domap,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ o,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse,
               const uint32_t* __restrict__ words,
               __nv_bfloat16* __restrict__ dq, float* __restrict__ delta_out,
               int H, int S, int Tk, int bias_rows, float scale,
               float keep_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hp::align1024(smem_raw);
  unsigned char* qs = sm;
  unsigned char* dos = sm + hp::TILE_BYTES;
  unsigned char* ks = sm + 2 * hp::TILE_BYTES;                // [STAGES]
  unsigned char* vs = sm + (2 + STAGES) * hp::TILE_BYTES;     // [STAGES]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      sm + (2 + 2 * STAGES) * hp::TILE_BYTES);  // [0]: q, do; [1 + s]: stage
  float* delta_s = reinterpret_cast<float*>(bars + 8);
  float* bias_s = delta_s + 64;   // [STAGES][64]: bias * log2(e), bias_rows 1

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * hp::TILE;
  const int plane = b * H + h;
  const int tid = threadIdx.x, lane = tid & 31, c = lane & 3;
  const int nt = (Tk + hp::TILE - 1) / hp::TILE;

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) hp::mbar_init(&bars[i], 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_pair(qs, dos, &qmap, &domap, &bars[0], q0, plane);
    for (int s = 0; s < STAGES && s < nt; ++s)
      load_pair(ks + s * hp::TILE_BYTES, vs + s * hp::TILE_BYTES, &kmap,
                &vmap, &bars[1 + s], s * hp::TILE, plane);
  }

  const float* bb = bias + (size_t)b * bias_rows * Tk;
  // The bias of key tile `tile` into stage `st`, -inf past T (one row of
  // bias serves every query).
  auto stage_bias = [&](int st, int tile) {
    if (bias_rows == 1 && tid < 64) {
      const int col = tile * hp::TILE + tid;
      bias_s[st * 64 + tid] = col < Tk ? bb[col] * LOG2E : -CUDART_INF_F;
    }
  };
  for (int s = 0; s < STAGES && s < nt; ++s) stage_bias(s, s);

  {  // delta = rowsum(do * o): a thread pair per row, 32 dims each
    const int r = q0 + (tid >> 1);
    float d = 0.f;
    if (r < S) {
      const size_t off = ((size_t)plane * S + r) * 64 + (tid & 1) * 32;
      const uint4* op = reinterpret_cast<const uint4*>(o + off);
      const uint4* dp = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 ov = op[i], dv = dp[i];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          d = fmaf(df.x, of.x, d);
          d = fmaf(df.y, of.y, d);
        }
      }
    }
    d += __shfl_xor_sync(FULL, d, 1);
    if ((tid & 1) == 0) {
      delta_s[tid >> 1] = d;
      if (r < S) delta_out[(size_t)plane * S + r] = d;
    }
  }
  __syncthreads();

  const int lr0 = 16 * (tid >> 5) + (lane >> 2);
  const int row0 = q0 + lr0, row1 = row0 + 8;
  const float delta0 = delta_s[lr0], delta1 = delta_s[lr0 + 8];
  const float lse0 = row0 < S ? lse[(size_t)plane * S + row0] * LOG2E : 0.f;
  const float lse1 = row1 < S ? lse[(size_t)plane * S + row1] * LOG2E : 0.f;
  // this thread's rows of a per-row bias (bias_rows == S)
  const float* bp0 = bias_rows == 1 ? bb : bb + (size_t)min(row0, S - 1) * Tk;
  const float* bp1 = bias_rows == 1 ? bb : bb + (size_t)min(row1, S - 1) * Tk;
  const float qscale = scale * LOG2E;
  float acc[32], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sc[i] = dp[i] = 0.f;

  hp::mbar_wait(&bars[0], 0);
  const uint64_t qdesc = hp::desc(qs), dodesc = hp::desc(dos);
  for (int j = 0; j < nt; ++j) {
    const int s = j % STAGES;
    unsigned char* kt = ks + s * hp::TILE_BYTES;
    // the forward's keep word of this tile, loaded before the wait
    const uint32_t keep = DROPOUT
        ? __ldg(words + hp::keep_word_index(plane, blockIdx.x, gridDim.x, j,
                                            nt))
        : 0xffffffffu;
    hp::mbar_wait(&bars[1 + s], (j / STAGES) & 1);
    hp::wgmma_fence();
    hp::gemm_ss(sc, qdesc, hp::desc(kt));
    hp::gemm_ss(dp, dodesc, hp::desc(vs + s * hp::TILE_BYTES));
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_regs(sc);
    hp::fence_regs(dp);

    const int t0 = j * hp::TILE;
    // scores in base 2; past T the key tile is zero-filled and the bias
    // -inf, so p = 0 there
    if (bias_rows == 1) {
      const float* bias_t = bias_s + s * 64;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = fmaf(sc[i], qscale, bias_t[8 * (i >> 2) + 2 * c + (i & 1)]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = t0 + 8 * (i >> 2) + 2 * c + (i & 1);
        const float* bp = (i >> 1) & 1 ? bp1 : bp0;
        sc[i] = col < Tk ? fmaf(sc[i], qscale, bp[min(col, Tk - 1)] * LOG2E)
                         : -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool second = (i >> 1) & 1;
      const float p = hp::ex2(sc[i] - (second ? lse1 : lse0));
      float g = dp[i];
      if (DROPOUT) g *= (keep >> i) & 1 ? keep_scale : 0.f;
      sc[i] = p * (g - (second ? delta1 : delta0));   // ds
    }

    uint32_t hi[16], lo[16];
    hp::pack_a_split(hi, lo, sc);
    hp::wgmma_fence();
    hp::gemm_rs(acc, hi, hp::desc(kt));
    hp::gemm_rs(acc, lo, hp::desc(kt));
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_regs(acc);

    __syncthreads();   // every warp is past stage s: refill it
    if (j + STAGES < nt) {
      if (tid == 0)
        load_pair(kt, vs + s * hp::TILE_BYTES, &kmap, &vmap, &bars[1 + s],
                  (j + STAGES) * hp::TILE, plane);
      stage_bias(s, j + STAGES);
    }
  }

#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    const int col = 8 * n8 + 2 * c;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t)plane * S + row0) * 64 +
                                         col) =
          __floats2bfloat162_rn(acc[4 * n8] * scale, acc[4 * n8 + 1] * scale);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t)plane * S + row1) * 64 +
                                         col) =
          __floats2bfloat162_rn(acc[4 * n8 + 2] * scale,
                                acc[4 * n8 + 3] * scale);
  }
}

// The keep mask of this thread's dk/dv-pass accumulator (rows keys, columns
// queries) from the 128 keep words of a tile that the forward stored, one
// per thread in its own accumulator layout (rows queries, columns keys).
// There element (query r, key t) is bit 4 (t / 8) + 2 ((r / 8) % 2) + t % 2
// of thread 32 (r / 16) + 4 (r % 8) + (t % 8) / 2.  Here element j is (key
// 16 w + l / 4 + 8 ((j / 2) % 2), query 8 (j / 4) + 2 (l % 4) + j % 2) in
// warp w, lane l: 16 words, two bits each, no bank conflicts.
__device__ __forceinline__ uint32_t transposed_keep(const uint32_t* words) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane & 3;
  const int base = 8 * w + ((lane >> 2) & 1);
  uint32_t mask = 0;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * n + 2 * c + e;             // query
      const uint32_t word = words[32 * (r >> 4) + 4 * (r & 7) + ((lane >> 3) & 3)];
      const int bit = base + 2 * (n & 1);
      mask |= ((word >> bit) & 1u) << (4 * n + e);             // key row 0
      mask |= ((word >> (bit + 4)) & 1u) << (4 * n + 2 + e);   // key row 1
    }
  }
  return mask;
}

// Pass (b): dk and dv.  Own tiles: k, v; streamed: q, do.  Three blocks to
// an SM (168 registers): dV's accumulator stays in shared memory outside its
// products, which leaves room in registers for S^T, dP^T and the packed
// operands beside dK's.
template <bool DROPOUT>
__global__ void __launch_bounds__(128, 3)
dkdv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const float* __restrict__ bias,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta_in,
                 const uint32_t* __restrict__ words,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int H, int S, int Tk,
                 int bias_rows, float scale, float keep_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hp::align1024(smem_raw);
  unsigned char* ks = sm;
  unsigned char* vs = sm + hp::TILE_BYTES;
  unsigned char* qs = sm + 2 * hp::TILE_BYTES;                // [STAGES]
  unsigned char* dos = sm + (2 + STAGES) * hp::TILE_BYTES;    // [STAGES]
  float4* dv_s = reinterpret_cast<float4*>(   // dV between steps
      sm + (2 + 2 * STAGES) * hp::TILE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(   // [0]: k, v; [1 + s]: stage
      sm + (2 + 2 * STAGES) * hp::TILE_BYTES + DV_BYTES);
  float* lse_s = reinterpret_cast<float*>(bars + 8);  // [STAGES][64]
  float* dl_s = lse_s + STAGES * 64;                  // [STAGES][64]
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(dl_s + STAGES * 64);
                                                      // [STAGES][128]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * hp::TILE;
  const int plane = b * H + h;
  const int tid = threadIdx.x, lane = tid & 31, c = lane & 3;
  const int nq = (S + hp::TILE - 1) / hp::TILE;
  const float* lsep = lse + (size_t)plane * S;
  const float* dlp = delta_in + (size_t)plane * S;
  const int nk = gridDim.x;
  // lse * log2(e) and delta of query tile `tile` into stage `st`, and the
  // forward's keep words of (query tile, this key tile).
  auto stage_rows = [&](int st, int tile) {
    if (tid < 64) {
      const int qc = tile * hp::TILE + tid;
      // +inf past S: p = 0 there
      lse_s[st * 64 + tid] = qc < S ? lsep[qc] * LOG2E : CUDART_INF_F;
      dl_s[st * 64 + tid] = qc < S ? dlp[qc] : 0.f;
    }
    if (DROPOUT)
      bits_s[st * 128 + tid] =
          words[hp::keep_word_index(plane, tile, nq, blockIdx.x, nk)];
  };
  for (int s = 0; s < STAGES && s < nq; ++s) stage_rows(s, s);

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) hp::mbar_init(&bars[i], 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_pair(ks, vs, &kmap, &vmap, &bars[0], k0, plane);
    for (int s = 0; s < STAGES && s < nq; ++s)
      load_pair(qs + s * hp::TILE_BYTES, dos + s * hp::TILE_BYTES, &qmap,
                &domap, &bars[1 + s], s * hp::TILE, plane);
  }

  // This thread's two key rows.
  const int key0 = k0 + 16 * (tid >> 5) + (lane >> 2), key1 = key0 + 8;
  const float* bb = bias + (size_t)b * bias_rows * Tk;
  const float kb0 = bias_rows == 1 && key0 < Tk ? bb[key0] * LOG2E : 0.f;
  const float kb1 = bias_rows == 1 && key1 < Tk ? bb[key1] * LOG2E : 0.f;
  const float qscale = scale * LOG2E;
  float dka[32], dva[32], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = st[i] = dpt[i] = 0.f;
  store_acc(dv_s, dva);

  hp::mbar_wait(&bars[0], 0);
  const uint64_t kdesc = hp::desc(ks), vdesc = hp::desc(vs);
  for (int it = 0; it < nq; ++it) {
    const int s = it % STAGES;
    unsigned char* qt = qs + s * hp::TILE_BYTES;
    unsigned char* dot = dos + s * hp::TILE_BYTES;
    hp::mbar_wait(&bars[1 + s], (it / STAGES) & 1);
    hp::wgmma_fence();
    hp::gemm_ss(st, kdesc, hp::desc(qt));
    hp::gemm_ss(dpt, vdesc, hp::desc(dot));
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_regs(st);
    hp::fence_regs(dpt);

    const int s0 = it * hp::TILE;
    uint32_t keep = 0xffffffffu;
    if (DROPOUT) keep = transposed_keep(bits_s + s * 128);
    if (bias_rows == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        st[i] = fmaf(st[i], qscale, (i >> 1) & 1 ? kb1 : kb0);
    } else {   // rows past T are computed but never stored
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = min(s0 + 8 * (i >> 2) + 2 * c + (i & 1), S - 1);
        const int key = min((i >> 1) & 1 ? key1 : key0, Tk - 1);
        st[i] = fmaf(st[i], qscale, bb[(size_t)qc * Tk + key] * LOG2E);
      }
    }
    const float* lse_t = lse_s + s * 64;
    const float* dl_t = dl_s + s * 64;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int cc = 8 * (i >> 2) + 2 * c + (i & 1);
      const float p = hp::ex2(st[i] - lse_t[cc]);   // 0 past S
      float kf = 1.f;
      if (DROPOUT) kf = (keep >> i) & 1 ? keep_scale : 0.f;
      st[i] = p * kf;                          // y
      dpt[i] = p * (dpt[i] * kf - dl_t[cc]);   // ds
    }

    uint32_t yhi[16], ylo[16], dshi[16], dslo[16];
    hp::pack_a_split(yhi, ylo, st);
    hp::pack_a_split(dshi, dslo, dpt);
    load_acc(dva, dv_s);
    hp::wgmma_fence();
    hp::gemm_rs(dva, yhi, hp::desc(dot));
    hp::gemm_rs(dva, ylo, hp::desc(dot));
    hp::gemm_rs(dka, dshi, hp::desc(qt));
    hp::gemm_rs(dka, dslo, hp::desc(qt));
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_regs(dva);
    hp::fence_regs(dka);
    store_acc(dv_s, dva);

    __syncthreads();   // every warp is past stage s: refill it
    if (it + STAGES < nq) {
      if (tid == 0)
        load_pair(qt, dot, &qmap, &domap, &bars[1 + s],
                  (it + STAGES) * hp::TILE, plane);
      stage_rows(s, it + STAGES);
    }
  }

  load_acc(dva, dv_s);
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    const int col = 8 * n8 + 2 * c;
    if (key0 < Tk) {
      const size_t off = ((size_t)plane * Tk + key0) * 64 + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
          dka[4 * n8] * scale, dka[4 * n8 + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dva[4 * n8], dva[4 * n8 + 1]);
    }
    if (key1 < Tk) {
      const size_t off = ((size_t)plane * Tk + key1) * 64 + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
          dka[4 * n8 + 2] * scale, dka[4 * n8 + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dva[4 * n8 + 2], dva[4 * n8 + 3]);
    }
  }
}

template <bool DROPOUT>
int launch_bf16(const void* q, const void* k, const void* v,
                const float* bias, const void* o, const float* lse,
                const void* dout, const uint32_t* words, void* dq, void* dk,
                void* dv, float* delta, int B, int H, int S, int Tk,
                int bias_rows, float scale, float keep_scale,
                cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  if (!hp::make_tile_map(&qm, q, S, B * H) ||
      !hp::make_tile_map(&km, k, Tk, B * H) ||
      !hp::make_tile_map(&vm, v, Tk, B * H) ||
      !hp::make_tile_map(&dom, dout, S, B * H))
    return -2;
  // above the default 48 KB of dynamic shared memory (set per launch: the
  // attribute belongs to the current device)
  cudaError_t err = cudaFuncSetAttribute(
      dq_bf16_kernel<DROPOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_bf16_kernel<DROPOUT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DKDV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_bf16_kernel<DROPOUT><<<dim3((S + hp::TILE - 1) / hp::TILE, H, B), 128,
                            DQ_SMEM, stream>>>(
      qm, km, vm, dom, bias, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, words,
      static_cast<__nv_bfloat16*>(dq), delta, H, S, Tk, bias_rows, scale,
      keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_bf16_kernel<DROPOUT><<<dim3((Tk + hp::TILE - 1) / hp::TILE, H, B),
                              128, DKDV_SMEM, stream>>>(
      qm, km, vm, dom, bias, lse, delta, words,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, S,
      Tk, bias_rows, scale, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The fp32 route: split-TF32 wgmma fed by TMA.

constexpr int TB = hp::F32_TILE_BYTES;
// A dq-pass block: Q and dO hi/lo (own); raw K and V as TMA lands them; K
// hi/lo, K^T hi/lo, V hi/lo; barriers, delta and the bias row, alignment.
constexpr int DQ32_SMEM = 12 * TB + 64 + 2 * 64 * 4 + 1024;
// A dk/dv-pass block: K and V hi/lo (own); raw Q and dO; Q hi/lo, Q^T
// hi/lo, dO hi/lo, dO^T hi/lo; barriers, lse, delta and the keep words of
// one query tile, alignment (231,488 of the 232,448 bytes a block may use).
constexpr int DKDV32_SMEM = 14 * TB + 64 + 2 * 64 * 4 + 128 * 4 + 1024;

// Pass (a): dq, and delta for pass (b).  Own tiles: q, do; streamed: k, v.
template <bool DROPOUT>
__global__ void __launch_bounds__(128, 1)
dq_tf32x3_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const float* __restrict__ bias, const float* __restrict__ o,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const uint32_t* __restrict__ words, float* __restrict__ dq,
                 float* __restrict__ delta_out, int H, int S, int Tk,
                 int bias_rows, float scale, float keep_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hp::align1024(smem_raw);
  unsigned char* qh = sm;
  unsigned char* ql = sm + TB;
  unsigned char* doh = sm + 2 * TB;
  unsigned char* dol = sm + 3 * TB;
  unsigned char* kraw = sm + 4 * TB;
  unsigned char* vraw = sm + 5 * TB;
  unsigned char* kh = sm + 6 * TB;
  unsigned char* kl = sm + 7 * TB;
  unsigned char* kth = sm + 8 * TB;
  unsigned char* ktl = sm + 9 * TB;
  unsigned char* vh = sm + 10 * TB;
  unsigned char* vl = sm + 11 * TB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + 12 * TB);  // own; raw
  float* delta_s = reinterpret_cast<float*>(bars + 8);
  float* bias_s = delta_s + 64;   // bias * log2(e) of a key tile, bias_rows 1

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * hp::TILE;
  const int plane = b * H + h;
  const int tid = threadIdx.x, lane = tid & 31, c = lane & 3;
  const int nt = (Tk + hp::TILE - 1) / hp::TILE;

  if (tid == 0) {
    hp::mbar_init(&bars[0], 1);
    hp::mbar_init(&bars[1], 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hp::mbar_expect_tx(&bars[0], 2 * TB);
    hp::tma_load_f32_tile(qh, &qmap, &bars[0], q0, plane);
    hp::tma_load_f32_tile(doh, &domap, &bars[0], q0, plane);
    hp::mbar_expect_tx(&bars[1], 2 * TB);
    hp::tma_load_f32_tile(kraw, &kmap, &bars[1], 0, plane);
    hp::tma_load_f32_tile(vraw, &vmap, &bars[1], 0, plane);
  }

  const float* bb = bias + (size_t)b * bias_rows * Tk;
  {  // delta = rowsum(do * o): a thread pair per row, 32 dims each
    const int r = q0 + (tid >> 1);
    float d = 0.f;
    if (r < S) {
      const size_t off = ((size_t)plane * S + r) * 64 + (tid & 1) * 32;
      const float4* op = reinterpret_cast<const float4*>(o + off);
      const float4* dp = reinterpret_cast<const float4*>(dout + off);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 ov = op[i], dv = dp[i];
        d = fmaf(dv.x, ov.x, d);
        d = fmaf(dv.y, ov.y, d);
        d = fmaf(dv.z, ov.z, d);
        d = fmaf(dv.w, ov.w, d);
      }
    }
    d += __shfl_xor_sync(FULL, d, 1);
    if ((tid & 1) == 0) {
      delta_s[tid >> 1] = d;
      if (r < S) delta_out[(size_t)plane * S + r] = d;
    }
  }
  __syncthreads();

  const int lr0 = 16 * (tid >> 5) + (lane >> 2);
  const int row0 = q0 + lr0, row1 = row0 + 8;
  const float delta0 = delta_s[lr0], delta1 = delta_s[lr0 + 8];
  const float lse0 = row0 < S ? lse[(size_t)plane * S + row0] * LOG2E : 0.f;
  const float lse1 = row1 < S ? lse[(size_t)plane * S + row1] * LOG2E : 0.f;
  // this thread's rows of a per-row bias (bias_rows == S)
  const float* bp0 = bias_rows == 1 ? bb : bb + (size_t)min(row0, S - 1) * Tk;
  const float* bp1 = bias_rows == 1 ? bb : bb + (size_t)min(row1, S - 1) * Tk;
  const float qscale = scale * LOG2E;
  float acc[32], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sc[i] = dp[i] = 0.f;

  hp::mbar_wait(&bars[0], 0);
  hp::split_tile<true, false>(qh, qh, ql, nullptr, nullptr);
  hp::split_tile<true, false>(doh, doh, dol, nullptr, nullptr);
  const uint64_t qhd = hp::desc(qh), qld = hp::desc(ql);
  const uint64_t dohd = hp::desc(doh), dold = hp::desc(dol);
  const uint64_t khd = hp::desc(kh), kld = hp::desc(kl);
  const uint64_t kthd = hp::desc(kth), ktld = hp::desc(ktl);
  const uint64_t vhd = hp::desc(vh), vld = hp::desc(vl);
  for (int j = 0; j < nt; ++j) {
    const int t0 = j * hp::TILE;
    // the key tile's bias row, -inf past T, and the forward's keep word of
    // this tile, read before the wait
    const float bias_v = bias_rows == 1 && tid < 64
        ? (t0 + tid < Tk ? bb[t0 + tid] * LOG2E : -CUDART_INF_F) : 0.f;
    const uint32_t keep = DROPOUT
        ? __ldg(words + hp::keep_word_index(plane, blockIdx.x, gridDim.x, j,
                                            nt))
        : 0xffffffffu;
    hp::mbar_wait(&bars[1], j & 1);
    hp::split_tile<true, true>(kraw, kh, kl, kth, ktl);
    hp::split_tile<true, false>(vraw, vh, vl, nullptr, nullptr);
    if (bias_rows == 1 && tid < 64) bias_s[tid] = bias_v;
    hp::fence_proxy_async();
    __syncthreads();   // the raw tiles are read: load the next pair there
    if (tid == 0 && j + 1 < nt) {
      hp::mbar_expect_tx(&bars[1], 2 * TB);
      hp::tma_load_f32_tile(kraw, &kmap, &bars[1], t0 + hp::TILE, plane);
      hp::tma_load_f32_tile(vraw, &vmap, &bars[1], t0 + hp::TILE, plane);
    }

    hp::wgmma_fence();
    hp::gemm3_ss(sc, qhd, qld, khd, kld);
    hp::gemm3_ss(dp, dohd, dold, vhd, vld);
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_regs(sc);
    hp::fence_regs(dp);

    // scores in base 2; past T the key tile is zero-filled and the bias
    // -inf, so p = 0 there
    if (bias_rows == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = fmaf(sc[i], qscale, bias_s[8 * (i >> 2) + 2 * c + (i & 1)]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = t0 + 8 * (i >> 2) + 2 * c + (i & 1);
        const float* bp = (i >> 1) & 1 ? bp1 : bp0;
        sc[i] = col < Tk ? fmaf(sc[i], qscale, bp[min(col, Tk - 1)] * LOG2E)
                         : -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool second = (i >> 1) & 1;
      const float p = hp::ex2(sc[i] - (second ? lse1 : lse0));
      float g = dp[i];
      if (DROPOUT) g *= (keep >> i) & 1 ? keep_scale : 0.f;
      sc[i] = p * (g - (second ? delta1 : delta0));   // ds
    }

    uint32_t dsh[32], dsl[32];
    hp::split_a(dsh, dsl, sc);
    hp::wgmma_fence();
    hp::gemm3_rs(acc, dsh, dsl, kthd, ktld);
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_regs(acc);
    __syncthreads();   // the split tiles are no longer read
  }

#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    const int col = 8 * n8 + 2 * c;
    if (row0 < S)
      *reinterpret_cast<float2*>(dq + ((size_t)plane * S + row0) * 64 + col) =
          make_float2(acc[4 * n8] * scale, acc[4 * n8 + 1] * scale);
    if (row1 < S)
      *reinterpret_cast<float2*>(dq + ((size_t)plane * S + row1) * 64 + col) =
          make_float2(acc[4 * n8 + 2] * scale, acc[4 * n8 + 3] * scale);
  }
}

// Pass (b): dk and dv.  Own tiles: k, v; streamed: q, do, each split K-major
// (for S^T = K Q^T and dP^T = V dO^T) and transposed (for dK += dS^T Q and
// dV += Y^T dO).  dV's products complete before dS^T is split, so that the
// split operands of only one product are live (no spills at 255 registers).
template <bool DROPOUT>
__global__ void __launch_bounds__(128, 1)
dkdv_tf32x3_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const float* __restrict__ bias,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta_in,
                   const uint32_t* __restrict__ words, float* __restrict__ dk,
                   float* __restrict__ dv, int H, int S, int Tk,
                   int bias_rows, float scale, float keep_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hp::align1024(smem_raw);
  unsigned char* kh = sm;
  unsigned char* kl = sm + TB;
  unsigned char* vh = sm + 2 * TB;
  unsigned char* vl = sm + 3 * TB;
  unsigned char* qraw = sm + 4 * TB;
  unsigned char* doraw = sm + 5 * TB;
  unsigned char* qh = sm + 6 * TB;
  unsigned char* ql = sm + 7 * TB;
  unsigned char* qth = sm + 8 * TB;
  unsigned char* qtl = sm + 9 * TB;
  unsigned char* doh = sm + 10 * TB;
  unsigned char* dol = sm + 11 * TB;
  unsigned char* doth = sm + 12 * TB;
  unsigned char* dotl = sm + 13 * TB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + 14 * TB);  // own; raw
  float* lse_s = reinterpret_cast<float*>(bars + 8);   // [64]
  float* dl_s = lse_s + 64;                            // [64]
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(dl_s + 64);   // [128]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * hp::TILE;
  const int plane = b * H + h;
  const int tid = threadIdx.x, lane = tid & 31, c = lane & 3;
  const int nq = (S + hp::TILE - 1) / hp::TILE;
  const int nk = gridDim.x;
  const float* lsep = lse + (size_t)plane * S;
  const float* dlp = delta_in + (size_t)plane * S;

  if (tid == 0) {
    hp::mbar_init(&bars[0], 1);
    hp::mbar_init(&bars[1], 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hp::mbar_expect_tx(&bars[0], 2 * TB);
    hp::tma_load_f32_tile(kh, &kmap, &bars[0], k0, plane);
    hp::tma_load_f32_tile(vh, &vmap, &bars[0], k0, plane);
    hp::mbar_expect_tx(&bars[1], 2 * TB);
    hp::tma_load_f32_tile(qraw, &qmap, &bars[1], 0, plane);
    hp::tma_load_f32_tile(doraw, &domap, &bars[1], 0, plane);
  }

  // This thread's two key rows.
  const int key0 = k0 + 16 * (tid >> 5) + (lane >> 2), key1 = key0 + 8;
  const float* bb = bias + (size_t)b * bias_rows * Tk;
  const float kb0 = bias_rows == 1 && key0 < Tk ? bb[key0] * LOG2E : 0.f;
  const float kb1 = bias_rows == 1 && key1 < Tk ? bb[key1] * LOG2E : 0.f;
  const float qscale = scale * LOG2E;
  float dka[32], dva[32], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = st[i] = dpt[i] = 0.f;

  hp::mbar_wait(&bars[0], 0);
  hp::split_tile<true, false>(kh, kh, kl, nullptr, nullptr);
  hp::split_tile<true, false>(vh, vh, vl, nullptr, nullptr);
  const uint64_t khd = hp::desc(kh), kld = hp::desc(kl);
  const uint64_t vhd = hp::desc(vh), vld = hp::desc(vl);
  const uint64_t qhd = hp::desc(qh), qld = hp::desc(ql);
  const uint64_t qthd = hp::desc(qth), qtld = hp::desc(qtl);
  const uint64_t dohd = hp::desc(doh), dold = hp::desc(dol);
  const uint64_t dothd = hp::desc(doth), dotld = hp::desc(dotl);
  for (int it = 0; it < nq; ++it) {
    const int s0 = it * hp::TILE;
    // the query tile's lse * log2(e) (+inf past S: p = 0 there) and delta,
    // and the forward's keep words of (query tile, this key tile), read
    // before the wait
    float lse_v = 0.f, dl_v = 0.f;
    if (tid < 64) {
      const int qc = s0 + tid;
      lse_v = qc < S ? lsep[qc] * LOG2E : CUDART_INF_F;
      dl_v = qc < S ? dlp[qc] : 0.f;
    }
    const uint32_t bits_v = DROPOUT
        ? words[hp::keep_word_index(plane, it, nq, blockIdx.x, nk)] : 0u;
    hp::mbar_wait(&bars[1], it & 1);
    hp::split_tile<true, true>(qraw, qh, ql, qth, qtl);
    hp::split_tile<true, true>(doraw, doh, dol, doth, dotl);
    if (tid < 64) {
      lse_s[tid] = lse_v;
      dl_s[tid] = dl_v;
    }
    if (DROPOUT) bits_s[tid] = bits_v;
    hp::fence_proxy_async();
    __syncthreads();   // the raw tiles are read: load the next pair there
    if (tid == 0 && it + 1 < nq) {
      hp::mbar_expect_tx(&bars[1], 2 * TB);
      hp::tma_load_f32_tile(qraw, &qmap, &bars[1], s0 + hp::TILE, plane);
      hp::tma_load_f32_tile(doraw, &domap, &bars[1], s0 + hp::TILE, plane);
    }

    hp::wgmma_fence();
    hp::gemm3_ss(st, khd, kld, qhd, qld);
    hp::gemm3_ss(dpt, vhd, vld, dohd, dold);
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_regs(st);
    hp::fence_regs(dpt);

    uint32_t keep = 0xffffffffu;
    if (DROPOUT) keep = transposed_keep(bits_s);
    if (bias_rows == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        st[i] = fmaf(st[i], qscale, (i >> 1) & 1 ? kb1 : kb0);
    } else {   // rows past T are computed but never stored
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = min(s0 + 8 * (i >> 2) + 2 * c + (i & 1), S - 1);
        const int key = min((i >> 1) & 1 ? key1 : key0, Tk - 1);
        st[i] = fmaf(st[i], qscale, bb[(size_t)qc * Tk + key] * LOG2E);
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int cc = 8 * (i >> 2) + 2 * c + (i & 1);
      const float p = hp::ex2(st[i] - lse_s[cc]);   // 0 past S
      float kf = 1.f;
      if (DROPOUT) kf = (keep >> i) & 1 ? keep_scale : 0.f;
      st[i] = p * kf;                          // y
      dpt[i] = p * (dpt[i] * kf - dl_s[cc]);   // ds
    }

    {
      uint32_t yh[32], yl[32];
      hp::split_a(yh, yl, st);
      hp::wgmma_fence();
      hp::gemm3_rs(dva, yh, yl, dothd, dotld);
      hp::wgmma_commit();
      hp::wgmma_wait_all();
      hp::fence_regs(dva);
    }
    {
      uint32_t dsh[32], dsl[32];
      hp::split_a(dsh, dsl, dpt);
      hp::wgmma_fence();
      hp::gemm3_rs(dka, dsh, dsl, qthd, qtld);
      hp::wgmma_commit();
      hp::wgmma_wait_all();
      hp::fence_regs(dka);
    }
    __syncthreads();   // the split tiles are no longer read
  }

#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    const int col = 8 * n8 + 2 * c;
    if (key0 < Tk) {
      const size_t off = ((size_t)plane * Tk + key0) * 64 + col;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(dka[4 * n8] * scale, dka[4 * n8 + 1] * scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(dva[4 * n8], dva[4 * n8 + 1]);
    }
    if (key1 < Tk) {
      const size_t off = ((size_t)plane * Tk + key1) * 64 + col;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(dka[4 * n8 + 2] * scale, dka[4 * n8 + 3] * scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(dva[4 * n8 + 2], dva[4 * n8 + 3]);
    }
  }
}

template <bool DROPOUT>
int launch_fp32(const void* q, const void* k, const void* v,
                const float* bias, const void* o, const float* lse,
                const void* dout, const uint32_t* words, void* dq, void* dk,
                void* dv, float* delta, int B, int H, int S, int Tk,
                int bias_rows, float scale, float keep_scale,
                cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  if (!hp::make_tile_map(&qm, q, S, B * H, 4) ||
      !hp::make_tile_map(&km, k, Tk, B * H, 4) ||
      !hp::make_tile_map(&vm, v, Tk, B * H, 4) ||
      !hp::make_tile_map(&dom, dout, S, B * H, 4))
    return -2;
  cudaError_t err = cudaFuncSetAttribute(
      dq_tf32x3_kernel<DROPOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ32_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_tf32x3_kernel<DROPOUT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DKDV32_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_tf32x3_kernel<DROPOUT><<<dim3((S + hp::TILE - 1) / hp::TILE, H, B), 128,
                              DQ32_SMEM, stream>>>(
      qm, km, vm, dom, bias, static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, words, static_cast<float*>(dq),
      delta, H, S, Tk, bias_rows, scale, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_tf32x3_kernel<DROPOUT><<<dim3((Tk + hp::TILE - 1) / hp::TILE, H, B),
                                128, DKDV32_SMEM, stream>>>(
      qm, km, vm, dom, bias, lse, delta, words, static_cast<float*>(dk),
      static_cast<float*>(dv), H, S, Tk, bias_rows, scale, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32 (split-TF32
// wgmma kernels), 1 = bfloat16 (wgmma kernels); q, k, v, o, do 16-byte
// aligned.  words: the forward's keep words (hopper.cuh), null without
// dropout; keep_scale = 1 / (1 - rate).  delta is an fp32 scratch of
// (B, H, S), delta for the dk/dv pass.  Two launches on `stream`
// (dq pass, then dk/dv pass); returns the first non-zero cudaGetLastError()
// (0 on success, -1 for a head dimension or type this kernel was not
// compiled for, -2 when the driver refuses a tensor map).
extern "C" int mtvaf_prefix_attention_bwd(
    const void* q, const void* k, const void* v, const float* bias,
    const void* o, const float* lse, const void* dout, const uint32_t* words,
    void* dq, void* dk, void* dv, float* delta, int B, int H, int S, int Tk,
    int D, int bias_rows, float scale, int dtype, float keep_scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != hp::TILE) return -1;
  if (dtype == 1)
    return words
        ? launch_bf16<true>(q, k, v, bias, o, lse, dout, words, dq, dk, dv,
                            delta, B, H, S, Tk, bias_rows, scale, keep_scale,
                            st)
        : launch_bf16<false>(q, k, v, bias, o, lse, dout, words, dq, dk, dv,
                             delta, B, H, S, Tk, bias_rows, scale, keep_scale,
                             st);
  if (dtype == 0)
    return words
        ? launch_fp32<true>(q, k, v, bias, o, lse, dout, words, dq, dk, dv,
                            delta, B, H, S, Tk, bias_rows, scale, keep_scale,
                            st)
        : launch_fp32<false>(q, k, v, bias, o, lse, dout, words, dq, dk, dv,
                             delta, B, H, S, Tk, bias_rows, scale, keep_scale,
                             st);
  return -1;
}

// Dynamic shared memory of one block of the dq pass (pass 0) or the dk/dv
// pass (pass 1) of the fp32 (dtype 0) or bf16 (dtype 1) kernels, in bytes
// (ptxas does not see it).
extern "C" int mtvaf_prefix_attention_bwd_smem(int pass, int dtype) {
  if (dtype == 0) return pass == 0 ? DQ32_SMEM : DKDV32_SMEM;
  return pass == 0 ? DQ_SMEM : DKDV_SMEM;
}
