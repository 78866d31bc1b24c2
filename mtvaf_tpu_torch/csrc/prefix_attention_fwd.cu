// Prefix-KV attention forward for Hopper (sm_90a), with attention-probability
// dropout, and the entry point that writes its keep masks.
//
// Replaces the TPU kernel `_fwd_kernel` in mtvaf_tpu/kernels/prefix_attention.py
// (launched by the pallas_call in `_attention_fwd_impl`).  Computes, per
// (batch b, head h, query row s):
//
//   p[t]       = exp(q[b,h,s,:] . k[b,h,t,:] * scale + bias[b, s|0, t] - m)
//   o[b,h,s,:] = sum_t keep[b,h,s,t] * p[t] * v[b,h,t,:] / sum_t p[t]
//   lse[b,h,s] = m + log(sum_t p[t])  (fp32, dropout-free, kept for the backward)
//
// q is (B,H,S,D); k and v are (B,H,T,D) with the visual prefix already
// concatenated (T = P + S); the additive bias is fp32 (B, 1|S, T) and shared by
// every head.  q, k, v and o are all bf16 or all fp32; softmax statistics and
// the accumulator are fp32 whatever the input type.  keep is 1/(1-rate) or 0,
// from the counter-based Philox bits of philox.cuh keyed on (b, h, s, t) under
// the site key mix(step key, salt): the step key is read from device memory
// (`key`, the train step's int64 word), the salt is the call's argument, so a
// CUDA graph that captured the launch draws new masks when the step key's
// tensor is given a new word before a replay.
// With dropout the kernel also writes its keep bits as keep words (one
// 32-bit word per thread and tile pair, layout in hopper.cuh), which the
// backward kernel (prefix_attention_bwd.cu) reads instead of drawing again.
// h is the global head, h + head_offset, where a tensor-parallel rank holds
// heads [head_offset, head_offset + H) of the model: its masks are then those
// heads' masks in a call over every head.
// The TPU kernel draws its masks from the TPU's hardware generator, whose bits
// cannot be reproduced here: the distribution (Bernoulli(1-rate), inverted
// scaling, dropout on the normalised probabilities) is the same.
//
// What bounds it: at the serving shape (B=16, H=12, S=128, T=144, D=64, bf16)
// the function moves about 13.4 MB (q, k, v, o, lse, bias, each once) and does
// about 0.91 GFLOP (two products of 0.23 G multiply-adds each), so on an H100
// it is memory-bound: 13.4 MB / 3.35 TB/s = 4.0 us against 0.9 us of bf16
// tensor-core time (the train shape, B=32, doubles both).  So the design
// keeps every (S, T) value in registers, never in device memory, puts the
// products on the tensor cores so that they stay below the byte time, and
// keeps the per-element softmax work (which, not the bytes, sets the time
// of a 64 x 64 tile) short and free of branches and global loads.
//
// Two routes, chosen by dtype:
//
// bf16 (the model's type; fwd_bf16_kernel): one warpgroup (128 threads) per
// (64-query tile, head, batch): 192 blocks at the serving shape, several per
// SM, so one block's softmax overlaps another's loads and products.  Thread
// 0 loads the q tile and a two-stage ring of 64-key K and V tiles by TMA
// (3-D tensor maps over (D, rows, B*H), so a tile that runs past T is
// zero-filled, never the next head's keys); the tiles complete on
// mbarriers, and a stage is refilled once the whole warpgroup has passed
// its products (__syncthreads).  With the stage's tiles, threads 0-63 stage
// the key tile's bias row (times log2 e, -inf at t >= T) in shared memory,
// so the softmax reads no global memory.  Per key tile: S = Q K^T is four
// wgmma.m64n64k16 steps with both tiles in shared memory, 128-byte
// swizzle; the online softmax (base 2, one MUFU.EX2 per element) runs on
// the accumulator's fragment, a row's max reduced across the four lanes of
// a quad; dropout multiplies p after p entered l (the lse stays
// dropout-free), its Philox calls (8 per thread, shared by lane pairs,
// hopper.cuh) in the same stretch of code as the softmax, so that the
// integer and the floating-point work interleave (drawn while S = Q K^T was
// in flight, they ran slower on the H100), and the tile's keep word stored
// for the backward; then p
// is rounded to bf16 in place and O += P V takes it as the register A
// operand, with V's tile MN-major (the transpose bit).  Query rows at
// s >= S are not stored.  A per-row bias (B, S, T), which the model does not
// use, is read from global memory per element instead.  K and V are read
// once per query tile, the second time from L2.
//
// fp32 (fwd_tf32x3_kernel; the --no_bf16 route of the parity runs): wgmma
// has no fp32 operand, and one TF32 product (10 mantissa bits) misses the
// fp32 tolerances (1e-4 here, 1e-5 in the card tests).  So every product is
// split TF32 (3xTF32, hopper.cuh): q, k, v and p are each hi + lo TF32
// parts, and a b ~= a_lo b_hi + a_hi b_lo + a_hi b_hi, three wgmma.m64n64k8
// TF32 products into the fp32 accumulator, which carries the operands to
// about 2^-22 relative.  At the serving shape the function moves 26.85 MB
// in fp32 (8.0 us at 3.35 TB/s) against 0.906 GFLOP, which at a third of
// the 494.7 TFLOP/s TF32 peak (the split's cost) is 5.5 us: bound by
// bytes, as bf16 is.  The same block as bf16's (one warpgroup per 64-query
// tile) with fp32 tiles of 16 KB in two TMA boxes of 32 columns.  Q lands
// once and is split in place (hi) and beside (lo); each K/V tile pair lands
// raw in K's hi tile and V^T's lo tile and is split there into K hi/lo
// (K-major, for S = Q K^T) and V^T hi/lo (transposed by the threads, since
// TF32 wgmma takes shared-memory operands K-major only).  P enters O += P V
// from registers, split there; V^T's keys are permuted so that the
// accumulator fragment is the A operand unmoved (kperm).  The lo parts are
// made in shared memory once per tile (not once per product) and in
// registers for P.  The split, the products and the softmax of one block
// run in turn, so the design keeps a block to 96 KB of shared memory and
// runs two blocks to an SM, one's products beside the other's element-wise
// work: on the H100 1.44x faster at the train shape than a block that kept
// a second landing pair for the next tiles (128 KB, one block to an SM).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// The bf16 route: wgmma fed by TMA.

namespace hp = mtvaf::hopper;
constexpr int STAGES = 2;                       // K/V ring depth
constexpr int FWD_SMEM =   // tiles, barriers, bias, align
    (1 + 2 * STAGES) * hp::TILE_BYTES + 64 + STAGES * 64 * 4 + 1024;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <bool DROPOUT>
__global__ void __launch_bounds__(128)
fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, uint32_t* __restrict__ words, int H,
                int S, int Tk, int bias_rows, float scale,
                const long long* __restrict__ key, unsigned long long salt,
                unsigned threshold, float keep_scale, int head_offset) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hp::align1024(smem_raw);
  unsigned char* qs = sm;
  unsigned char* ks = sm + hp::TILE_BYTES;                  // [STAGES]
  unsigned char* vs = sm + (1 + STAGES) * hp::TILE_BYTES;   // [STAGES]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      sm + (1 + 2 * STAGES) * hp::TILE_BYTES);  // [0]: q, [1 + s]: stage s
  float* bias_s = reinterpret_cast<float*>(bars + 8);  // [STAGES][64]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * hp::TILE;
  const int plane = b * H + h;
  const int tid = threadIdx.x, lane = tid & 31, c = lane & 3;
  const int nt = (Tk + hp::TILE - 1) / hp::TILE;
  const float* bb = bias + (size_t)b * bias_rows * Tk;
  // the dropout site's Philox key: the step key (device memory) mixed
  // with the site's salt
  const unsigned long long site = DROPOUT ? mtvaf::site_key(key, salt) : 0;
  const unsigned seed_lo = (unsigned)site, seed_hi = (unsigned)(site >> 32);
  // The bias * log2(e) of key tile `tile` into stage `st`, -inf past T (one
  // row of bias serves every query).
  auto stage_bias = [&](int st, int tile) {
    if (bias_rows == 1 && tid < 64) {
      const int col = tile * hp::TILE + tid;
      bias_s[st * 64 + tid] = col < Tk ? bb[col] * LOG2E : -CUDART_INF_F;
    }
  };
  for (int s = 0; s < STAGES && s < nt; ++s) stage_bias(s, s);

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) hp::mbar_init(&bars[i], 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hp::mbar_expect_tx(&bars[0], hp::TILE_BYTES);
    hp::tma_load_tile(qs, &qmap, &bars[0], q0, plane);
    for (int s = 0; s < STAGES && s < nt; ++s) {
      hp::mbar_expect_tx(&bars[1 + s], 2 * hp::TILE_BYTES);
      hp::tma_load_tile(ks + s * hp::TILE_BYTES, &kmap, &bars[1 + s],
                        s * hp::TILE, plane);
      hp::tma_load_tile(vs + s * hp::TILE_BYTES, &vmap, &bars[1 + s],
                        s * hp::TILE, plane);
    }
  }

  // This thread's two rows (see hopper.cuh for the accumulator layout).
  const int row0 = q0 + 16 * (tid >> 5) + (lane >> 2), row1 = row0 + 8;
  // this thread's rows of a per-row bias (bias_rows == S)
  const float* bp0 = bias_rows == 1 ? bb : bb + (size_t)min(row0, S - 1) * Tk;
  const float* bp1 = bias_rows == 1 ? bb : bb + (size_t)min(row1, S - 1) * Tk;
  const float qscale = scale * LOG2E;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float acc[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sc[i] = 0.f;

  hp::mbar_wait(&bars[0], 0);
  const uint64_t qdesc = hp::desc(qs);
  for (int j = 0; j < nt; ++j) {
    const int s = j % STAGES;
    hp::mbar_wait(&bars[1 + s], (j / STAGES) & 1);
    hp::wgmma_fence();
    hp::gemm_ss(sc, qdesc, hp::desc(ks + s * hp::TILE_BYTES));
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_regs(sc);

    // scores in base 2, s2 = (q.k * scale + bias) * log2(e); t >= T -> -inf
    const int t0 = j * hp::TILE;
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
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i >> 1) & 1) mx1 = fmaxf(mx1, sc[i]); else mx0 = fmaxf(mx0, sc[i]);
    }
    // finite: key t0 < T is always valid
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = hp::ex2(m0 - mn0), corr1 = hp::ex2(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool second = (i >> 1) & 1;
      const float p = hp::ex2(sc[i] - (second ? mn1 : mn0));
      sc[i] = p;
      if (second) ps1 += p; else ps0 += p;
    }
    l0 = l0 * corr0 + ps0;      // per-thread partial sums, joined at the end
    l1 = l1 * corr1 + ps1;
    m0 = mn0;
    m1 = mn1;
    if (DROPOUT) {   // after l: the lse stays the dropout-free statistic
      const uint32_t keep = hp::keep_mask_query_rows(
          b, h + head_offset, row0, row1, t0, seed_lo, seed_hi, threshold);
      words[hp::keep_word_index(plane, blockIdx.x, gridDim.x, j, nt)] = keep;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] *= (keep >> i) & 1 ? keep_scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= (i >> 1) & 1 ? corr1 : corr0;

    uint32_t pa[16];
    hp::pack_a(pa, sc);
    hp::wgmma_fence();
    hp::gemm_rs(acc, pa, hp::desc(vs + s * hp::TILE_BYTES));
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_regs(acc);

    __syncthreads();   // every warp is past stage s: refill it
    if (j + STAGES < nt) {
      if (tid == 0) {
        hp::mbar_expect_tx(&bars[1 + s], 2 * hp::TILE_BYTES);
        hp::tma_load_tile(ks + s * hp::TILE_BYTES, &kmap, &bars[1 + s],
                          (j + STAGES) * hp::TILE, plane);
        hp::tma_load_tile(vs + s * hp::TILE_BYTES, &vmap, &bars[1 + s],
                          (j + STAGES) * hp::TILE, plane);
      }
      stage_bias(s, j + STAGES);
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    const int col = 8 * n8 + 2 * c;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)plane * S + row0) * 64 +
                                         col) =
          __floats2bfloat162_rn(acc[4 * n8] * inv0, acc[4 * n8 + 1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)plane * S + row1) * 64 +
                                         col) =
          __floats2bfloat162_rn(acc[4 * n8 + 2] * inv1,
                                acc[4 * n8 + 3] * inv1);
  }
  // back to natural log: lse = (m + log2 l) / log2(e)
  if (c == 0 && row0 < S) lse[(size_t)plane * S + row0] = (m0 + log2f(l0)) / LOG2E;
  if (c == 0 && row1 < S) lse[(size_t)plane * S + row1] = (m1 + log2f(l1)) / LOG2E;
}

int launch_bf16(const void* q, const void* k, const void* v,
                const float* bias, void* o, float* lse, uint32_t* words,
                int B, int H, int S, int Tk, int bias_rows, float scale,
                const long long* key, unsigned long long salt,
                unsigned threshold, float keep_scale, int head_offset,
                cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!hp::make_tile_map(&qm, q, S, B * H) ||
      !hp::make_tile_map(&km, k, Tk, B * H) ||
      !hp::make_tile_map(&vm, v, Tk, B * H))
    return -2;
  dim3 grid((S + hp::TILE - 1) / hp::TILE, H, B);
  auto kernel = threshold ? fwd_bf16_kernel<true> : fwd_bf16_kernel<false>;
  kernel<<<grid, 128, FWD_SMEM, stream>>>(
      qm, km, vm, bias, static_cast<__nv_bfloat16*>(o), lse, words, H, S, Tk,
      bias_rows, scale, key, salt, threshold, keep_scale, head_offset);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The fp32 route: split-TF32 wgmma fed by TMA.

// Q, K and V^T hi and lo (K and V land raw in K hi and V^T lo); barriers,
// the bias row, alignment: 99,648 bytes, two blocks to an SM.
constexpr int FWD32_SMEM = 6 * hp::F32_TILE_BYTES + 64 + 64 * 4 + 1024;

template <bool DROPOUT>
__global__ void __launch_bounds__(128, 2)
fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const float* __restrict__ bias, float* __restrict__ o,
                  float* __restrict__ lse, uint32_t* __restrict__ words,
                  int H, int S, int Tk, int bias_rows, float scale,
                  const long long* __restrict__ key, unsigned long long salt,
                  unsigned threshold, float keep_scale, int head_offset) {
  constexpr int TB = hp::F32_TILE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hp::align1024(smem_raw);
  unsigned char* qh = sm;
  unsigned char* ql = sm + TB;
  unsigned char* kh = sm + 2 * TB;
  unsigned char* kl = sm + 3 * TB;
  unsigned char* vth = sm + 4 * TB;
  unsigned char* vtl = sm + 5 * TB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + 6 * TB);  // q; k, v
  float* bias_s = reinterpret_cast<float*>(bars + 8);          // [64]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * hp::TILE;
  const int plane = b * H + h;
  const int tid = threadIdx.x, lane = tid & 31, c = lane & 3;
  const int nt = (Tk + hp::TILE - 1) / hp::TILE;
  const float* bb = bias + (size_t)b * bias_rows * Tk;
  // the dropout site's Philox key: the step key (device memory) mixed
  // with the site's salt
  const unsigned long long site = DROPOUT ? mtvaf::site_key(key, salt) : 0;
  const unsigned seed_lo = (unsigned)site, seed_hi = (unsigned)(site >> 32);

  if (tid == 0) {
    hp::mbar_init(&bars[0], 1);
    hp::mbar_init(&bars[1], 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hp::mbar_expect_tx(&bars[0], TB);
    hp::tma_load_f32_tile(qh, &qmap, &bars[0], q0, plane);
    hp::mbar_expect_tx(&bars[1], 2 * TB);
    hp::tma_load_f32_tile(kh, &kmap, &bars[1], 0, plane);
    hp::tma_load_f32_tile(vtl, &vmap, &bars[1], 0, plane);
  }

  // This thread's two rows (see hopper.cuh for the accumulator layout).
  const int row0 = q0 + 16 * (tid >> 5) + (lane >> 2), row1 = row0 + 8;
  // this thread's rows of a per-row bias (bias_rows == S)
  const float* bp0 = bias_rows == 1 ? bb : bb + (size_t)min(row0, S - 1) * Tk;
  const float* bp1 = bias_rows == 1 ? bb : bb + (size_t)min(row1, S - 1) * Tk;
  const float qscale = scale * LOG2E;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float acc[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sc[i] = 0.f;

  hp::mbar_wait(&bars[0], 0);
  hp::split_tile<true, false>(qh, qh, ql, nullptr, nullptr);
  const uint64_t qhd = hp::desc(qh), qld = hp::desc(ql);
  const uint64_t khd = hp::desc(kh), kld = hp::desc(kl);
  const uint64_t vthd = hp::desc(vth), vtld = hp::desc(vtl);
  for (int j = 0; j < nt; ++j) {
    const int t0 = j * hp::TILE;
    // the key tile's bias * log2(e), -inf past T (one row of bias serves
    // every query), read before the wait
    const float bias_v = bias_rows == 1 && tid < 64
        ? (t0 + tid < Tk ? bb[t0 + tid] * LOG2E : -CUDART_INF_F) : 0.f;
    hp::mbar_wait(&bars[1], j & 1);
    hp::split_tile<true, false>(kh, kh, kl, nullptr, nullptr);
    {   // V lands in V^T lo: every thread reads its share before any writes
      float4 x[8];
      hp::load_chunks(vtl, x);
      __syncthreads();
      hp::store_split<false, true>(x, nullptr, nullptr, vth, vtl);
    }
    if (bias_rows == 1 && tid < 64) bias_s[tid] = bias_v;
    hp::fence_proxy_async();
    __syncthreads();

    hp::wgmma_fence();
    hp::gemm3_ss(sc, qhd, qld, khd, kld);
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_regs(sc);

    // scores in base 2, s2 = (q.k * scale + bias) * log2(e); t >= T -> -inf
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
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i >> 1) & 1) mx1 = fmaxf(mx1, sc[i]); else mx0 = fmaxf(mx0, sc[i]);
    }
    // finite: key t0 < T is always valid
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = hp::ex2(m0 - mn0), corr1 = hp::ex2(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool second = (i >> 1) & 1;
      const float p = hp::ex2(sc[i] - (second ? mn1 : mn0));
      sc[i] = p;
      if (second) ps1 += p; else ps0 += p;
    }
    l0 = l0 * corr0 + ps0;      // per-thread partial sums, joined at the end
    l1 = l1 * corr1 + ps1;
    m0 = mn0;
    m1 = mn1;
    if (DROPOUT) {   // after l: the lse stays the dropout-free statistic
      const uint32_t keep = hp::keep_mask_query_rows(
          b, h + head_offset, row0, row1, t0, seed_lo, seed_hi, threshold);
      words[hp::keep_word_index(plane, blockIdx.x, gridDim.x, j, nt)] = keep;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] *= (keep >> i) & 1 ? keep_scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= (i >> 1) & 1 ? corr1 : corr0;

    uint32_t ph[32], pl[32];
    hp::split_a(ph, pl, sc);
    hp::wgmma_fence();
    hp::gemm3_rs(acc, ph, pl, vthd, vtld);
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_regs(acc);
    __syncthreads();   // K and V^T are no longer read: load the next pair
    if (tid == 0 && j + 1 < nt) {
      hp::mbar_expect_tx(&bars[1], 2 * TB);
      hp::tma_load_f32_tile(kh, &kmap, &bars[1], t0 + hp::TILE, plane);
      hp::tma_load_f32_tile(vtl, &vmap, &bars[1], t0 + hp::TILE, plane);
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    const int col = 8 * n8 + 2 * c;
    if (row0 < S)
      *reinterpret_cast<float2*>(o + ((size_t)plane * S + row0) * 64 + col) =
          make_float2(acc[4 * n8] * inv0, acc[4 * n8 + 1] * inv0);
    if (row1 < S)
      *reinterpret_cast<float2*>(o + ((size_t)plane * S + row1) * 64 + col) =
          make_float2(acc[4 * n8 + 2] * inv1, acc[4 * n8 + 3] * inv1);
  }
  if (c == 0 && row0 < S) lse[(size_t)plane * S + row0] = (m0 + log2f(l0)) / LOG2E;
  if (c == 0 && row1 < S) lse[(size_t)plane * S + row1] = (m1 + log2f(l1)) / LOG2E;
}

int launch_fp32(const void* q, const void* k, const void* v,
                const float* bias, void* o, float* lse, uint32_t* words,
                int B, int H, int S, int Tk, int bias_rows, float scale,
                const long long* key, unsigned long long salt,
                unsigned threshold, float keep_scale, int head_offset,
                cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!hp::make_tile_map(&qm, q, S, B * H, 4) ||
      !hp::make_tile_map(&km, k, Tk, B * H, 4) ||
      !hp::make_tile_map(&vm, v, Tk, B * H, 4))
    return -2;
  auto kernel = threshold ? fwd_tf32x3_kernel<true> : fwd_tf32x3_kernel<false>;
  // above the default 48 KB of dynamic shared memory (set per launch: the
  // attribute belongs to the current device)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD32_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + hp::TILE - 1) / hp::TILE, H, B);
  kernel<<<grid, 128, FWD32_SMEM, stream>>>(
      qm, km, vm, bias, static_cast<float*>(o), lse, words, H, S, Tk,
      bias_rows, scale, key, salt, threshold, keep_scale, head_offset);
  return static_cast<int>(cudaGetLastError());
}

// The 0/1 keep mask of every (b, h, row, col).  What bounds it is the
// store of the fp32 mask (4 bytes an element; 28.3 MB at the train shape,
// B=32, H=12, S=128, T=144: 8.45 us at 3.35 TB/s) against ten Philox
// rounds per four elements on the integer units.  So a block takes one
// (b, h) plane (blockIdx.x) and MASK_GROUPS * 256 consecutive four-column
// groups of it (blockIdx.y): the plane's b and h are one division per
// thread, a group's row and column one 32-bit division (a grid-stride loop
// over 64-bit indices spent four 64-bit divisions per group), and thread t
// takes groups t, t + 256, ..., so that each store instruction of a warp
// covers contiguous memory.  Where T % 4 == 0 a group is one float4 store;
// else four scalar ones.
constexpr int MASK_THREADS = 256, MASK_GROUPS = 4;

template <bool VEC4>
__global__ void __launch_bounds__(MASK_THREADS)
keep_mask_kernel(float* __restrict__ out, int H, int S, int Tk,
                 const long long* __restrict__ key, unsigned long long salt,
                 unsigned threshold, int head_offset) {
  const unsigned long long site = mtvaf::site_key(key, salt);
  const unsigned k0 = (unsigned)site, k1 = (unsigned)(site >> 32);
  const int plane = blockIdx.x, b = plane / H, h = plane - b * H;
  const int tg = (Tk + 3) >> 2, groups = S * tg;
  float* dst = out + (size_t)plane * S * Tk;
  const int g0 = blockIdx.y * MASK_THREADS * MASK_GROUPS + threadIdx.x;
#pragma unroll
  for (int k = 0; k < MASK_GROUPS; ++k) {
    const int g = g0 + k * MASK_THREADS;
    if (g >= groups) break;
    const int row = g / tg, col4 = g - row * tg;
    const uint4 r = mtvaf::keep_bits4(b, h + head_offset, row, col4, k0, k1);
    const float4 m = make_float4(r.x >= threshold ? 1.f : 0.f,
                                 r.y >= threshold ? 1.f : 0.f,
                                 r.z >= threshold ? 1.f : 0.f,
                                 r.w >= threshold ? 1.f : 0.f);
    if (VEC4) {
      reinterpret_cast<float4*>(dst)[g] = m;    // row * tg + col4 == g
    } else {
      float* d = dst + (size_t)row * Tk + 4 * col4;
      const int left = Tk - 4 * col4;
      d[0] = m.x;
      if (left > 1) d[1] = m.y;
      if (left > 2) d[2] = m.z;
      if (left > 3) d[3] = m.w;
    }
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32 (split-TF32
// wgmma kernel), 1 = bfloat16 (wgmma kernel); q, k, v 16-byte aligned.
// threshold 0 turns dropout off; head_offset is the global index of head 0.
// With dropout the forward writes its keep words to `words`, uint32
// B*H*ceil(S/64)*ceil(T/64)*128 (layout in hopper.cuh); without, it writes
// nothing there (null is fine).  Each returns cudaGetLastError() after the
// launch (0 on success, -1 for a head dimension or type this kernel was not
// compiled for, -2 when the driver refuses a tensor map).
extern "C" int mtvaf_prefix_attention_fwd(
    const void* q, const void* k, const void* v, const float* bias, void* o,
    float* lse, uint32_t* words, int B, int H, int S, int Tk, int D,
    int bias_rows, float scale, int dtype, const long long* key,
    unsigned long long salt, unsigned threshold, float keep_scale,
    int head_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64) return -1;
  if (dtype == 1)
    return launch_bf16(q, k, v, bias, o, lse, words, B, H, S, Tk, bias_rows,
                       scale, key, salt, threshold, keep_scale,
                       head_offset, st);
  if (dtype != 0) return -1;
  return launch_fp32(q, k, v, bias, o, lse, words, B, H, S, Tk, bias_rows,
                     scale, key, salt, threshold, keep_scale,
                     head_offset, st);
}

// Dynamic shared memory of one block of the fp32 (dtype 0) or bf16 (dtype
// 1) kernel, in bytes (ptxas does not see it).
extern "C" int mtvaf_prefix_attention_fwd_smem(int dtype) {
  return dtype == 0 ? FWD32_SMEM : FWD_SMEM;
}

// out (B, H, S, T) fp32, 16-byte aligned: 1 where the forward and backward
// keep the element, under the Philox key mix(*key, salt).
extern "C" int mtvaf_prefix_attention_keep_mask(
    float* out, int B, int H, int S, int Tk, const long long* key,
    unsigned long long salt, unsigned threshold, int head_offset,
    void* stream) {
  const long long groups = (long long)S * ((Tk + 3) / 4);
  const long long per_block = MASK_THREADS * MASK_GROUPS;
  const long long chunks = (groups + per_block - 1) / per_block;
  if (chunks > 65535) return -1;              // gridDim.y's limit
  dim3 grid(B * H, (unsigned)chunks);
  auto kernel = Tk % 4 == 0 ? keep_mask_kernel<true> : keep_mask_kernel<false>;
  kernel<<<grid, MASK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      out, H, S, Tk, key, salt, threshold, head_offset);
  return static_cast<int>(cudaGetLastError());
}
