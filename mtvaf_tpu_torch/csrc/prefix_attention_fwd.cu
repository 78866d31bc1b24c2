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
// from the counter-based Philox bits of philox.cuh keyed on (seed, b, h, s, t);
// the backward kernel (prefix_attention_bwd.cu) regenerates the same bits.
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
// dropout-free), its Philox calls shared by lane pairs (hopper.cuh); then p
// is rounded to bf16 in place and O += P V takes it as the register A
// operand, with V's tile MN-major (the transpose bit).  Query rows at
// s >= S are not stored.  A per-row bias (B, S, T), which the model does not
// use, is read from global memory per element instead.  K and V are read
// once per query tile, the second time from L2.
//
// fp32 (prefix_attention_fwd_kernel): wgmma has no fp32 operand, only TF32,
// which would miss the fp32 tolerances (1e-4 and the fp32 train step held
// against the CPU), so fp32 stays on the CUDA cores: one thread per query
// row, its q row and fp32 accumulator in registers, K and V streamed
// through shared memory in KT-row chunks, an online softmax over 16-key
// groups, dropout four keys per Philox call.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr int BQ = 64;      // query rows (= threads) per block (fp32 route)
constexpr int KT = 64;      // key/value rows per shared-memory chunk (fp32)
constexpr int KG = 16;      // keys per online-softmax group (fp32)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }

// ---------------------------------------------------------------------------
// The fp32 route: CUDA cores.

template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(BQ)
prefix_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ bias,
                            T* __restrict__ o, float* __restrict__ lse,
                            int H, int S, int Tk, int bias_rows, float scale,
                            unsigned seed_lo, unsigned seed_hi,
                            unsigned threshold, float keep_scale) {
  __shared__ float ks[KT][D];
  __shared__ float vs[KT][D];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool active = row < S;
  const size_t bh = (size_t)b * H + h;

  const T* qp = q + (bh * S + (active ? row : 0)) * D;
  const T* kp = k + bh * Tk * D;
  const T* vp = v + bh * Tk * D;
  const float* bp = bias + ((size_t)b * bias_rows + (bias_rows == 1 ? 0 : (active ? row : 0))) * Tk;

  // Scores are kept in base 2: s2 = (q.k * scale + bias) * log2(e).
  const float qscale = scale * LOG2E;
  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f32(qp[d]) * qscale : 0.f;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F;
  float l = 0.f;

  for (int t0 = 0; t0 < Tk; t0 += KT) {
    __syncthreads();   // the previous chunk is no longer read
    for (int i = threadIdx.x; i < KT * D; i += BQ) {
      const int r = i / D, c = i % D;
      const bool in = t0 + r < Tk;
      ks[r][c] = in ? to_f32(kp[(size_t)(t0 + r) * D + c]) : 0.f;
      vs[r][c] = in ? to_f32(vp[(size_t)(t0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    const int n = min(KT, Tk - t0);
    for (int g = 0; g < n; g += KG) {
      float s[KG];
      float gmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[g + j][d], dot);
        s[j] = -CUDART_INF_F;
        if (g + j < n) s[j] = fmaf(bp[t0 + g + j], LOG2E, dot);
        gmax = fmaxf(gmax, s[j]);
      }
      const float m_new = fmaxf(m, gmax);      // finite: key g is always valid
      const float corr = exp2f(m - m_new);      // 0 on the first group
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        s[j] = exp2f(s[j] - m_new);
        psum += s[j];
      }
      l = l * corr + psum;
      m = m_new;
      if (DROPOUT) {   // after l: the lse stays the dropout-free statistic
#pragma unroll
        for (int j = 0; j < KG; j += 4) {
          const uint4 r = mtvaf::keep_bits4(b, h, row, (t0 + g + j) >> 2,
                                            seed_lo, seed_hi);
          s[j] *= r.x >= threshold ? keep_scale : 0.f;
          s[j + 1] *= r.y >= threshold ? keep_scale : 0.f;
          s[j + 2] *= r.z >= threshold ? keep_scale : 0.f;
          s[j + 3] *= r.w >= threshold ? keep_scale : 0.f;
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float a = acc[d] * corr;
#pragma unroll
        for (int j = 0; j < KG; ++j) a = fmaf(s[j], vs[g + j][d], a);
        acc[d] = a;
      }
    }
  }

  if (!active) return;
  const float inv_l = 1.f / l;
  T* op = o + (bh * S + row) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) from_f32(op + d, acc[d] * inv_l);
  // back to natural log: lse = (m + log2 l) / log2(e)
  lse[bh * S + row] = (m + log2f(l)) / LOG2E;
}

void launch_fp32(const void* q, const void* k, const void* v,
                 const float* bias, void* o, float* lse, int B, int H, int S,
                 int Tk, int bias_rows, float scale, unsigned seed_lo,
                 unsigned seed_hi, unsigned threshold, float keep_scale,
                 cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  auto kernel = threshold ? prefix_attention_fwd_kernel<float, 64, true>
                          : prefix_attention_fwd_kernel<float, 64, false>;
  kernel<<<grid, BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(o), lse, H, S,
      Tk, bias_rows, scale, seed_lo, seed_hi, threshold, keep_scale);
}

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
                float* __restrict__ lse, int H, int S, int Tk, int bias_rows,
                float scale, unsigned seed_lo, unsigned seed_hi,
                unsigned threshold, float keep_scale) {
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
          b, h, row0, row1, t0, seed_lo, seed_hi, threshold);
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
                const float* bias, void* o, float* lse, int B, int H, int S,
                int Tk, int bias_rows, float scale, unsigned seed_lo,
                unsigned seed_hi, unsigned threshold, float keep_scale,
                cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!hp::make_tile_map(&qm, q, S, B * H) ||
      !hp::make_tile_map(&km, k, Tk, B * H) ||
      !hp::make_tile_map(&vm, v, Tk, B * H))
    return -2;
  dim3 grid((S + hp::TILE - 1) / hp::TILE, H, B);
  auto kernel = threshold ? fwd_bf16_kernel<true> : fwd_bf16_kernel<false>;
  kernel<<<grid, 128, FWD_SMEM, stream>>>(
      qm, km, vm, bias, static_cast<__nv_bfloat16*>(o), lse, H, S, Tk,
      bias_rows, scale, seed_lo, seed_hi, threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

// The 0/1 keep mask of every (b, h, row, col), one thread per four columns.
__global__ void keep_mask_kernel(float* __restrict__ out, int H, int S,
                                 int Tk, long long n4, unsigned seed_lo,
                                 unsigned seed_hi, unsigned threshold) {
  const int tg = (Tk + 3) / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const int col4 = (int)(i % tg);
    const long long bhs = i / tg;                 // (b * H + h) * S + row
    const int row = (int)(bhs % S);
    const int h = (int)((bhs / S) % H);
    const int b = (int)(bhs / ((long long)S * H));
    const uint4 r = mtvaf::keep_bits4(b, h, row, col4, seed_lo, seed_hi);
    float* dst = out + bhs * Tk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col4 * 4 + j;
      if (col < Tk) dst[col] = mtvaf::word(r, j) >= threshold ? 1.f : 0.f;
    }
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32 (CUDA-core
// kernel), 1 = bfloat16 (wgmma kernel; q, k, v 16-byte aligned).
// threshold 0 turns dropout off.  Each returns cudaGetLastError() after the
// launch (0 on success, -1 for a head dimension or type this kernel was not
// compiled for, -2 when the driver refuses a tensor map).
extern "C" int mtvaf_prefix_attention_fwd(
    const void* q, const void* k, const void* v, const float* bias, void* o,
    float* lse, int B, int H, int S, int Tk, int D, int bias_rows,
    float scale, int dtype, unsigned seed_lo, unsigned seed_hi,
    unsigned threshold, float keep_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64) return -1;
  if (dtype == 1)
    return launch_bf16(q, k, v, bias, o, lse, B, H, S, Tk, bias_rows, scale,
                       seed_lo, seed_hi, threshold, keep_scale, st);
  if (dtype != 0) return -1;
  launch_fp32(q, k, v, bias, o, lse, B, H, S, Tk, bias_rows, scale, seed_lo,
              seed_hi, threshold, keep_scale, st);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one bf16 block, in bytes (ptxas does not see it).
extern "C" int mtvaf_prefix_attention_fwd_smem() { return FWD_SMEM; }

// out (B, H, S, T) fp32: 1 where the forward and backward keep the element.
extern "C" int mtvaf_prefix_attention_keep_mask(
    float* out, int B, int H, int S, int Tk, unsigned seed_lo,
    unsigned seed_hi, unsigned threshold, void* stream) {
  const long long n4 = (long long)B * H * S * ((Tk + 3) / 4);
  const int threads = 256;
  const long long blocks = (n4 + threads - 1) / threads;
  keep_mask_kernel<<<(unsigned)(blocks < 65535 * 32 ? blocks : 65535 * 32),
                     threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, H, S, Tk, n4, seed_lo, seed_hi, threshold);
  return static_cast<int>(cudaGetLastError());
}
