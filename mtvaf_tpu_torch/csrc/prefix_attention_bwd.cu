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
// (dbias is zero: the bias is a constant mask.)  keep comes from the same
// Philox bits as the forward (philox.cuh, keyed on (seed, b, h, row, col)), so
// the masks agree element by element whatever the tiling of either kernel.
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
// The mask is drawn once per backward: the dq pass draws a tile's keep
// bits (8 Philox calls per thread, shared by lane pairs, hopper.cuh) and
// stores them, one 32-bit word per thread (1.2 MB at the train shape),
// after delta in the scratch; the dk/dv pass stages a tile's 128 words with
// its stage and picks its own bits out by a fixed transpose.  Drawing the
// mask again there, where the four words of a Philox call fall in four
// lanes, took most of that pass's dropout time.
// A dk/dv block holds two 64 x 64 fp32 accumulators across its loop; it
// keeps dV's in shared memory outside dV's products, so that it fits in
// 168 registers, three blocks to an SM, without spilling (at two blocks to
// an SM the pass ran in five waves at the train shape).
// dS and P enter their products as bf16 pairs (hi + lo, two wgmmas each):
// rounded to one bf16, as the forward's P is, they moved the gradients by
// one bf16 ulp against the plain fp32 backward (0.0156 at |g| >= 2) past
// its 1e-2 tolerance.
//
// fp32: wgmma has no fp32 operand (only TF32, which would miss the fp32
// tolerances), so fp32 stays on the CUDA cores.  Each row of 64 head dims
// belongs to a pair of neighbouring threads, 32 dims each (a thread per row
// needed 255 registers and spilled); a dot product is two half sums joined
// by one shuffle.
//   (a) dq pass: one block per (64-query tile, h, b).  A pair keeps its q
//       row and its fp32 dq in registers and its do row in shared memory,
//       computes delta, and streams K and V through shared memory in KC-row
//       chunks; dropout bits come four keys per Philox call.
//   (b) dk/dv pass: one block per (64-key tile, h, b).  A pair keeps its k
//       and v rows in shared memory and its fp32 dk and dv in registers,
//       and streams q, do, lse and delta through shared memory in QC-row
//       chunks; one Philox call per element.
// Shared-memory rows are padded so that the two halves of a row sit one
// bank apart.  The ragged edges are masked by bounds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

// ---------------------------------------------------------------------------
// The fp32 route: CUDA cores.

constexpr int BQ = 64;      // query rows per dq block (a thread pair each)
constexpr int KC = 32;      // key/value rows per shared-memory chunk (dq pass)
constexpr int BK = 64;      // key rows per dk/dv block (a thread pair each)
constexpr int QC = 16;      // query rows per shared-memory chunk (dk/dv pass)
constexpr int HALF = 32;    // head dims per thread (D = 64 in two halves)
constexpr int ROW = 2 * (HALF + 1);   // padded shared-memory row
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }

// Element (r, c) of a chunk of 64-wide rows: the half c / 32 starts HALF + 1
// floats after the other, one bank over.
__device__ __forceinline__ int sidx(int r, int c) {
  return r * ROW + (c / HALF) * (HALF + 1) + c % HALF;
}

// The pair's sum of a half dot product.
__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(FULL, x, 1);
}

// head_offset: the global index of head 0 of this call (the Philox
// counter's head word is h + head_offset).
struct Dropout {
  unsigned seed_lo, seed_hi, threshold;
  float keep_scale;
  int head_offset;
};

template <typename T, bool DROPOUT>
__global__ void __launch_bounds__(2 * BQ)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ bias,
          const T* __restrict__ o, const float* __restrict__ lse,
          const T* __restrict__ dout, T* __restrict__ dq,
          float* __restrict__ delta_out, int H, int S, int Tk, int bias_rows,
          float scale, Dropout dr) {
  constexpr int D = 2 * HALF;
  __shared__ float dos[BQ * ROW];
  __shared__ float ks[KC * ROW];
  __shared__ float vs[KC * ROW];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int r = threadIdx.x / 2, half = threadIdx.x % 2;
  const int row = blockIdx.x * BQ + r;
  const bool active = row < S;
  const size_t bh = (size_t)b * H + h;
  const size_t qoff = (bh * S + (active ? row : 0)) * D + half * HALF;
  const T* kp = k + bh * Tk * D;
  const T* vp = v + bh * Tk * D;
  const float* bp = bias + ((size_t)b * bias_rows
                            + (bias_rows == 1 ? 0 : (active ? row : 0))) * Tk;
  float* my_do = dos + r * ROW + half * (HALF + 1);

  // Scores in base 2: s2 = (q.k * scale + bias) * log2(e).
  const float qscale = scale * LOG2E;
  float qr[HALF];
  float acc[HALF];
  float delta = 0.f;
#pragma unroll
  for (int d = 0; d < HALF; ++d) {
    const float dd = active ? to_f32(dout[qoff + d]) : 0.f;
    my_do[d] = dd;
    delta = fmaf(dd, active ? to_f32(o[qoff + d]) : 0.f, delta);
    qr[d] = active ? to_f32(q[qoff + d]) * qscale : 0.f;
    acc[d] = 0.f;
  }
  delta = pair_sum(delta);
  if (active && half == 0) delta_out[bh * S + row] = delta;
  const float lse2 = active ? lse[bh * S + row] * LOG2E : 0.f;

  for (int t0 = 0; t0 < Tk; t0 += KC) {
    __syncthreads();   // the previous chunk is no longer read
    for (int i = threadIdx.x; i < KC * D; i += 2 * BQ) {
      const int rr = i / D, c = i % D;
      const bool in = t0 + rr < Tk;
      ks[sidx(rr, c)] = in ? to_f32(kp[(size_t)(t0 + rr) * D + c]) : 0.f;
      vs[sidx(rr, c)] = in ? to_f32(vp[(size_t)(t0 + rr) * D + c]) : 0.f;
    }
    __syncthreads();

    const int n = min(KC, Tk - t0);          // the same for the whole block
    for (int j4 = 0; j4 < n; j4 += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT)
        bits = mtvaf::keep_bits4(b, h + dr.head_offset, row, (t0 + j4) >> 2,
                                 dr.seed_lo, dr.seed_hi);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j4 + jj;
        if (j >= n) break;
        const float* kr = ks + j * ROW + half * (HALF + 1);
        const float* vr = vs + j * ROW + half * (HALF + 1);
        float sdot = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < HALF; ++d) {
          sdot = fmaf(qr[d], kr[d], sdot);
          dp = fmaf(my_do[d], vr[d], dp);
        }
        sdot = pair_sum(sdot);
        dp = pair_sum(dp);
        const float p = exp2f(fmaf(bp[t0 + j], LOG2E, sdot) - lse2);
        if (DROPOUT)
          dp *= mtvaf::word(bits, jj) >= dr.threshold ? dr.keep_scale : 0.f;
        const float ds = p * (dp - delta);
#pragma unroll
        for (int d = 0; d < HALF; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int d = 0; d < HALF; ++d) from_f32(dq + qoff + d, acc[d] * scale);
}

template <typename T, bool DROPOUT>
__global__ void __launch_bounds__(2 * BK)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ bias,
            const float* __restrict__ lse, const T* __restrict__ dout,
            const float* __restrict__ delta_in, T* __restrict__ dk,
            T* __restrict__ dv, int H, int S, int Tk, int bias_rows,
            float scale, Dropout dr) {
  constexpr int D = 2 * HALF;
  __shared__ float kown[BK * ROW];
  __shared__ float vown[BK * ROW];
  __shared__ float qs[QC * ROW];
  __shared__ float dos[QC * ROW];
  __shared__ float lses[QC];
  __shared__ float deltas[QC];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int r = threadIdx.x / 2, half = threadIdx.x % 2;
  const int col = blockIdx.x * BK + r;
  const bool active = col < Tk;
  const size_t bh = (size_t)b * H + h;
  const size_t koff = (bh * Tk + (active ? col : 0)) * D + half * HALF;
  const T* qp = q + bh * S * D;
  const T* dop = dout + bh * S * D;
  const float* bb = bias + (size_t)b * bias_rows * Tk;
  float* mk = kown + r * ROW + half * (HALF + 1);
  float* mv = vown + r * ROW + half * (HALF + 1);

  const float qscale = scale * LOG2E;
  float dka[HALF];
  float dva[HALF];
#pragma unroll
  for (int d = 0; d < HALF; ++d) {     // each thread reads back only its own
    mk[d] = active ? to_f32(k[koff + d]) : 0.f;
    mv[d] = active ? to_f32(v[koff + d]) : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += QC) {
    __syncthreads();   // the previous chunk is no longer read
    for (int i = threadIdx.x; i < QC * D; i += 2 * BK) {
      const int rr = i / D, c = i % D;
      const bool in = s0 + rr < S;
      qs[sidx(rr, c)] = in ? to_f32(qp[(size_t)(s0 + rr) * D + c]) : 0.f;
      dos[sidx(rr, c)] = in ? to_f32(dop[(size_t)(s0 + rr) * D + c]) : 0.f;
    }
    if (threadIdx.x < QC) {
      const bool in = s0 + threadIdx.x < S;
      lses[threadIdx.x] = in ? lse[bh * S + s0 + threadIdx.x] * LOG2E : 0.f;
      deltas[threadIdx.x] = in ? delta_in[bh * S + s0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    const int n = min(QC, S - s0);
    for (int i = 0; i < n; ++i) {
      const int row = s0 + i;
      const float* qr = qs + i * ROW + half * (HALF + 1);
      const float* dr_ = dos + i * ROW + half * (HALF + 1);
      float sdot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HALF; ++d) {
        sdot = fmaf(mk[d], qr[d], sdot);
        dp = fmaf(mv[d], dr_[d], dp);
      }
      sdot = pair_sum(sdot);
      dp = pair_sum(dp);
      const float bval =
          active ? bb[(size_t)(bias_rows == 1 ? 0 : row) * Tk + col] : 0.f;
      const float p = active
          ? exp2f(fmaf(sdot, qscale, bval * LOG2E) - lses[i]) : 0.f;
      float keep = 1.f;
      if (DROPOUT)
        keep = mtvaf::keep_bits(b, h + dr.head_offset, row, col, dr.seed_lo,
                                dr.seed_hi)
            >= dr.threshold ? dr.keep_scale : 0.f;
      const float y = p * keep;
      const float ds = p * (dp * keep - deltas[i]);
#pragma unroll
      for (int d = 0; d < HALF; ++d) {
        dva[d] = fmaf(y, dr_[d], dva[d]);
        dka[d] = fmaf(ds, qr[d], dka[d]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int d = 0; d < HALF; ++d) {
    from_f32(dk + koff + d, dka[d] * scale);
    from_f32(dv + koff + d, dva[d]);
  }
}

template <typename T, bool DROPOUT>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const void* o, const float* lse, const void* dout, void* dq,
           void* dk, void* dv, float* delta, int B, int H, int S, int Tk,
           int bias_rows, float scale, Dropout dr, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  dq_kernel<T, DROPOUT><<<dim3((S + BQ - 1) / BQ, H, B), 2 * BQ, 0,
                          stream>>>(
      qt, kt, vt, bias, static_cast<const T*>(o), lse, dot,
      static_cast<T*>(dq), delta, H, S, Tk, bias_rows, scale, dr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, DROPOUT><<<dim3((Tk + BK - 1) / BK, H, B), 2 * BK, 0,
                            stream>>>(
      qt, kt, vt, bias, lse, dot, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), H, S, Tk, bias_rows, scale, dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const void* q, const void* k, const void* v, const float* bias,
               const void* o, const float* lse, const void* dout, void* dq,
               void* dk, void* dv, float* delta, int B, int H, int S, int Tk,
               int bias_rows, float scale, Dropout dr, cudaStream_t stream) {
  return dr.threshold
      ? launch<T, true>(q, k, v, bias, o, lse, dout, dq, dk, dv, delta, B, H,
                        S, Tk, bias_rows, scale, dr, stream)
      : launch<T, false>(q, k, v, bias, o, lse, dout, dq, dk, dv, delta, B, H,
                         S, Tk, bias_rows, scale, dr, stream);
}

// ---------------------------------------------------------------------------
// The bf16 route: wgmma fed by TMA.

namespace hp = mtvaf::hopper;
constexpr int STAGES = 2;   // ring depth of the streamed tiles
// A dq-pass block: 2 own tiles + 2 streamed tiles per stage, barriers, 2 KB
// of per-tile vectors (delta, bias by stage), alignment.  A dk/dv-pass block
// has the same (its vectors: lse, delta and keep bits by stage) and dV's
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
               const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
               float* __restrict__ delta_out, uint32_t* __restrict__ bits,
               int H, int S, int Tk, int bias_rows, float scale, Dropout dr) {
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
    hp::mbar_wait(&bars[1 + s], (j / STAGES) & 1);
    hp::wgmma_fence();
    hp::gemm_ss(sc, qdesc, hp::desc(kt));
    hp::gemm_ss(dp, dodesc, hp::desc(vs + s * hp::TILE_BYTES));
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_regs(sc);
    hp::fence_regs(dp);

    const int t0 = j * hp::TILE;
    uint32_t keep = 0xffffffffu;
    if (DROPOUT) {   // drawn here once, read back by the dk/dv pass
      keep = hp::keep_mask_query_rows(b, h + dr.head_offset, row0, row1, t0,
                                      dr.seed_lo, dr.seed_hi, dr.threshold);
      bits[(((size_t)plane * gridDim.x + blockIdx.x) * nt + j) * 128 + tid] =
          keep;
    }
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
      if (DROPOUT) g *= (keep >> i) & 1 ? dr.keep_scale : 0.f;
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
// queries) from the 128 words of a tile that the dq pass stored, one per
// thread in its own accumulator layout (rows queries, columns keys).  There
// element (query r, key t) is bit 4 (t / 8) + 2 ((r / 8) % 2) + t % 2 of
// thread 32 (r / 16) + 4 (r % 8) + (t % 8) / 2.  Here element j is (key
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
                 const uint32_t* __restrict__ bits,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int H, int S, int Tk,
                 int bias_rows, float scale, Dropout dr) {
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
  // keep bits the dq pass drew for (query tile, this key tile).
  auto stage_rows = [&](int st, int tile) {
    if (tid < 64) {
      const int qc = tile * hp::TILE + tid;
      // +inf past S: p = 0 there
      lse_s[st * 64 + tid] = qc < S ? lsep[qc] * LOG2E : CUDART_INF_F;
      dl_s[st * 64 + tid] = qc < S ? dlp[qc] : 0.f;
    }
    if (DROPOUT)
      bits_s[st * 128 + tid] =
          bits[(((size_t)plane * nq + tile) * nk + blockIdx.x) * 128 + tid];
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
      if (DROPOUT) kf = (keep >> i) & 1 ? dr.keep_scale : 0.f;
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
                const void* dout, void* dq, void* dk, void* dv, float* delta,
                int B, int H, int S, int Tk, int bias_rows, float scale,
                Dropout dr, cudaStream_t stream) {
  // the keep bits follow delta in the scratch, 16-byte aligned
  uint32_t* bits = reinterpret_cast<uint32_t*>(
      delta + (((size_t)B * H * S + 3) & ~(size_t)3));
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
      static_cast<const __nv_bfloat16*>(dout), lse,
      static_cast<__nv_bfloat16*>(dq), delta, bits, H, S, Tk, bias_rows, scale,
      dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_bf16_kernel<DROPOUT><<<dim3((Tk + hp::TILE - 1) / hp::TILE, H, B),
                              128, DKDV_SMEM, stream>>>(
      qm, km, vm, dom, bias, lse, delta, bits, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, S, Tk, bias_rows, scale, dr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32 (CUDA-core
// kernels), 1 = bfloat16 (wgmma kernels; q, k, v, o, do 16-byte aligned);
// threshold 0 turns dropout off.  delta is an fp32 scratch: delta (B, H, S),
// then, for bf16 with dropout, from the next 16-byte boundary, the keep bits
// the dq pass draws for the dk/dv pass, B*H*ceil(S/64)*ceil(T/64)*128 32-bit
// words.  Two
// launches on `stream` (dq pass, then dk/dv pass); returns the first non-zero
// cudaGetLastError() (0 on success, -1 for a head dimension or type this
// kernel was not compiled for, -2 when the driver refuses a tensor map).
extern "C" int mtvaf_prefix_attention_bwd(
    const void* q, const void* k, const void* v, const float* bias,
    const void* o, const float* lse, const void* dout, void* dq, void* dk,
    void* dv, float* delta, int B, int H, int S, int Tk, int D,
    int bias_rows, float scale, int dtype, unsigned seed_lo,
    unsigned seed_hi, unsigned threshold, float keep_scale, int head_offset,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed_lo, seed_hi, threshold, keep_scale, head_offset};
  if (D != 2 * HALF) return -1;
  if (dtype == 1)
    return threshold
        ? launch_bf16<true>(q, k, v, bias, o, lse, dout, dq, dk, dv, delta, B,
                            H, S, Tk, bias_rows, scale, dr, st)
        : launch_bf16<false>(q, k, v, bias, o, lse, dout, dq, dk, dv, delta,
                             B, H, S, Tk, bias_rows, scale, dr, st);
  if (dtype == 0)
    return launch_any<float>(q, k, v, bias, o, lse, dout, dq, dk, dv, delta,
                             B, H, S, Tk, bias_rows, scale, dr, st);
  return -1;
}

// Dynamic shared memory of one bf16 block of the dq pass (pass 0) or the
// dk/dv pass (pass 1), in bytes (ptxas does not see it).
extern "C" int mtvaf_prefix_attention_bwd_smem(int pass) {
  return pass == 0 ? DQ_SMEM : DKDV_SMEM;
}
