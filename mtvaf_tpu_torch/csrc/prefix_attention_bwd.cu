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
// time.  So it is memory-bound on the card's budget.
//
// Design (simple and right first; the TPU kernel's grid runs in order on one
// core and carries dq across KV chunks, Hopper blocks run in no order): two
// passes, each block owning its outputs, no atomics, deterministic.  Each
// row of 64 head dims belongs to a pair of neighbouring threads, 32 dims
// each: a thread's fp32 accumulators then take 64 registers (a thread per
// row needed 255 and spilled), and a dot product is two half sums joined by
// one shuffle.
//   (a) dq pass: one block per (64-query tile, h, b).  A pair keeps its q
//       row and its fp32 dq in registers and its do row in shared memory,
//       computes delta (written to an fp32 scratch for pass (b)), and
//       streams K and V through shared memory in KC-row chunks,
//       recomputing p from the lse; dropout bits come four keys per Philox
//       call.
//   (b) dk/dv pass: one block per (64-key tile, h, b).  A pair keeps its k
//       and v rows in shared memory and its fp32 dk and dv in registers,
//       and streams q, do, lse and delta through shared memory in QC-row
//       chunks; one Philox call per element.
// Shared-memory rows are padded so that the two halves of a row sit one
// bank apart: the pairs of a warp read their own rows, and the chunk rows
// they all read, without bank conflicts.  The ragged edges (T = 144 or 528
// keys, S query rows) are masked by bounds.  The products run on the CUDA
// cores in fp32 and each pass recomputes the scores, so this version is far
// from its bound (times in PERF.md); wgmma tiles fed by TMA come in a later
// change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "philox.cuh"

namespace {

constexpr int BQ = 64;      // query rows per dq block (a thread pair each)
constexpr int KC = 32;      // key/value rows per shared-memory chunk (dq pass)
constexpr int BK = 64;      // key rows per dk/dv block (a thread pair each)
constexpr int QC = 16;      // query rows per shared-memory chunk (dk/dv pass)
constexpr int HALF = 32;    // head dims per thread (D = 64 in two halves)
constexpr int ROW = 2 * (HALF + 1);   // padded shared-memory row
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Element (r, c) of a chunk of 64-wide rows: the half c / 32 starts HALF + 1
// floats after the other, one bank over.
__device__ __forceinline__ int sidx(int r, int c) {
  return r * ROW + (c / HALF) * (HALF + 1) + c % HALF;
}

// The pair's sum of a half dot product.
__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(FULL, x, 1);
}

struct Dropout {
  unsigned seed_lo, seed_hi, threshold;
  float keep_scale;
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
        bits = mtvaf::keep_bits4(b, h, row, (t0 + j4) >> 2, dr.seed_lo,
                                 dr.seed_hi);
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
        keep = mtvaf::keep_bits(b, h, row, col, dr.seed_lo, dr.seed_hi)
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

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16;
// threshold 0 turns dropout off.  delta is an fp32 (B, H, S) scratch.  Two
// launches on `stream` (dq pass, then dk/dv pass); returns the first non-zero
// cudaGetLastError() (0 on success, -1 for a head dimension or type this
// kernel was not compiled for).
extern "C" int mtvaf_prefix_attention_bwd(
    const void* q, const void* k, const void* v, const float* bias,
    const void* o, const float* lse, const void* dout, void* dq, void* dk,
    void* dv, float* delta, int B, int H, int S, int Tk, int D,
    int bias_rows, float scale, int dtype, unsigned seed_lo,
    unsigned seed_hi, unsigned threshold, float keep_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed_lo, seed_hi, threshold, keep_scale};
  if (D != 2 * HALF) return -1;
  if (dtype == 1)
    return launch_any<__nv_bfloat16>(q, k, v, bias, o, lse, dout, dq, dk, dv,
                                     delta, B, H, S, Tk, bias_rows, scale, dr,
                                     st);
  if (dtype == 0)
    return launch_any<float>(q, k, v, bias, o, lse, dout, dq, dk, dv, delta,
                             B, H, S, Tk, bias_rows, scale, dr, st);
  return -1;
}
