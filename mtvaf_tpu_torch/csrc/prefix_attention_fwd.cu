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
// tensor-core time (the train shape, B=32, doubles both).
//
// Design (simple and right first): one block of BQ threads per
// (query tile, head, batch), one thread per query row.  Each thread keeps its
// q row and its fp32 accumulator in registers.  K and V stream through shared
// memory in KT-row chunks (converted to fp32 on load, so every thread reads
// the same key row: a shared-memory broadcast, no bank conflicts).  The
// softmax is online: each 16-key group updates the running max m, the running
// sum l and rescales the accumulator once; with dropout the group's
// probabilities are multiplied by their keep factors after they entered l,
// four keys per Philox call.  Keys at t >= T (the ragged tail; 144 and 528
// are not multiples of the chunk) are masked to -inf and query rows at
// s >= S are neither loaded nor stored.  The products run on the CUDA cores
// in fp32 (0.91 GFLOP at 67 TFLOP/s is 13.5 us, above the memory bound), and
// each block re-reads K and V: this first version is far from the bound
// (times in PERF.md).  wgmma tiles fed by TMA come in a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "philox.cuh"

namespace {

constexpr int BQ = 64;      // query rows (= threads) per block
constexpr int KT = 64;      // key/value rows per shared-memory chunk
constexpr int KG = 16;      // keys per online-softmax group

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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
  constexpr float LOG2E = 1.4426950408889634f;
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

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const float* bias,
            void* o, float* lse, int B, int H, int S, int Tk, int bias_rows,
            float scale, unsigned seed_lo, unsigned seed_hi,
            unsigned threshold, float keep_scale, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  auto kernel = threshold ? prefix_attention_fwd_kernel<T, D, true>
                          : prefix_attention_fwd_kernel<T, D, false>;
  kernel<<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), lse, H, S, Tk,
      bias_rows, scale, seed_lo, seed_hi, threshold, keep_scale);
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

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// threshold 0 turns dropout off.  Each returns cudaGetLastError() after the
// launch (0 on success, -1 for a head dimension or type this kernel was not
// compiled for).
extern "C" int mtvaf_prefix_attention_fwd(
    const void* q, const void* k, const void* v, const float* bias, void* o,
    float* lse, int B, int H, int S, int Tk, int D, int bias_rows,
    float scale, int dtype, unsigned seed_lo, unsigned seed_hi,
    unsigned threshold, float keep_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) {
    launch<__nv_bfloat16, 64>(q, k, v, bias, o, lse, B, H, S, Tk, bias_rows,
                              scale, seed_lo, seed_hi, threshold, keep_scale,
                              st);
  } else if (dtype == 0 && D == 64) {
    launch<float, 64>(q, k, v, bias, o, lse, B, H, S, Tk, bias_rows, scale,
                      seed_lo, seed_hi, threshold, keep_scale, st);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

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
