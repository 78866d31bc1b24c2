// Keyed random draws of the train step, for Hopper (sm_90a): a fused
// inverted dropout and a uniform draw, each a pure function of the step key
// (an int64 word in device memory), a static salt and the element index.
//
// Replaces no TPU kernel.  The JAX package draws its dropout masks and its
// cutoff uniforms in XLA from a device key (`dropout` in
// mtvaf_tpu/nn/layers.py, jax.random.bernoulli; the cut draws of
// mtvaf_tpu/train/augment.py), inside one compiled step.  These kernels give
// the port the same shape of randomness: a dropout is one launch keyed on
// the device (no generator, no host draw, no rand + divide + where), and a
// CUDA graph that captured it draws new masks when the key's tensor is given
// a new word before a replay.
//
// Element i's word is word (i & 3) of philox4x32_10(counter = (i >> 2 low
// 32 bits, i >> 2 high 32 bits, 0, 0), key = mix(*key, salt)) (philox.cuh);
// ``kernels/keyed_random.py`` holds the same functions in plain PyTorch.
//
//   dropout: y[i] = word >= threshold ? x[i] / keep_p : 0, in x's type;
//            the quotient is the IEEE fp32 quotient of fp32(x[i]) and
//            keep_p, rounded once to x's type (bf16: nearest even), as
//            the plain version's fp32 division and cast compute it;
//            keep_p is 1 - rate rounded to x's type by the caller
//            (0.8984375 for bf16 at rate 0.1), as the JAX package's
//            weakly typed keep probability rounds.
//   uniform: u[i] = (word >> 8) * 2^-24, fp32 in [0, 1).
//
// What bounds them: bytes.  The dropout reads and writes every element once
// (12.6 MB at the flagship train activation, B=32, S=128, 768, bf16: 3.76
// us at 3.35 TB/s) against one Philox call (ten rounds of two 32-bit
// multiplies) per four elements.  So one thread takes one 16-byte vector
// (4 fp32 or 8 bf16 elements: one or two Philox calls) with one load and
// one store where x and y are 16-byte aligned, element by element where
// they are not or at the tail, and a grid of at most eight 256-thread
// blocks per SM walks the vectors, so that the key is read and mixed once
// per thread, not once per vector.  The uniform draw is a handful of
// elements per step (the cutoff's cuts): four a thread, one Philox call.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float v, float* y) { *y = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* y) {
  *y = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint4 element_bits(long long group, unsigned k0,
                                              unsigned k1) {
  return mtvaf::philox4x32_10(
      make_uint4((unsigned)group, (unsigned)(group >> 32), 0u, 0u), k0, k1);
}

// One thread takes one 16-byte vector of elements (4 fp32, 8 bf16): N / 4
// Philox calls, one 16-byte load and one 16-byte store.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
               const long long* __restrict__ key, unsigned long long salt,
               unsigned threshold, float keep_p, bool vec) {
  constexpr int N = 16 / sizeof(T);
  const unsigned long long site = mtvaf::site_key(key, salt);
  const unsigned k0 = (unsigned)site, k1 = (unsigned)(site >> 32);
  const long long chunks = (n + N - 1) / N;
  for (long long c = blockIdx.x * (long long)THREADS + threadIdx.x;
       c < chunks; c += (long long)gridDim.x * THREADS) {
    unsigned w[N];
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint4 r = element_bits(c * (N / 4) + q, k0, k1);
      w[4 * q] = r.x;
      w[4 * q + 1] = r.y;
      w[4 * q + 2] = r.z;
      w[4 * q + 3] = r.w;
    }
    const long long i0 = c * N;
    if (vec && i0 + N <= n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + i0);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j)
        from_float(w[j] >= threshold ? __fdiv_rn(to_float(e[j]), keep_p)
                                     : 0.f,
                   o + j);
      *reinterpret_cast<uint4*>(y + i0) = out;
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (i0 + j < n) {
          const float v = to_float(x[i0 + j]);
          from_float(w[j] >= threshold ? __fdiv_rn(v, keep_p) : 0.f,
                     y + i0 + j);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
uniform_kernel(float* __restrict__ u, long long n,
               const long long* __restrict__ key, unsigned long long salt) {
  const unsigned long long site = mtvaf::site_key(key, salt);
  const unsigned k0 = (unsigned)site, k1 = (unsigned)(site >> 32);
  const long long groups = (n + 3) >> 2;
  for (long long g = blockIdx.x * (long long)THREADS + threadIdx.x;
       g < groups; g += (long long)gridDim.x * THREADS) {
    const uint4 r = element_bits(g, k0, k1);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (g * 4 + j < n) u[g * 4 + j] = (float)(w[j] >> 8) * 0x1p-24f;
  }
}

// At most eight resident 256-thread blocks per SM (2048 threads), and no
// more blocks than the threads' work items (vectors, groups) need.
unsigned grid_for(long long items) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long need = (items + THREADS - 1) / THREADS;
  const long long cap = 8LL * sms;
  return (unsigned)(need < cap ? (need > 0 ? need : 1) : cap);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  x and y hold n elements of
// dtype 0 = float32 or 1 = bfloat16 (y may be x); key points to the step
// key's int64 word on the same device.  Each returns cudaGetLastError()
// after the launch (0 on success, -1 for a dtype not compiled).
extern "C" int mtvaf_keyed_dropout(const void* x, void* y, long long n,
                                   int dtype, const long long* key,
                                   unsigned long long salt,
                                   unsigned threshold, float keep_p,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  if (dtype == 0) {
    dropout_kernel<float><<<grid_for((n + 3) / 4), THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, key, salt,
        threshold, keep_p, vec);
  } else if (dtype == 1) {
    dropout_kernel<__nv_bfloat16><<<grid_for((n + 7) / 8), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, key, salt, threshold, keep_p, vec);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// u: n fp32 uniforms in [0, 1).
extern "C" int mtvaf_keyed_uniform(float* u, long long n,
                                   const long long* key,
                                   unsigned long long salt, void* stream) {
  uniform_kernel<<<grid_for((n + 3) >> 2), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(u, n, key, salt);
  return static_cast<int>(cudaGetLastError());
}
