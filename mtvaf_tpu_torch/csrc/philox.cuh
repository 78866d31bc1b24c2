// Counter-based random bits shared by the port's kernels.
//
// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011): ten rounds over a 128-bit counter under a 64-bit key.  A
// draw site's key is mix(word, salt) (splitmix64, `_mix` in core/rng.py):
// word is the train step's 63-bit key, which the kernels read from device
// memory, and salt the site's static path of splits, a kernel argument; the
// Philox key is (its low 32 bits, its high 32 bits).  The
// attention-probability keep mask of element (b, h, row, col) is word
// (col & 3) of philox(counter = (col >> 2, row, h, b)), h the head's global
// index (a tensor-parallel rank's local head plus its head offset); the
// element is kept when that word is >= threshold = uint32(rate * 2^32).
// The forward (which hands its bits to the backward as keep words,
// hopper.cuh) and the mask entry point call these functions, so they agree
// bit for bit whatever their tiling, and ``keep_mask_reference`` in
// kernels/prefix_attention.py is the same function in plain PyTorch.  The
// elementwise draws of keyed_random.cu take word (i & 3) of philox(counter
// = (i >> 2 low, i >> 2 high, 0, 0)) for element i.
#pragma once

#include <cuda_runtime.h>

namespace mtvaf {

// splitmix64 of (a, b), cut to 63 bits: core/rng.py's _mix.
__device__ __forceinline__ unsigned long long mix(unsigned long long a,
                                                  unsigned long long b) {
  unsigned long long z = a * 0x9E3779B97F4A7C15ull + b + 0x632BE59BD9B4E019ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFFull;
}

// The Philox key of a draw site: mix(*word, salt), word read from device
// memory (the step key's tensor).
__device__ __forceinline__ unsigned long long site_key(const long long* word,
                                                       unsigned long long salt) {
  return mix(static_cast<unsigned long long>(*word), salt);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The four keep words of columns 4*col4 .. 4*col4+3 of row `row`.
__device__ __forceinline__ uint4 keep_bits4(int b, int h, int row, int col4,
                                            unsigned seed_lo,
                                            unsigned seed_hi) {
  return philox4x32_10(make_uint4((unsigned)col4, (unsigned)row, (unsigned)h,
                                  (unsigned)b),
                       seed_lo, seed_hi);
}

}  // namespace mtvaf
