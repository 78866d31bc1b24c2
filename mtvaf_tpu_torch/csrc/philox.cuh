// Counter-based dropout bits shared by the prefix-attention kernels.
//
// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011): ten rounds over a 128-bit counter under a 64-bit key.  The
// attention-probability keep mask of element (b, h, row, col) is word
// (col & 3) of philox(counter = (col >> 2, row, h, b), key = (seed_lo,
// seed_hi)); the element is kept when that word is >= threshold =
// uint32(rate * 2^32).  The forward, the backward (in bf16 its dq pass,
// which hands the bits to its dk/dv pass; in fp32 both passes) and the mask
// entry point call these functions, so they agree bit for bit whatever their
// tiling, and ``keep_mask_reference`` in kernels/prefix_attention.py is the
// same function in plain PyTorch.
#pragma once

#include <cuda_runtime.h>

namespace mtvaf {

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

__device__ __forceinline__ unsigned word(uint4 r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// The keep word of one element (one Philox call for one column).
__device__ __forceinline__ unsigned keep_bits(int b, int h, int row, int col,
                                              unsigned seed_lo,
                                              unsigned seed_hi) {
  return word(keep_bits4(b, h, row, col >> 2, seed_lo, seed_hi), col & 3);
}

}  // namespace mtvaf
