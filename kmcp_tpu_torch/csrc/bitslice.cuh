// Bit-sliced vertical counter for 32 per-target counts in registers, shared
// by K2' (count_mask.cu) and K5' (pair_count.cu).
//
// c[l] holds bit l of the 32 counts of one 32-target word: bit j of c[l] is
// bit l of the count of target j.  Adding a word x (bit j = one hit for
// target j) is a ripple carry through the planes that stops as soon as the
// carry is zero, about two planes on average.  The counts unpack once, at
// the end, together with the threshold mask.

#pragma once

#include <cstdint>

__device__ __forceinline__ void bitslice_add(uint32_t (&c)[32], uint32_t x) {
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    if (!x) break;
    const uint32_t carry = c[l] & x;
    c[l] ^= x;
    x = carry;
  }
}

// Writes the 32 counts to cw[0..31] (only the low nlev planes can be set)
// and returns the mask: bit j set iff count j >= max(tw[j], floor_read).
__device__ __forceinline__ uint32_t bitslice_store(const uint32_t (&c)[32],
                                                   int nlev,
                                                   const int32_t* tw,
                                                   int floor_read,
                                                   int32_t* cw) {
  uint32_t m = 0;
#pragma unroll 1
  for (int j = 0; j < 32; ++j) {
    uint32_t cnt = 0;
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      if (l < nlev) cnt |= ((c[l] >> j) & 1u) << l;
    }
    cw[j] = (int32_t)cnt;
    if ((int)cnt >= max(tw[j], floor_read)) m |= 1u << j;
  }
  return m;
}

// Planes needed for counts up to max_count (at least 1).
inline int bitslice_levels(long long max_count) {
  int nlev = 1;
  while (nlev < 32 && (1LL << nlev) <= max_count) ++nlev;
  return nlev;
}
