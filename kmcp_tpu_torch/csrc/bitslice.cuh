// Bit-sliced vertical counter for 32 per-target counts in registers, shared
// by K2' (count_mask.cu) and K5' (pair_count.cu, which uses bitslice_add
// and bitslice_store; K2' uses the carry-save CsaCounter below).
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

// The same ripple add into NL planes, starting at plane L0 (adds x << L0).
template <int L0, int NL>
__device__ __forceinline__ void bitslice_add_at(uint32_t (&c)[NL],
                                                uint32_t x) {
#pragma unroll
  for (int l = L0; l < NL; ++l) {
    if (!x) break;
    const uint32_t carry = c[l] & x;
    c[l] ^= x;
    x = carry;
  }
}

// Carry-save adder: a + b + c = 2 hi + lo, per bit (two LOP3s).
__device__ __forceinline__ void csa(uint32_t& hi, uint32_t& lo, uint32_t a,
                                    uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  hi = (a & b) | (u & c);
  lo = u ^ c;
}

// A positional popcount of 32 targets in NL bit planes, fed eight words at
// a time through a carry-save tree (Harley-Seal): ones, twos and fours hold
// the carry-save remainder, and only the eights ripple into the planes, at
// plane 3.  That is about 1.75 logic ops per word for the tree and a
// quarter of a ripple add, against a whole ripple add per word.
template <int NL>
struct CsaCounter {
  uint32_t c[NL];
  uint32_t ones, twos, fours;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int l = 0; l < NL; ++l) c[l] = 0;
    ones = twos = fours = 0;
  }

  __device__ __forceinline__ void add8(const uint32_t (&d)[8]) {
    uint32_t twos_a, twos_b, fours_a, fours_b, eights;
    csa(twos_a, ones, ones, d[0], d[1]);
    csa(twos_b, ones, ones, d[2], d[3]);
    csa(fours_a, twos, twos, twos_a, twos_b);
    csa(twos_a, ones, ones, d[4], d[5]);
    csa(twos_b, ones, ones, d[6], d[7]);
    csa(fours_b, twos, twos, twos_a, twos_b);
    csa(eights, fours, fours, fours_a, fours_b);
    bitslice_add_at<3, NL>(c, eights);
  }

  __device__ __forceinline__ void add1(uint32_t x) {
    bitslice_add_at<0, NL>(c, x);
  }

  // Folds the remainder into the planes; c then holds the exact counts.
  __device__ __forceinline__ void finish() {
    bitslice_add_at<0, NL>(c, ones);
    bitslice_add_at<1, NL>(c, twos);
    bitslice_add_at<2, NL>(c, fours);
  }
};

// Writes the 32 counts of planes c to cw[0..31] as eight 16-byte stores (cw
// 16-byte aligned) and returns the mask: bit j set iff count j >=
// max(tw[j], floor_read).
template <int NL>
__device__ __forceinline__ uint32_t bitslice_store16(const uint32_t (&c)[NL],
                                                     const int32_t* tw,
                                                     int floor_read,
                                                     int32_t* cw) {
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * q + e;
      uint32_t cnt = 0;
#pragma unroll
      for (int l = 0; l < NL; ++l) cnt |= ((c[l] >> j) & 1u) << l;
      v[e] = (int)cnt;
      if (v[e] >= max(tw[j], floor_read)) m |= 1u << j;
    }
    reinterpret_cast<int4*>(cw)[q] = make_int4(v[0], v[1], v[2], v[3]);
  }
  return m;
}

// Counts up to 255 in 8 planes -> out[k] holding the counts of targets
// 4k..4k+3 as bytes, low byte first: an 8x8 bit transpose inside each byte
// lane of the planes (three rounds of block swaps, after which plane i's
// byte m is the count of target 8m + i), then byte permutes into target
// order.  About 90 ops, against 256 bit extracts.
__device__ __forceinline__ void bitslice_bytes8(const uint32_t (&c)[8],
                                                uint32_t (&out)[8]) {
  uint32_t p[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) p[l] = c[l];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const uint32_t t = ((p[l] >> 4) ^ p[l + 4]) & 0x0F0F0F0Fu;
    p[l + 4] ^= t;
    p[l] ^= t << 4;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int l = q + (q & 2);  // 0, 1, 4, 5
    const uint32_t t = ((p[l] >> 2) ^ p[l + 2]) & 0x33333333u;
    p[l + 2] ^= t;
    p[l] ^= t << 2;
  }
#pragma unroll
  for (int l = 0; l < 8; l += 2) {
    const uint32_t t = ((p[l] >> 1) ^ p[l + 1]) & 0x55555555u;
    p[l + 1] ^= t;
    p[l] ^= t << 1;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = 4 * (k & 1), m = k >> 1;
    const unsigned sel = (unsigned)m | ((unsigned)(m + 4) << 4);
    const uint32_t lo = __byte_perm(p[a], p[a + 1], sel);
    const uint32_t hi = __byte_perm(p[a + 2], p[a + 3], sel);
    out[k] = __byte_perm(lo, hi, 0x5410);
  }
}

// Planes needed for counts up to max_count (at least 1).
inline int bitslice_levels(long long max_count) {
  int nlev = 1;
  while (nlev < 32 && (1LL << nlev) <= max_count) ++nlev;
  return nlev;
}
