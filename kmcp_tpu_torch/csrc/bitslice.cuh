// Bit-sliced vertical counter for 32 per-target counts in registers, shared
// by K2' (count_mask.cu) and K5' (pair_count.cu) through their slice and
// gather variants.
//
// c[l] holds bit l of the 32 counts of one 32-target word: bit j of c[l] is
// bit l of the count of target j.  Adding a word x (bit j = one hit for
// target j) is a ripple carry through the planes that stops as soon as the
// carry is zero.  The counts unpack once, at the end, together with the
// threshold mask.
//
// __host__ __device__ where the slice counter's epilogue uses it: the CUDA
// kernels include this header, and bitslice_host.cpp compiles the same code
// with g++ so that the CPU tests hold the 9-plane counter and its epilogue
// against the plain PyTorch version without a card.  __byte_perm and
// __vcmpgeu4 have portable stand-ins for that build; the CUDA build uses the
// intrinsics.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define BS_HD __host__ __device__ __forceinline__
#else
#define BS_HD inline
#endif

namespace bs {

// __byte_perm(x, y, s): byte i of the result is byte (s >> 4i) & 7 of the
// eight bytes y:x (x the low four); only selectors 0..7 are used here.
BS_HD uint32_t byte_perm(uint32_t x, uint32_t y, unsigned s) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, y, s);
#else
  const uint64_t v = (uint64_t)y << 32 | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (uint32_t)(v >> (8 * ((s >> (4 * i)) & 7)) & 0xFFu) << (8 * i);
  return r;
#endif
}

// __vcmpgeu4(a, b): byte i is 0xFF where byte i of a >= byte i of b
// (unsigned), else 0.
BS_HD uint32_t vcmpgeu4(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __vcmpgeu4(a, b);
#else
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    if (((a >> (8 * i)) & 0xFFu) >= ((b >> (8 * i)) & 0xFFu))
      r |= 0xFFu << (8 * i);
  return r;
#endif
}

}  // namespace bs

// The ripple add into NL planes, starting at plane L0 (adds x << L0).
template <int L0, int NL>
BS_HD void bitslice_add_at(uint32_t (&c)[NL], uint32_t x) {
#pragma unroll
  for (int l = L0; l < NL; ++l) {
    if (!x) break;
    const uint32_t carry = c[l] & x;
    c[l] ^= x;
    x = carry;
  }
}

// Carry-save adder: a + b + c = 2 hi + lo, per bit (two LOP3s).
BS_HD void csa(uint32_t& hi, uint32_t& lo, uint32_t a, uint32_t b,
               uint32_t c) {
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

  BS_HD void init() {
#pragma unroll
    for (int l = 0; l < NL; ++l) c[l] = 0;
    ones = twos = fours = 0;
  }

  BS_HD void add8(const uint32_t (&d)[8]) {
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

  BS_HD void add1(uint32_t x) { bitslice_add_at<0, NL>(c, x); }

  // Folds the remainder into the planes; c then holds the exact counts.
  BS_HD void finish() {
    bitslice_add_at<0, NL>(c, ones);
    bitslice_add_at<1, NL>(c, twos);
    bitslice_add_at<2, NL>(c, fours);
  }
};

#if defined(__CUDACC__)
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
#endif

// The low 8 planes of c (NL >= 8) -> out[k] holding the low bytes of the
// counts of targets 4k..4k+3, low byte first: an 8x8 bit transpose inside
// each byte lane of the planes (three rounds of block swaps, after which
// plane i's byte m is the count of target 8m + i), then byte permutes into
// target order.  About 90 ops, against 256 bit extracts.
template <int NL>
BS_HD void bitslice_bytes8(const uint32_t (&c)[NL], uint32_t (&out)[8]) {
  static_assert(NL >= 8, "bitslice_bytes8 reads planes 0..7");
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
    const uint32_t lo = bs::byte_perm(p[a], p[a + 1], sel);
    const uint32_t hi = bs::byte_perm(p[a + 2], p[a + 3], sel);
    out[k] = bs::byte_perm(lo, hi, 0x5410);
  }
}

// Bits of (counts4 >= floor4), four byte lanes compared at once -> bit e
// for lane e.
BS_HD uint32_t ge4_bits(uint32_t counts4, uint32_t floor4) {
  return ((bs::vcmpgeu4(counts4, floor4) & 0x80808080u) * 0x00204081u) >> 28;
}

// A per-target floor t as the 9-plane epilogue compares it: its low byte
// and bit 8 for 0 <= t <= 511 (t < 0 as 0), or `never` for t > 511 (no
// count of 9 planes reaches it; FLOOR_NEVER is one such).  With cap = 255
// the same split serves the 8-plane epilogue (bit 8 then always 0).
struct FloorSplit {
  uint32_t lo, hi, never;
};
BS_HD FloorSplit floor_split(int t, int cap) {
  const int c = t < 0 ? 0 : t > cap ? cap : t;
  return {(uint32_t)c & 0xFFu, (uint32_t)c >> 8, (uint32_t)(t > cap)};
}

// The mask of 32 counts of up to 9 bits, each split into its low byte (lo[k]
// holds targets 4k..4k+3, as bitslice_bytes8 gives them) and bit 8 (bit j of
// c8): bit j set iff count j >= the per-target floor (low bytes t8[k], bit 8
// in bit j of thi, bit j of tnever set for floors > 511) and count j >= the
// per-read floor c.  A count >= f (both < 512) iff its bit 8 exceeds f's, or
// equals it and its low byte is >= f's, compared on whole 32-target words.
BS_HD uint32_t bitslice_mask9(const uint32_t (&lo)[8], uint32_t c8,
                              const uint32_t* t8, uint32_t thi,
                              uint32_t tnever, int c) {
  if (c > 511) return 0u;
  const FloorSplit f = floor_split(c, 511);
  const uint32_t f4 = f.lo * 0x01010101u;
  uint32_t lt = 0, lc = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    lt |= ge4_bits(lo[k], t8[k]) << (4 * k);
    lc |= ge4_bits(lo[k], f4) << (4 * k);
  }
  const uint32_t ge_t = (c8 & ~thi) | (~(c8 ^ thi) & lt);
  const uint32_t ge_c = f.hi ? (c8 & lc) : (c8 | lc);
  return ge_t & ge_c & ~tnever;
}

// Four counts from their low bytes x (target e in byte e) and their bit 8
// (bit e of hi4): v[e] = byte e | bit e << 8.
BS_HD void bitslice_expand4(uint32_t x, uint32_t hi4, int (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = (int)(bs::byte_perm(x, 0u, 0x4440u + e) | ((hi4 >> e) & 1u) << 8);
}
