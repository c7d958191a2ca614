// Per-window arithmetic of K1' hash_loc: canonical ntHash1 of a strip of
// windows, and the exact fast moduli that turn a hash into Bloom rows.
//
// __host__ __device__ throughout: the CUDA kernel (hash_loc.cu) runs
// nt_strip once per thread, and hash_loc_host.cpp compiles the same code
// with g++ so that the CPU tests hold it against the plain PyTorch version
// (kmcp_tpu_torch/search/hash_loc.py) without a card.
//
// The rolling state of a read (kmcp_tpu/search/pallas_hash.py:226-290):
// after an invalid base the state is 0; each base b_i then enters as
//   fh = rol(fh, 1) ^ [run > k] rol(seed(b_{i-k}), k) ^ seed(b_i)
//   rh = ror(rh, 1) ^ [run > k] ror(seedc(b_{i-k}), 1) ^ rol(seedc(b_i), k-1)
// where run counts the clean bases since the last invalid one, and the
// window ending at b_i is valid iff run >= k, h = unsigned min(fh, rh) != 0
// and h <= max_hash.  Rotations are taken mod 64.
//
// Why a strip may start anywhere: from state 0, k clean bases b_p..b_{p+k-1}
// give exactly the direct formula
//   fh = XOR_j rol(seed(b_{p+j}), k-1-j),  rh = XOR_j rol(seedc(b_{p+j}), j)
// (each base is rotated once per later base, and rotation mod 64 is a group
// action, so the order of rotations does not matter); each later step
// removes the oldest base with the same rotation it was given.  So the
// rolling state of every valid window equals the direct formula of its k
// bases, and a thread that starts from state 0 at base p (k - 1 bases of
// warm-up) reproduces the read's rolling hash on every valid window at or
// after p.  Validity is local too: a window is valid iff none of its k bases
// is invalid, which the strip's own clean-base count since p, or since its
// last invalid base, tells exactly for every window starting at or after p.
// Invalid windows emit the sentinel whatever the state.  nt_direct below is
// the direct formula itself; the tests hold the two against each other.
//
// Moduli, exact for every divisor d in 1..2^31-1 (and any x < 2^64):
//   - d a power of two: x & (d - 1) (2^32 mod d == 0, so the low word
//     alone decides it; pallas_hash.py:150-156);
//   - otherwise Barrett with m = floor((2^64 - 1) / d), which equals
//     floor(2^64 / d) because d does not divide 2^64: q = mulhi(x, m) lies
//     in {floor(x/d) - 1, floor(x/d)} (x m / 2^64 > x/d - x/2^64 > x/d - 1),
//     so r = x - q d lies in [0, 2d) and one conditional subtraction ends
//     it.  h == 1 reduces the full 64-bit h; h > 1 reduces the 32-bit
//     uint32(hi + lo * j) (the reference's derivation, util-hash.go:61-142).

#pragma once

#include <cstddef>
#include <cstdint>

#if defined(__CUDACC__)
#define NT_HD __host__ __device__ __forceinline__
#else
#define NT_HD inline
#endif

namespace nt {

// Base codes: A C G T -> 0..3, anything else (N, padding 0) -> 4.
constexpr int kInvalid = 4;

NT_HD int base_code(uint8_t byte) {
  switch (byte & 0xDF) {  // fold lower case to upper
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return kInvalid;
  }
}

NT_HD uint64_t rol64(uint64_t x, int r) {
  r &= 63;
  return r ? (x << r) | (x >> (64 - r)) : x;
}

NT_HD uint64_t ror64(uint64_t x, int r) { return rol64(x, (64 - (r & 63)) & 63); }

NT_HD uint64_t mulhi64(uint64_t a, uint64_t b) {
#if defined(__CUDA_ARCH__)
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// Seed tables of one k, indexed by base code (entry 4, an invalid base, is
// 0): the forward seed entering, the complement seed entering (rotated by
// k-1), and the two leaving terms (rol(seed, k), ror(seedc, 1)).
struct Tables {
  uint64_t t[4][5];
};
enum { kFwdIn = 0, kRevIn = 1, kFwdOut = 2, kRevOut = 3 };

NT_HD Tables make_tables(const uint64_t seeds[4], int k) {
  Tables tab;
  for (int c = 0; c < 5; ++c) {
    const uint64_t f = c < 4 ? seeds[c] : 0;
    const uint64_t r = c < 4 ? seeds[3 - c] : 0;  // A<->T, C<->G
    tab.t[kFwdIn][c] = f;
    tab.t[kRevIn][c] = rol64(r, k - 1);
    tab.t[kFwdOut][c] = rol64(f, k);
    tab.t[kRevOut][c] = ror64(r, 1);
  }
  return tab;
}

struct Modulus {
  uint64_t m;     // floor((2^64 - 1) / d); unused for a power of two
  uint32_t d;     // the divisor, also the sentinel row
  uint32_t mask;  // d - 1
  int pow2;
};

NT_HD Modulus make_modulus(uint32_t d) {
  Modulus M;
  M.d = d;
  M.mask = d - 1;
  M.pow2 = (d & (d - 1)) == 0;
  M.m = (M.pow2 || d == 0) ? 0 : ~(uint64_t)0 / d;
  return M;
}

NT_HD uint32_t mod(uint64_t x, const Modulus& M) {
  if (M.pow2) return (uint32_t)x & M.mask;
  const uint64_t r = x - mulhi64(x, M.m) * M.d;
  return (uint32_t)(r >= M.d ? r - M.d : r);
}

// What a strip emits, and where: the read's rows of the [K, h] location
// planes, of the screen plane and of the value plane (the last two may be
// null).  The pointers may be a shared-memory tile or device memory.
struct Params {
  int k, h;
  uint64_t max_hash;
  Modulus rows;    // Bloom rows (sentinel rows.d)
  Modulus screen;  // union-screen rows (sentinel screen.d), h == 1
};

// Windows w0..w1-1 of one read whose base codes code(i) gives: hashes
// bases w0 .. w1+k-2 from state 0 (k - 1 bases of warm-up, in which no base
// leaves, then one window a base), writes each window's outputs and
// returns how many were valid.  The codes a step reads do not depend on the
// hash state, so an unrolled loop issues them ahead of the rolling chain.
template <class Codes>
NT_HD int nt_strip(const Codes& code, int w0, int w1, const uint64_t (*tab)[5],
                   const Params& P, int32_t* loc, int32_t* locu,
                   int64_t* vals) {
  const int k = P.k;
  uint64_t fh = 0, rh = 0;
  int run = 0, count = 0;
  for (int i = w0; i < w0 + k - 1; ++i) {
    const int c = code(i);
    const bool ok = c < kInvalid;
    run = ok ? run + 1 : 0;
    fh = ok ? rol64(fh, 1) ^ tab[kFwdIn][c] : 0;
    rh = ok ? ror64(rh, 1) ^ tab[kRevIn][c] : 0;
  }
#if defined(__CUDA_ARCH__)
#pragma unroll 2
#endif
  for (int w = w0; w < w1; ++w) {
    const int c = code(w + k - 1);
    const int c_out = code(w > w0 ? w - 1 : w0);  // leaves only when w > w0
    run = c < kInvalid ? run + 1 : 0;
    const int co = run > k ? c_out : kInvalid;
    fh = rol64(fh, 1) ^ tab[kFwdOut][co] ^ tab[kFwdIn][c];
    rh = ror64(rh, 1) ^ tab[kRevOut][co] ^ tab[kRevIn][c];
    if (c == kInvalid) fh = rh = 0;
    const uint64_t hv = rh < fh ? rh : fh;
    const bool valid = run >= k && hv != 0 && hv <= P.max_hash;
    if (P.h == 1) {
      loc[w] = valid ? (int32_t)mod(hv, P.rows) : (int32_t)P.rows.d;
    } else {
      const uint32_t hi = (uint32_t)(hv >> 32), lo = (uint32_t)hv;
      for (int j = 0; j < P.h; ++j) {
        const uint32_t v = hi + lo * (uint32_t)j;  // uint32 wrap
        loc[w * P.h + j] = valid ? (int32_t)mod(v, P.rows) : (int32_t)P.rows.d;
      }
    }
    if (locu) locu[w] = valid ? (int32_t)mod(hv, P.screen) : (int32_t)P.screen.d;
    if (vals) vals[w] = valid ? (int64_t)hv : 0;
    count += valid;
  }
  return count;
}

// The direct formula of the window of bases p..p+k-1 (no rolling): its
// canonical value, or 0 when a base is invalid.  The tests' yardstick.
template <class Codes>
NT_HD uint64_t nt_direct(const Codes& code, int p, int k,
                         const uint64_t seeds[4]) {
  uint64_t fh = 0, rh = 0;
  for (int j = 0; j < k; ++j) {
    const int c = code(p + j);
    if (c == kInvalid) return 0;
    fh ^= rol64(seeds[c], k - 1 - j);
    rh ^= rol64(seeds[3 - c], j);
  }
  return rh < fh ? rh : fh;
}

}  // namespace nt
