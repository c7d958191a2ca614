// Shapes and addressing of the slice counter and the row ring (slice.cuh),
// shared by K2' (count_mask.cu) and K5' (pair_count.cu): which variant a
// row count takes, how much shared memory each needs, and which words each
// lane of a ring warp copies.  No CUDA types here: geometry_host.cpp
// builds the same functions with g++ so that the CPU tests check the
// capacity switches and the ring's copy coverage without a card.

#pragma once

#include <cstddef>

#if defined(__CUDACC__)
#define GEO_HD __host__ __device__ __forceinline__
#else
#define GEO_HD inline
#endif

namespace geo {

// The variants, by the code kmcp_*_variant returns.
enum Variant {
  GATHER = 0,  // a thread per (read, word): rows narrower than 8 words
  SLICE = 1,   // a word tile of 8 of every row in shared memory
  RING = 2,    // rows streamed through a shared-memory ring per warp
};

GEO_HD constexpr int round4(int x) { return (x + 3) & ~3; }

// ---- the slice counter: 1,024 threads, 128 reads x a tile of 8 words

constexpr int SLICE_THREADS = 1024;
constexpr int SLICE_WT = 8;
constexpr int SLICE_READS = SLICE_THREADS / SLICE_WT;
// the per-warp store stage (1 KB a warp), aliased onto a location buffer
constexpr int SLICE_STAGE_WORDS = SLICE_THREADS / 32 * 256;

// Windows of locations staged at a time: 64 at h = 1 (3-5% faster than 32
// at K2''s wide shape, as there are half the barriers), else 32.
GEO_HD constexpr int slice_kc(int h) { return h == 1 ? 64 : 32; }
GEO_HD constexpr int slice_pitch(int h) { return slice_kc(h) * h + 4; }
// Words of one location buffer (two are double-buffered); each holds the
// store stage too.
GEO_HD constexpr int slice_buffer_words(int h) {
  return SLICE_READS * slice_pitch(h);
}
// Shared memory of a slice CTA, in bytes: the tile of S_ext rows, the
// floors (byte floors, "never" and bit-8 words), the location buffers.
GEO_HD constexpr size_t slice_smem(int S_ext, int h) {
  return ((size_t)S_ext * SLICE_WT + 10 * SLICE_WT +
          2 * (size_t)slice_buffer_words(h)) * 4;
}

// ---- the row ring: 512 threads; a warp counts 32 words of one read at a
// time, through its own ring of stages

constexpr int RING_THREADS = 512;
constexpr int RING_WARPS = RING_THREADS / 32;
constexpr int RING_KC = 8;  // windows a stage: one carry-save add

// Words of a row a CTA covers: a power of two from 32 (a warp) to 512 (16
// warps on one read), no wider than W needs.
GEO_HD constexpr int ring_span(int W) {
  int s = 32;
  while (s < W && s < 512) s *= 2;
  return s;
}
GEO_HD constexpr int ring_reads(int span) { return RING_THREADS / span; }
// Stages in a warp's ring: 4 at h = 1 and 2 (at h = 1 two CTAs an SM), 3
// at h = 3, 2 at h = 4 (one CTA an SM).
GEO_HD constexpr int ring_depth(int h) {
  return h <= 2 ? 4 : h == 3 ? 3 : 2;
}
// A warp's stage: RING_KC windows x h rows of its 32 words.
GEO_HD constexpr int ring_stage_words(int h) { return RING_KC * h * 32; }
// Shared memory of a ring CTA, in bytes: the span's floors, then each
// warp's ring and its 1 KB store stage.
GEO_HD constexpr size_t ring_smem(int span, int h) {
  return ((size_t)10 * span +
          (size_t)RING_WARPS * (ring_depth(h) * ring_stage_words(h) + 256)) *
         4;
}
// A warp's copies of one stage, each of wpc words (4: 16-byte cp.async, 1:
// 4-byte): copy e = lane + 32 m is word (e % cps) * wpc of segment e / cps,
// cps = 32 / wpc; segment i * h + j is window i, hash j.  Every lane makes
// the same number of them.
GEO_HD constexpr int ring_copies_per_lane(int h, int wpc) {
  return RING_KC * h / wpc;
}
struct Copy {
  int seg, word;
};
GEO_HD Copy ring_copy(int e, int wpc) {
  const int cps = 32 / wpc;
  return {e / cps, (e % cps) * wpc};
}

// ---- the choice

// The variant for rows of W words, S_ext of them (the sentinel included),
// h hashes, on a device whose blocks may use smem_optin bytes of shared
// memory: the slice where one tile of every row fits, else the ring; rows
// narrower than one tile take the gather.
GEO_HD int pick(int smem_optin, int W, int S_ext, int h) {
  if (W < SLICE_WT) return GATHER;
  if (slice_smem(S_ext, h) <= (size_t)smem_optin) return SLICE;
  return RING;
}

// Planes needed for counts up to max_count (at least 1).
GEO_HD int levels(long long max_count) {
  int nlev = 1;
  while (nlev < 32 && (1LL << nlev) <= max_count) ++nlev;
  return nlev;
}
// The counter's planes for K windows: 8, 9, 16 or 32.
GEO_HD int counter_planes(int K) {
  const int n = levels(K);
  return n <= 8 ? 8 : n == 9 ? 9 : n <= 16 ? 16 : 32;
}

}  // namespace geo
