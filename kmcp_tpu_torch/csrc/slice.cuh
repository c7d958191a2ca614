// The shared-memory counters of K2' (count_mask.cu, a read range of one
// bit matrix) and K5' (pair_count.cu, the pairs of one block).
//
// slice_count: a CTA copies one tile of 8 words (256 targets) of every row
// of its rows into shared memory once, then runs rounds of 128 reads x 8
// words against it, so every gathered word is a shared-memory load.  The
// reads' locations come in chunks of KC windows,
// double-buffered in shared memory (plane major, pre-scaled to the tile's
// row pitch), each chunk's global loads issued before the current chunk's
// counting, one barrier a chunk.  Windows go eight at a time, loads first,
// into a carry-save counter (bitslice.cuh CsaCounter).  With counts below
// 256 (NL = 8, single-end rows) the epilogue transposes the planes to byte
// counts, compares four targets at once, and writes the counts through a
// per-warp stage in shared memory (1 KB a warp, in the location buffer
// that the next chunk fills after a barrier) so that a warp stores 512
// contiguous bytes per instruction.  Counts below 512 (NL = 9, paired rows
// of up to 2 x 250 bp) keep that epilogue and add the ninth plane as one
// word of "256" bits: the mask compares it on whole 32-target words beside
// the byte compares (bitslice_mask9), and each count leaves the stage as
// its byte with bit 8 from that word, which a warp shuffle brings to the
// lane that stores it.  NL = 16 and 32 (K >= 512, off the main paths) take
// the generic per-thread epilogue (bitslice_store16) and spill at 1,024
// threads.
//
// ring_count: rows too many for a tile stream through a ring of stages in
// shared memory, one ring a warp (see its comment); the same counter and
// epilogue.
//
// Which reads a CTA counts, which row of loc holds their windows and which
// row of the outputs they land on is the caller's Rows policy: src(i) is
// the loc and cthr row of the CTA's i-th read, dst(i) its output row.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bitslice.cuh"
#include "geometry.cuh"

namespace slice {

using geo::SLICE_READS;
using geo::SLICE_THREADS;
constexpr int WT = geo::SLICE_WT;  // words a tile

// global -> shared, asynchronously (Ampere+ cp.async): 16 bytes through L2
// only, 4 or 8 through L1.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Counts of 4 targets (bytes) >= 4 byte floors -> 4 mask bits.
__device__ __forceinline__ uint32_t mask4(uint32_t counts4, uint32_t thr4,
                                          uint32_t floor4) {
  const uint32_t ge =
      __vcmpgeu4(counts4, thr4) & __vcmpgeu4(counts4, floor4);
  return ((ge & 0x80808080u) * 0x00204081u) >> 28;
}

// K2''s reads: read i is row i of loc and of the outputs.
struct DenseRows {
  __device__ __forceinline__ int src(int i) const { return i; }
  __device__ __forceinline__ int dst(int i) const { return i; }
};

// K5''s pairs, sorted by block: the CTA's i-th pair is order[i], whose
// read is pb[order[i]]; its outputs go to row order[i].
struct PairRows {
  const int32_t* order;
  const int32_t* pb;
  __device__ __forceinline__ int src(int i) const {
    return __ldg(pb + __ldg(order + i));
  }
  __device__ __forceinline__ int dst(int i) const { return __ldg(order + i); }
};

// The floors of word w (w < nw; past it 0) of thr (32 a word), as the
// byte-plane epilogue compares them: thread idx = 8 w + k makes byte floors
// of targets 4k..4k+3 into sthr8[idx] and, with its 7 neighbours (the
// caller runs whole warps), the word's "never" and bit-8 words.
template <int NL>
__device__ __forceinline__ void stage_floors(const int32_t* __restrict__ thr,
                                             int idx, int nw, uint32_t* sthr8,
                                             uint32_t* snever, uint32_t* shi,
                                             int n_words) {
  const int w = idx / 8, k = idx % 8;
  uint32_t t4 = 0, nev = 0, hi = 0;
  for (int e = 0; e < 4; ++e) {
    const int t = w < nw ? __ldg(thr + (size_t)w * 32 + 4 * k + e) : 0;
    const FloorSplit f = floor_split(t, NL == 9 ? 511 : 255);
    t4 |= f.lo << (8 * e);
    nev |= f.never << (4 * k + e);
    hi |= f.hi << (4 * k + e);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    nev |= __shfl_xor_sync(0xffffffffu, nev, o);
    hi |= __shfl_xor_sync(0xffffffffu, hi, o);
  }
  if (w < n_words) {
    sthr8[idx] = t4;
    if (k == 0) {
      snever[w] = nev;
      shi[w] = hi;
    }
  }
}

// One CTA of the slice counter.  Its rows are base[0 .. n_rows-1] (pitch W
// words) and then the all-zero row `last` (local row n_rows, where the
// sentinel windows point); it counts tile w0 .. w0+7 of them for its reads
// b_lo .. b_hi-1 (loc [*, K, H], rows < n_rows + 1), with per-target floors
// thr[32 w0 ..] and per-read floors cthr[src(b)], into counts [*, 32 W] and
// mask [*, W] at row dst(b).  smem holds geo::slice_smem(n_rows + 1, H)
// bytes.
template <int NL, int H, class Rows>
__device__ __forceinline__ void slice_count(
    const uint32_t* __restrict__ base, int n_rows,
    const uint32_t* __restrict__ last, int W, int w0,
    const int32_t* __restrict__ loc, int K, const int32_t* __restrict__ cthr,
    const int32_t* __restrict__ thr, int32_t* __restrict__ counts,
    uint32_t* __restrict__ mask, int b_lo, int b_hi, Rows rows,
    uint32_t* smem) {
  // With 9 planes and H > 1 a chunk is 8 windows (the prefetch holds H
  // registers, not 4 H) and the hashes' rows are ANDed one hash at a time,
  // so that the counter's extra plane does not spill (ptxas: 57-62
  // registers at H = 2..4; 16-window chunks still spilled at H = 3 and 4);
  // the buffers keep their size
  constexpr bool LEAN = NL == 9 && H > 1;
  constexpr int KC = LEAN ? 8 : geo::slice_kc(H);
  constexpr int PITCH = geo::slice_pitch(H);
  constexpr int BUF = geo::slice_buffer_words(H);
  static_assert(BUF >= geo::SLICE_STAGE_WORDS,
                "the store stage lives in a location buffer");
  constexpr int READS = SLICE_READS;
  constexpr int PRE = READS * KC * H / SLICE_THREADS;  // loads a chunk
  const int S_ext = n_rows + 1;
  uint32_t* slice = smem;                           // [S_ext][WT]
  uint32_t* sthr8 = slice + (size_t)S_ext * WT;     // [WT][8] byte floors
  uint32_t* snever = sthr8 + WT * 8;                // [WT] floors > cap
  uint32_t* shi = snever + WT;                      // [WT] floors' bit 8
  int32_t* sloc = reinterpret_cast<int32_t*>(shi + WT);  // [2][BUF]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nw = min(WT, W - w0);
  // the tile of every row: with whole 16-byte halves in device memory, as
  // asynchronous 16-byte copies, all in flight while the floors and the
  // first locations load; else word by word
  const bool async = nw == WT && W % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(base) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(last) & 15) == 0;
  if (async) {
    for (int e = tid; e < S_ext * 2; e += SLICE_THREADS) {
      const int r = e >> 1;
      const uint32_t* row = r < n_rows ? base + (size_t)r * W : last;
      cp_async<16>(slice + e * 4, row + w0 + (e & 1) * 4);
    }
    cp_async_commit();
  } else {
    for (int e = tid; e < S_ext * WT; e += SLICE_THREADS) {
      const int r = e / WT, w = e % WT;
      const uint32_t* row = r < n_rows ? base + (size_t)r * W : last;
      slice[e] = w < nw ? __ldg(row + w0 + w) : 0u;
    }
  }
  if (tid < WT * 8)  // warps 0 and 1, whole
    stage_floors<NL>(thr + (size_t)w0 * 32, tid, nw, sthr8, snever, shi, WT);

  const int rr = tid / WT, w = tid % WT;
  const int n_chunks = max(1, (K + KC - 1) / KC);
  const int n_steps = (b_hi - b_lo + READS - 1) / READS * n_chunks;

  // chunk s: the locations of round s / n_chunks, windows of chunk
  // s % n_chunks, into registers, then into buffer s & 1.  Element e of a
  // chunk is (read e / (KC H), window and hash e % (KC H)), so the index
  // math divides by constants; windows past K are skipped.
  int32_t pre[PRE];
  auto fetch = [&](int s) {
    const int b0 = b_lo + s / n_chunks * READS;
    const int k0 = s % n_chunks * KC;
    const int nr = min(READS, b_hi - b0), kc = K - k0;
#pragma unroll
    for (int m = 0; m < PRE; ++m) {
      const int e = tid + m * SLICE_THREADS;
      const int r = e / (KC * H), q = e % (KC * H);
      if (r < nr && q / H < kc)
        pre[m] = __ldg(loc + ((size_t)rows.src(b0 + r) * K + k0) * H + q);
    }
  };
  auto stash = [&](int s) {
    const int b0 = b_lo + s / n_chunks * READS;
    const int k0 = s % n_chunks * KC;
    const int nr = min(READS, b_hi - b0), kc = K - k0;
    int32_t* buf = sloc + (s & 1) * BUF;
#pragma unroll
    for (int m = 0; m < PRE; ++m) {
      const int e = tid + m * SLICE_THREADS;
      const int r = e / (KC * H), q = e % (KC * H);
      if (r < nr && q / H < kc)
        buf[r * PITCH + (q % H) * KC + q / H] = pre[m] * WT;
    }
  };

  if (n_steps > 0) {
    fetch(0);
    stash(0);
  }
  if (async) cp_async_wait<0>();
  __syncthreads();

  CsaCounter<NL> acc;
  acc.init();
  const uint32_t* sw = slice + w;
  for (int s = 0; s < n_steps; ++s) {
    const int b0 = b_lo + s / n_chunks * READS;
    const int nr = min(READS, b_hi - b0);
    const int kc = max(0, min(KC, K - s % n_chunks * KC));
    if (s + 1 < n_steps) fetch(s + 1);
    if (rr < nr) {
      const int32_t* lr = sloc + (s & 1) * BUF + rr * PITCH;
      int i = 0;
      for (; i + 8 <= kc; i += 8) {
        uint32_t d[8];
#pragma unroll (LEAN ? 1 : H)
        for (int jj = 0; jj < H; ++jj) {
          const int4 a = *reinterpret_cast<const int4*>(lr + jj * KC + i);
          const int4 b = *reinterpret_cast<const int4*>(lr + jj * KC + i + 4);
          const int li[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int u = 0; u < 8; ++u)
            d[u] = jj == 0 ? sw[li[u]] : d[u] & sw[li[u]];
        }
        acc.add8(d);
      }
      for (; i < kc; ++i) {
        uint32_t x = sw[lr[i]];
#pragma unroll
        for (int jj = 1; jj < H; ++jj) x &= sw[lr[jj * KC + i]];
        acc.add1(x);
      }
    }
    const bool round_end = s % n_chunks == n_chunks - 1;
    if (round_end) {
      acc.finish();
      const int b = b0 + rr;
      // the warp's store stage: 1 KB of location buffer (s + 1) & 1, which
      // no thread reads before the next chunk is stashed there
      uint32_t* st = reinterpret_cast<uint32_t*>(sloc + ((s + 1) & 1) * BUF) +
                     warp * 256;
      if constexpr (NL == 8) {
        uint32_t out[8];
        bitslice_bytes8(acc.c, out);
        if (rr < nr && w < nw) {
          const int c = __ldg(cthr + rows.src(b));
          uint32_t m = 0;
          if (c <= 255) {
            const uint32_t f4 = (uint32_t)max(c, 0) * 0x01010101u;
#pragma unroll
            for (int k = 0; k < 8; ++k)
              m |= mask4(out[k], sthr8[w * 8 + k], f4) << (4 * k);
          }
          mask[(size_t)rows.dst(b) * W + w0 + w] = m & ~snever[w];
        }
        // stage the warp's 4 reads x 256 byte counts, then store each
        // read's tile row of int32 counts with whole 512-byte spans
        uint4* dst = reinterpret_cast<uint4*>(st + lane * 8);
        dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
        dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
        __syncwarp();
#pragma unroll
        for (int step = 0; step < 8; ++step) {
          const int p = step * 32 + lane;
          const int rl = p >> 6, q = p & 63;
          const int r = warp * (32 / WT) + rl;
          if (r < nr && q < nw * 8) {
            const uint32_t x = st[p];
            const int4 v = make_int4(
                (int)__byte_perm(x, 0, 0x4440), (int)__byte_perm(x, 0, 0x4441),
                (int)__byte_perm(x, 0, 0x4442), (int)__byte_perm(x, 0, 0x4443));
            reinterpret_cast<int4*>(
                counts + ((size_t)rows.dst(b0 + r) * W + w0) * 32)[q] = v;
          }
        }
        __syncwarp();
      } else if constexpr (NL == 9) {
        // as NL = 8, with plane 8 (bit 8 of each count) beside the bytes
        uint32_t out[8];
        bitslice_bytes8(acc.c, out);
        const uint32_t c8 = acc.c[8];
        if (rr < nr && w < nw)
          mask[(size_t)rows.dst(b) * W + w0 + w] =
              bitslice_mask9(out, c8, sthr8 + w * 8, shi[w], snever[w],
                             __ldg(cthr + rows.src(b)));
        uint4* dst = reinterpret_cast<uint4*>(st + lane * 8);
        dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
        dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
        __syncwarp();
#pragma unroll
        for (int step = 0; step < 8; ++step) {
          const int p = step * 32 + lane;
          const int rl = p >> 6, q = p & 63;
          const int r = warp * (32 / WT) + rl;
          // bit 8 of targets 4q..4q+3: plane 8 of the lane that counted
          // read rl's word q / 8
          const uint32_t h8 =
              __shfl_sync(0xffffffffu, c8, rl * WT + (q >> 3));
          if (r < nr && q < nw * 8) {
            int v[4];
            bitslice_expand4(st[p], h8 >> (4 * (q & 7)), v);
            reinterpret_cast<int4*>(
                counts + ((size_t)rows.dst(b0 + r) * W + w0) * 32)[q] =
                make_int4(v[0], v[1], v[2], v[3]);
          }
        }
        __syncwarp();
      } else {
        if (rr < nr && w < nw) {
          const size_t g = (size_t)rows.dst(b) * W + w0 + w;
          mask[g] = bitslice_store16(acc.c, thr + (size_t)(w0 + w) * 32,
                                     __ldg(cthr + rows.src(b)), counts + g * 32);
        }
      }
      acc.init();
    }
    if (s + 1 < n_steps) {
      if (round_end) __syncthreads();  // the stage before the next stash
      stash(s + 1);
    }
    __syncthreads();
  }
}

// One CTA of the row ring, for rows too many for a slice tile: no row is
// worth keeping, so each warp streams the rows it needs.  A CTA owns span
// words (a power of two, 32..512) from w0 and its reads b_lo .. b_hi-1;
// warp j counts 32-word slice j % (span / 32) of the CTA's reads j /
// (span / 32), that plus ring_reads(span), and so on, one read at a time.
// A stage is RING_KC windows of the read: their h row segments of the
// warp's 32 words, copied by the warp's own lanes into the warp's own ring
// of ring_depth(H) stages in shared memory with cp.async (16-byte copies
// where the rows allow, else 4-byte), ring_depth(H) - 1 stages in flight
// while one is counted.  Nothing but the warp waits on a stage, so one
// slow row holds up 32 words of one read, not the CTA.  Each lane ANDs its
// word's h rows of each window and feeds the carry-save counter; at the
// read's end the warp writes its 4 KB of counts through its 1 KB stage
// with whole 512-byte stores, as the slice does.  The rows of each stage
// (lane i h + j holds window i, hash j; -1 past K) are loaded two stages
// before their copies are issued; the read's loc row (K5''s pb[order[b]],
// two dependent loads) once a read.  Rows as for slice_count (row n_rows
// is `last`); smem holds geo::ring_smem(span, H) bytes.
template <int NL, int H, class Rows>
__device__ __forceinline__ void ring_count(
    const uint32_t* __restrict__ base, int n_rows,
    const uint32_t* __restrict__ last, int W, int w0, int span,
    const int32_t* __restrict__ loc, int K, const int32_t* __restrict__ cthr,
    const int32_t* __restrict__ thr, int32_t* __restrict__ counts,
    uint32_t* __restrict__ mask, int b_lo, int b_hi, Rows rows,
    uint32_t* smem) {
  constexpr int KC = geo::RING_KC;
  constexpr int D = geo::ring_depth(H);
  constexpr int SW = geo::ring_stage_words(H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = min(span, W - w0);
  uint32_t* sthr8 = smem;                 // [span][8]
  uint32_t* snever = sthr8 + span * 8;    // [span]
  uint32_t* shi = snever + span;          // [span]
  for (int idx = tid; idx < span * 8; idx += geo::RING_THREADS)
    stage_floors<NL>(thr + (size_t)w0 * 32, idx, nw, sthr8, snever, shi,
                     span);  // whole warps: span * 8 is a multiple of 256
  __syncthreads();  // the only CTA barrier: warps run on their own from here

  uint32_t* ring = shi + span + warp * (D * SW + 256);  // [D][SW]
  uint32_t* st = ring + D * SW;                         // the store stage
  const int nsl = span >> 5;
  const int R = geo::RING_WARPS / nsl;  // reads at once
  const int g = warp / nsl, wl = (warp % nsl) << 5;  // read lane, first word
  const int w = wl + lane;
  if (wl >= nw) return;  // a slice past the rows
  // 16-byte copies where every row segment starts on 16 bytes
  const bool vec = W % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(base) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(last) & 15) == 0;
  const int n_reads = b_hi - b_lo > g ? (b_hi - b_lo - g + R - 1) / R : 0;
  const int n_chunks = max(1, (K + KC - 1) / KC);
  const int n_steps = n_reads * n_chunks;

  // lane i H + j's row of stage t: window i, hash j of the stage's read
  int src_read = -1, src_row = 0;
  auto load_row = [&](int t) -> int32_t {
    if (t >= n_steps || lane >= KC * H) return -1;
    const int k = t % n_chunks * KC + lane / H;
    if (k >= K) return -1;
    const int read = t / n_chunks;
    if (read != src_read) {
      src_read = read;
      src_row = rows.src(b_lo + g + read * R);
    }
    return __ldg(loc + ((size_t)src_row * K + k) * H + lane % H);
  };
  // stage t's copies into ring slot t % D (an empty group past the end)
  auto issue = [&](int t, int32_t rowv) {
    if (t < n_steps) {
      uint32_t* dst = ring + (t % D) * SW;
      const uint32_t* col = base + w0 + wl;
      const uint32_t* lcol = last + w0 + wl;
      if (vec) {
#pragma unroll
        for (int m = 0; m < geo::ring_copies_per_lane(H, 4); ++m) {
          const geo::Copy c = geo::ring_copy(lane + 32 * m, 4);
          const int row = __shfl_sync(0xffffffffu, rowv, c.seg);
          if (row >= 0 && wl + c.word < nw)
            cp_async<16>(dst + c.seg * 32 + c.word,
                         (row < n_rows ? col + (size_t)row * W : lcol) +
                             c.word);
        }
      } else {
#pragma unroll
        for (int m = 0; m < geo::ring_copies_per_lane(H, 1); ++m) {
          const geo::Copy c = geo::ring_copy(lane + 32 * m, 1);
          const int row = __shfl_sync(0xffffffffu, rowv, c.seg);
          if (row >= 0 && wl + c.word < nw)
            cp_async<4>(dst + c.seg * 32 + c.word,
                        (row < n_rows ? col + (size_t)row * W : lcol) +
                            c.word);
        }
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < D - 1; ++t) issue(t, load_row(t));
  int32_t va = load_row(D - 1), vb = load_row(D);

  CsaCounter<NL> acc;
  acc.init();
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<D - 2>();  // this lane's copies of stage s
    __syncwarp();            // every lane's; slot (s - 1) % D is free
    issue(s + D - 1, va);
    va = vb;
    vb = load_row(s + D + 1);
    const int kc = min(KC, K - s % n_chunks * KC);
    if (w < nw) {
      const uint32_t* sr = ring + (s % D) * SW + lane;
      if (kc == KC) {
        uint32_t d[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          uint32_t x = sr[u * H * 32];
#pragma unroll
          for (int jj = 1; jj < H; ++jj) x &= sr[(u * H + jj) * 32];
          d[u] = x;
        }
        acc.add8(d);
      } else {
        for (int u = 0; u < kc; ++u) {
          uint32_t x = sr[u * H * 32];
#pragma unroll
          for (int jj = 1; jj < H; ++jj) x &= sr[(u * H + jj) * 32];
          acc.add1(x);
        }
      }
    }
    if (s % n_chunks == n_chunks - 1) {  // the read's last stage
      acc.finish();
      const int b = b_lo + g + s / n_chunks * R;
      int32_t* crow = counts + ((size_t)rows.dst(b) * W + w0 + wl) * 32;
      if constexpr (NL <= 9) {
        uint32_t out[8];
        bitslice_bytes8(acc.c, out);
        if (w < nw) {
          const int c = __ldg(cthr + rows.src(b));
          uint32_t m;
          if constexpr (NL == 9) {
            m = bitslice_mask9(out, acc.c[8], sthr8 + w * 8, shi[w],
                               snever[w], c);
          } else {
            m = 0;
            if (c <= 255) {
              const uint32_t f4 = (uint32_t)max(c, 0) * 0x01010101u;
#pragma unroll
              for (int k = 0; k < 8; ++k)
                m |= mask4(out[k], sthr8[w * 8 + k], f4) << (4 * k);
            }
            m &= ~snever[w];
          }
          mask[(size_t)rows.dst(b) * W + w0 + w] = m;
        }
        uint4* sd = reinterpret_cast<uint4*>(st + lane * 8);
        sd[0] = make_uint4(out[0], out[1], out[2], out[3]);
        sd[1] = make_uint4(out[4], out[5], out[6], out[7]);
        __syncwarp();
        // uint32 p of the stage holds targets 4p..4p+3 of the warp's
        // 1,024 (word p / 8, counted by lane p / 8)
#pragma unroll
        for (int step = 0; step < 8; ++step) {
          const int p = step * 32 + lane;
          int v[4];
          if constexpr (NL == 9) {
            const uint32_t h8 = __shfl_sync(0xffffffffu, acc.c[8], p >> 3);
            bitslice_expand4(st[p], h8 >> (4 * (p & 7)), v);
          } else {
            bitslice_expand4(st[p], 0u, v);
          }
          if (wl + (p >> 3) < nw)
            reinterpret_cast<int4*>(crow)[p] =
                make_int4(v[0], v[1], v[2], v[3]);
        }
        __syncwarp();
      } else {
        // counts of 16 or 32 planes: a quarter of each word's targets at a
        // time through the stage (8 counts a lane), 32-byte pieces a lane
        // pair; floors from device memory (K >= 512, off the main paths)
        const int32_t* tw = thr + (size_t)(w0 + w) * 32;
        const int c = __ldg(cthr + rows.src(b));
        uint32_t m = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int j = 8 * q + e;
            uint32_t cnt = 0;
#pragma unroll
            for (int l = 0; l < NL; ++l) cnt |= ((acc.c[l] >> j) & 1u) << l;
            st[lane * 8 + e] = cnt;
            if (w < nw && (int)cnt >= max(__ldg(tw + j), c)) m |= 1u << j;
          }
          __syncwarp();
#pragma unroll
          for (int step = 0; step < 2; ++step) {
            const int p = step * 32 + lane;  // lane p / 2's counts 4 (p % 2)..
            if (wl + (p >> 1) < nw)
              reinterpret_cast<int4*>(crow + (p >> 1) * 32 + 8 * q)[p & 1] =
                  reinterpret_cast<const int4*>(st)[p];
          }
          __syncwarp();
        }
        if (w < nw) mask[(size_t)rows.dst(b) * W + w0 + w] = m;
      }
      acc.init();
    }
  }
  cp_async_wait<0>();
}

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
};

// The current device's SM count and opt-in shared memory per block, asked
// once per device.
inline cudaError_t device_info(DeviceInfo* out) {
  static DeviceInfo cache[64];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  DeviceInfo& d = cache[dev];
  if (d.sms == 0) {
    err = cudaDeviceGetAttribute(&d.smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      d.sms = 0;
      return err;
    }
  }
  *out = d;
  return cudaSuccess;
}

// The variant for these shapes on this device (geo::pick).
inline int variant(const DeviceInfo& dev, int W, int S_ext, int h) {
  return geo::pick(dev.smem_optin, W, S_ext, h);
}

}  // namespace slice
