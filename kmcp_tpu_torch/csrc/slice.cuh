// The shared-memory slice counter shared by K2' (count_mask.cu, a read
// range of one bit matrix) and K5' (pair_count.cu, the pairs of one block):
// a CTA copies one tile of 8 words (256 targets) of every row of its rows
// into shared memory once, then runs rounds of 128 reads x 8 words against
// it, so every gathered word is a shared-memory load.
//
// The reads' locations come in chunks of KC windows, double-buffered in
// shared memory (plane major, pre-scaled to the tile's row pitch), each
// chunk's global loads issued before the current chunk's counting, one
// barrier a chunk.  Windows go eight at a time, loads first, into a
// carry-save counter (bitslice.cuh CsaCounter).  With counts below 256
// (NL = 8, single-end rows) the epilogue transposes the planes to byte
// counts, compares four targets at once, and writes the counts through a
// per-warp stage in shared memory so that a warp stores 512 contiguous
// bytes per instruction.  Counts below 512 (NL = 9, paired rows of up to
// 2 x 250 bp) keep that epilogue and add the ninth plane as one word of
// "256" bits: the mask compares it on whole 32-target words beside the
// byte compares (bitslice_mask9), and each count leaves the stage as its
// byte with bit 8 from that word, which a warp shuffle brings to the lane
// that stores it.  NL = 16 and 32 (K >= 512, off the main paths) take the
// generic per-thread epilogue (bitslice_store16) and spill at 1,024
// threads.
//
// Which reads a CTA counts, which row of loc holds their windows and which
// row of the outputs they land on is the caller's Rows policy: src(i) is
// the loc and cthr row of the CTA's i-th read, dst(i) its output row.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bitslice.cuh"

namespace slice {

constexpr int WT = 8;             // words per tile
constexpr int SLICE_READS = 128;  // reads a CTA runs at once
constexpr int SLICE_THREADS = SLICE_READS * WT;

// Shared memory of a slice CTA, in 4-byte words.
constexpr int STAGE_WORDS = SLICE_THREADS / 32 * 4 * 64;  // 1 KB a warp

// Windows of locations staged at a time: 64 at h = 1 (3-5% faster than 32
// at K2''s wide shape, as there are half the barriers), else 32.
__host__ __device__ constexpr int kc_for(int h) { return h == 1 ? 64 : 32; }
__host__ __device__ constexpr int sloc_pitch(int h) {
  return kc_for(h) * h + 4;
}

// The tile of every row, the floors (byte floors, "never" and bit-8
// words), the location buffers and the stage.
inline size_t slice_smem(int S_ext, int h) {
  return ((size_t)S_ext * WT + WT * 8 + 2 * WT +
          2 * SLICE_READS * sloc_pitch(h) + STAGE_WORDS) * 4;
}

// 16 bytes global -> shared, asynchronously (Ampere+ cp.async, L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// One CTA of the slice counter.  Its rows are base[0 .. n_rows-1] (pitch W
// words) and then the all-zero row `last` (local row n_rows, where the
// sentinel windows point); it counts tile w0 .. w0+7 of them for its reads
// b_lo .. b_hi-1 (loc [*, K, H], rows < n_rows + 1), with per-target floors
// thr[32 w0 ..] and per-read floors cthr[src(b)], into counts [*, 32 W] and
// mask [*, W] at row dst(b).  smem holds slice_smem(n_rows + 1, H) bytes.
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
  constexpr int KC = LEAN ? 8 : kc_for(H);
  constexpr int PITCH = sloc_pitch(H);
  constexpr int PRE = SLICE_READS * KC * H / SLICE_THREADS;  // loads a chunk
  const int S_ext = n_rows + 1;
  uint32_t* slice = smem;                           // [S_ext][WT]
  uint32_t* sthr8 = slice + (size_t)S_ext * WT;     // [WT][8] byte floors
  uint32_t* snever = sthr8 + WT * 8;                // [WT] floors > cap
  uint32_t* shi = snever + WT;                      // [WT] floors' bit 8
  int32_t* sloc = reinterpret_cast<int32_t*>(shi + WT);  // [2][reads][PITCH]
  uint32_t* stage = reinterpret_cast<uint32_t*>(sloc + 2 * SLICE_READS * PITCH);

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
      cp_async16(slice + e * 4, row + w0 + (e & 1) * 4);
    }
    cp_async_commit();
  } else {
    for (int e = tid; e < S_ext * WT; e += SLICE_THREADS) {
      const int r = e / WT, w = e % WT;
      const uint32_t* row = r < n_rows ? base + (size_t)r * W : last;
      slice[e] = w < nw ? __ldg(row + w0 + w) : 0u;
    }
  }
  if (tid < WT * 8) {  // word w, targets 4k..4k+3 of it
    const int w = tid / 8, k = tid % 8;
    uint32_t t4 = 0, nev = 0, hi = 0;
    for (int e = 0; e < 4; ++e) {
      const int t = w < nw ? __ldg(thr + (size_t)(w0 + w) * 32 + 4 * k + e)
                           : 0;
      const FloorSplit f = floor_split(t, NL == 9 ? 511 : 255);
      t4 |= f.lo << (8 * e);
      nev |= f.never << (4 * k + e);
      hi |= f.hi << (4 * k + e);
    }
    sthr8[tid] = t4;
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      nev |= __shfl_xor_sync(0xffffffffu, nev, o);
      hi |= __shfl_xor_sync(0xffffffffu, hi, o);
    }
    if (k == 0) {
      snever[w] = nev;
      shi[w] = hi;
    }
  }

  const int rr = tid / WT, w = tid % WT;
  const int n_chunks = max(1, (K + KC - 1) / KC);
  const int n_steps = (b_hi - b_lo + SLICE_READS - 1) / SLICE_READS * n_chunks;

  // chunk s: the locations of round s / n_chunks, windows of chunk
  // s % n_chunks, into registers, then into buffer s & 1.  Element e of a
  // chunk is (read e / (KC H), window and hash e % (KC H)), so the index
  // math divides by constants; windows past K are skipped.
  int32_t pre[PRE];
  auto fetch = [&](int s) {
    const int b0 = b_lo + s / n_chunks * SLICE_READS;
    const int k0 = s % n_chunks * KC;
    const int nr = min(SLICE_READS, b_hi - b0), kc = K - k0;
#pragma unroll
    for (int m = 0; m < PRE; ++m) {
      const int e = tid + m * SLICE_THREADS;
      const int r = e / (KC * H), q = e % (KC * H);
      if (r < nr && q / H < kc)
        pre[m] = __ldg(loc + ((size_t)rows.src(b0 + r) * K + k0) * H + q);
    }
  };
  auto stash = [&](int s) {
    const int b0 = b_lo + s / n_chunks * SLICE_READS;
    const int k0 = s % n_chunks * KC;
    const int nr = min(SLICE_READS, b_hi - b0), kc = K - k0;
    int32_t* buf = sloc + (s & 1) * SLICE_READS * PITCH;
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
  if (async) cp_async_wait_all();
  __syncthreads();

  CsaCounter<NL> acc;
  acc.init();
  const uint32_t* sw = slice + w;
  for (int s = 0; s < n_steps; ++s) {
    const int b0 = b_lo + s / n_chunks * SLICE_READS;
    const int nr = min(SLICE_READS, b_hi - b0);
    const int kc = max(0, min(KC, K - s % n_chunks * KC));
    if (s + 1 < n_steps) fetch(s + 1);
    if (rr < nr) {
      const int32_t* lr = sloc + (s & 1) * SLICE_READS * PITCH + rr * PITCH;
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
    if (s % n_chunks == n_chunks - 1) {  // the round's last chunk
      acc.finish();
      const int b = b0 + rr;
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
        uint32_t* st = stage + warp * 256;
        uint4* dst = reinterpret_cast<uint4*>(st + (lane / WT) * 64 + w * 8);
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
        uint32_t* st = stage + warp * 256;
        uint4* dst = reinterpret_cast<uint4*>(st + (lane / WT) * 64 + w * 8);
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
    if (s + 1 < n_steps) stash(s + 1);
    __syncthreads();
  }
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

// Whether rows of W words, S_ext of them at h hashes, take the slice
// counter: at least one whole tile, and every row of it in shared memory.
inline bool use_slice(const DeviceInfo& dev, int W, int S_ext, int h) {
  return W >= WT && slice_smem(S_ext, h) <= (size_t)dev.smem_optin;
}

}  // namespace slice
