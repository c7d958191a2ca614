// K2' count_mask: Bloom-row gather + row-AND + positional popcount + fused
// threshold mask.
//
// Replaces the Pallas TPU kernels kmcp_tpu/search/pallas_count.py:
// make_pallas_count (DMA-ring, masked=), make_pallas_count_resident and
// make_pallas_count_masked.  Those three differ only in where the TPU keeps
// the bit matrix (HBM ring, VMEM slabs, VMEM with mask); here one entry
// point serves all three and every row width.  Targets stay in natural
// order t = 32 w + j: the TPU's bit-major lane layout is not ported.
//
// For read b and 32-target word w:
//   counts[b, 32w + j] = sum_{i<K} bit_j( AND_{jj<h} bits[loc[b, i, jj], w] )
//   mask[b, w] bit j   = counts[b, 32w + j] >= max(thr[32w + j], cthr[b])
//
// What bounds it on an H100.  Counted once, the bytes are the matrix, the
// locations and the counts (4 B per (read, target)): for 2,048 reads at
// 131,072 targets and 3,579 rows, 1.17 GB, 0.35 ms at 3.35 TB/s.  But the
// gather reads B * K * h * W words of 4 bytes (4.7 GB there) from rows the
// hash picks, and the first design, one thread per (read, word) with one
// dependent 4-byte load in flight, ran at about 5% of that bound.  Two
// variants, chosen in kmcp_count_mask:
//
// - slice (W >= 8 and the tile's rows fit in shared memory, about 4,800
//   rows at h = 1): a CTA owns one tile of 8 words (256 targets) and copies
//   that tile of every row, the sentinel included, into shared memory once;
//   1,024 threads then run rounds of 128 reads x 8 words against it, so
//   every gathered word is a shared-memory load and the matrix is read from
//   device memory once per CTA.  The reads' locations come in chunks of 64
//   windows (32 for h > 1), double-buffered in shared memory (the next chunk's global
//   loads in flight while the current one counts, one barrier a chunk),
//   four windows to a 16-byte load.  Windows go eight at a time, loads
//   first, into a carry-save counter (bitslice.cuh CsaCounter), about two
//   logic ops a word.  With K < 256 the epilogue transposes the bit planes
//   into byte counts (bitslice_bytes8), thresholds four targets per
//   instruction, and stores through a per-warp stage in shared memory so
//   that each warp store instruction writes 512 contiguous bytes of counts
//   (scattered 16-byte stores ran at a quarter of the card's write rate).
// - gather (narrow rows, or rows too many for shared memory): one thread
//   per (read, word), neighbouring threads on neighbouring words, the
//   locations read through L1; eight windows' loads are issued before
//   their adds into the same carry-save counter, and the 32 counts leave
//   as eight 16-byte stores.
//
// Counts need at most NL = 8, 16 or 32 planes (K < 256, < 65,536, else).
// The caller bounds device memory by launching on read chunks whose counts
// stay near 1 GB (counts for a 16k-read batch at 131k targets would be
// 8.6 GB).

#include <cstdint>
#include <cuda_runtime.h>

#include "bitslice.cuh"

namespace {

constexpr int WT = 8;             // words per tile of the slice variant
constexpr int SLICE_READS = 128;  // reads a slice CTA runs at once
constexpr int SLICE_THREADS = SLICE_READS * WT;
constexpr int GATHER_THREADS = 128;

// Shared memory of a slice CTA, in 4-byte words.
constexpr int STAGE_WORDS = SLICE_THREADS / 32 * 4 * 64;  // 1 KB a warp

// Windows of locations staged at a time: 64 at h = 1 (3-5% faster than 32
// at the wide shape, as there are half the barriers), else 32.
__host__ __device__ constexpr int kc_for(int h) { return h == 1 ? 64 : 32; }
__host__ __device__ constexpr int sloc_pitch(int h) {
  return kc_for(h) * h + 4;
}

size_t slice_smem(int S_ext, int h) {
  return ((size_t)S_ext * WT + WT * 8 + WT + 2 * SLICE_READS * sloc_pitch(h) +
          STAGE_WORDS) * 4;
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

// The slice variant (see the top of the file).  A CTA runs rounds of 128
// reads of its read range against its 8-word tile; the reads' locations
// come in chunks of KC windows, double-buffered in shared memory (plane
// major, pre-scaled to the tile's row pitch), each chunk's global loads
// issued before the current chunk's counting, one barrier a chunk.  With
// counts below 256 (NL = 8) the epilogue transposes the planes to byte
// counts, compares four targets at once, and writes the counts through a
// per-warp stage in shared memory so that a warp stores 512 contiguous
// bytes per instruction.
template <int NL, int H>
__global__ void __launch_bounds__(SLICE_THREADS)
count_mask_slice(const uint32_t* __restrict__ bits, int W, int S_ext,
                 const int32_t* __restrict__ loc, int B, int K,
                 const int32_t* __restrict__ cthr,
                 const int32_t* __restrict__ thr,
                 int32_t* __restrict__ counts, uint32_t* __restrict__ mask,
                 int reads_per_cta) {
  constexpr int KC = kc_for(H);
  constexpr int PITCH = sloc_pitch(H);
  constexpr int PRE = SLICE_READS * KC * H / SLICE_THREADS;  // loads a chunk
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* slice = smem;                           // [S_ext][WT]
  uint32_t* sthr8 = slice + (size_t)S_ext * WT;     // [WT][8] byte floors
  uint32_t* snever = sthr8 + WT * 8;                // [WT] floors > 255
  int32_t* sloc = reinterpret_cast<int32_t*>(snever + WT);  // [2][reads][PITCH]
  uint32_t* stage = reinterpret_cast<uint32_t*>(sloc + 2 * SLICE_READS * PITCH);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int w0 = blockIdx.x * WT;
  const int nw = min(WT, W - w0);
  // the tile of every row: with whole 16-byte halves in device memory, as
  // asynchronous 16-byte copies, all in flight while the floors and the
  // first locations load; else word by word
  const bool async = nw == WT && W % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(bits) & 15) == 0;
  if (async) {
    for (int e = tid; e < S_ext * 2; e += SLICE_THREADS)
      cp_async16(slice + e * 4, bits + (size_t)(e >> 1) * W + w0 + (e & 1) * 4);
    cp_async_commit();
  } else {
    for (int e = tid; e < S_ext * WT; e += SLICE_THREADS) {
      const int r = e / WT, w = e % WT;
      slice[e] = w < nw ? __ldg(bits + (size_t)r * W + w0 + w) : 0u;
    }
  }
  if (tid < WT * 8) {  // word w, targets 4k..4k+3 of it
    const int w = tid / 8, k = tid % 8;
    uint32_t t4 = 0, nev = 0;
    for (int e = 0; e < 4; ++e) {
      const int t = w < nw ? __ldg(thr + (size_t)(w0 + w) * 32 + 4 * k + e)
                           : 0;
      t4 |= (uint32_t)min(max(t, 0), 255) << (8 * e);
      nev |= (uint32_t)(t > 255) << (4 * k + e);
    }
    sthr8[tid] = t4;
    nev |= __shfl_xor_sync(0xffffffffu, nev, 1);
    nev |= __shfl_xor_sync(0xffffffffu, nev, 2);
    nev |= __shfl_xor_sync(0xffffffffu, nev, 4);
    if (k == 0) snever[w] = nev;
  }

  const int rr = tid / WT, w = tid % WT;
  const int b_lo = blockIdx.y * reads_per_cta;
  const int b_hi = min(B, b_lo + reads_per_cta);
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
        pre[m] = __ldg(loc + ((size_t)(b0 + r) * K + k0) * H + q);
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
#pragma unroll
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
          const int c = __ldg(cthr + b);
          uint32_t m = 0;
          if (c <= 255) {
            const uint32_t f4 = (uint32_t)max(c, 0) * 0x01010101u;
#pragma unroll
            for (int k = 0; k < 8; ++k)
              m |= mask4(out[k], sthr8[w * 8 + k], f4) << (4 * k);
          }
          mask[(size_t)b * W + w0 + w] = m & ~snever[w];
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
                counts + ((size_t)(b0 + r) * W + w0) * 32)[q] = v;
          }
        }
        __syncwarp();
      } else {
        if (rr < nr && w < nw) {
          const size_t g = (size_t)b * W + w0 + w;
          mask[g] = bitslice_store16(acc.c, thr + (size_t)(w0 + w) * 32,
                                     __ldg(cthr + b), counts + g * 32);
        }
      }
      acc.init();
    }
    if (s + 1 < n_steps) stash(s + 1);
    __syncthreads();
  }
}

template <int NL>
__global__ void __launch_bounds__(GATHER_THREADS)
count_mask_gather(const uint32_t* __restrict__ bits, int W,
                  const int32_t* __restrict__ loc, int B, int K, int h,
                  const int32_t* __restrict__ cthr,
                  const int32_t* __restrict__ thr,
                  int32_t* __restrict__ counts, uint32_t* __restrict__ mask) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)B * W) return;
  const int b = (int)(g / W);
  const int w = (int)(g % W);
  const int32_t* lb = loc + (size_t)b * K * h;
  const uint32_t* bw = bits + w;

  CsaCounter<NL> acc;
  acc.init();
  int i = 0;
  for (; i + 8 <= K; i += 8) {
    uint32_t d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int32_t* li = lb + (size_t)(i + u) * h;
      uint32_t x = __ldg(bw + (size_t)__ldg(li) * W);
      for (int jj = 1; jj < h; ++jj)
        x &= __ldg(bw + (size_t)__ldg(li + jj) * W);
      d[u] = x;
    }
    acc.add8(d);
  }
  for (; i < K; ++i) {
    const int32_t* li = lb + (size_t)i * h;
    uint32_t x = __ldg(bw + (size_t)__ldg(li) * W);
    for (int jj = 1; jj < h; ++jj) x &= __ldg(bw + (size_t)__ldg(li + jj) * W);
    acc.add1(x);
  }
  acc.finish();
  mask[g] = bitslice_store16(acc.c, thr + (size_t)w * 32, __ldg(cthr + b),
                             counts + (size_t)g * 32);
}

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
};

cudaError_t device_info(DeviceInfo* out) {
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

bool use_slice(const DeviceInfo& dev, int W, int S_ext, int h) {
  return W >= WT && slice_smem(S_ext, h) <= (size_t)dev.smem_optin;
}

template <int NL, int H>
cudaError_t launch_slice(const DeviceInfo& dev, const uint32_t* bits, int W,
                         int S_ext, const int32_t* loc, int B, int K,
                         const int32_t* cthr, const int32_t* thr,
                         int32_t* counts, uint32_t* mask, cudaStream_t stream) {
  const size_t smem = slice_smem(S_ext, H);
  const cudaError_t err = cudaFuncSetAttribute(
      count_mask_slice<NL, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // at least one CTA per SM (1,024 threads of 64 registers fill an SM);
  // past that, one CTA per tile, so that each tile's rows are copied once
  // (at the wide shape that ran 5% faster than two CTAs per tile)
  const int tiles = (W + WT - 1) / WT;
  const int per_tile = max(1, (dev.sms + tiles - 1) / tiles);
  int reads = (B + per_tile - 1) / per_tile;
  reads = (reads + SLICE_READS - 1) / SLICE_READS * SLICE_READS;
  const dim3 grid(tiles, (B + reads - 1) / reads);
  count_mask_slice<NL, H><<<grid, SLICE_THREADS, smem, stream>>>(
      bits, W, S_ext, loc, B, K, cthr, thr, counts, mask, reads);
  return cudaSuccess;
}

template <int NL>
cudaError_t launch(const uint32_t* bits, int W, int S_ext, const int32_t* loc,
                   int B, int K, int h, const int32_t* cthr,
                   const int32_t* thr, int32_t* counts, uint32_t* mask,
                   cudaStream_t stream) {
  DeviceInfo dev;
  cudaError_t err = device_info(&dev);
  if (err != cudaSuccess) return err;
  if (use_slice(dev, W, S_ext, h)) {
    switch (h) {
      case 1: err = launch_slice<NL, 1>(dev, bits, W, S_ext, loc, B, K, cthr,
                                        thr, counts, mask, stream); break;
      case 2: err = launch_slice<NL, 2>(dev, bits, W, S_ext, loc, B, K, cthr,
                                        thr, counts, mask, stream); break;
      case 3: err = launch_slice<NL, 3>(dev, bits, W, S_ext, loc, B, K, cthr,
                                        thr, counts, mask, stream); break;
      default: err = launch_slice<NL, 4>(dev, bits, W, S_ext, loc, B, K, cthr,
                                         thr, counts, mask, stream);
    }
    if (err != cudaSuccess) return err;
  } else {
    const long long n = (long long)B * W;
    const long long blocks = (n + GATHER_THREADS - 1) / GATHER_THREADS;
    count_mask_gather<NL><<<(unsigned)blocks, GATHER_THREADS, 0, stream>>>(
        bits, W, loc, B, K, h, cthr, thr, counts, mask);
  }
  return cudaGetLastError();
}

}  // namespace

// bits int32/uint32 [S_ext, W] (row S_ext-1 all zero); loc int32 [B, K, h]
// with rows < S_ext; cthr int32 [B]; thr int32 [32 W]; counts int32
// [B, 32 W] (16-byte aligned); mask int32/uint32 [B, W].  Returns the CUDA
// error of the launch (0 on success).
extern "C" int kmcp_count_mask(const void* bits, int W, int S_ext,
                               const void* loc, int B, int K, int h,
                               const void* cthr, const void* thr, void* counts,
                               void* mask, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const int nlev = bitslice_levels(K);  // counts <= K
  const auto* b = (const uint32_t*)bits;
  const auto* l = (const int32_t*)loc;
  const auto* ct = (const int32_t*)cthr;
  const auto* t = (const int32_t*)thr;
  auto* c = (int32_t*)counts;
  auto* m = (uint32_t*)mask;
  const auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (nlev <= 8)
    err = launch<8>(b, W, S_ext, l, B, K, h, ct, t, c, m, s);
  else if (nlev <= 16)
    err = launch<16>(b, W, S_ext, l, B, K, h, ct, t, c, m, s);
  else
    err = launch<32>(b, W, S_ext, l, B, K, h, ct, t, c, m, s);
  return (int)err;
}

// The variant kmcp_count_mask runs at these shapes on the current device:
// 1 slice, 0 gather, or minus the CUDA error of the device query.
extern "C" int kmcp_count_mask_variant(int W, int S_ext, int h) {
  DeviceInfo dev;
  const cudaError_t err = device_info(&dev);
  if (err != cudaSuccess) return -(int)err;
  return use_slice(dev, W, S_ext, h) ? 1 : 0;
}
