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
// What bounds it on an H100.  Counted once, the bytes are the rows the
// locations touch, the locations and the counts (4 B per (read, target)):
// for 2,048 reads at 131,072 targets and 3,579 rows, 1.17 GB, 0.35 ms at
// 3.35 TB/s; at a real KMCP DB's 2^20 rows (GTDB r202's mean chunk at -f
// 0.3), 240k rows touched and 5.0 GB, 1.5 ms.  But the gather reads B * K
// * h * W words of 4 bytes (4.7 GB at either) from rows the hash picks.
// The variants, chosen in kmcp_count_mask from the shapes (geometry.cuh
// geo::pick):
//
// - slice (W >= 8 and one tile of every row in shared memory: up to 5,077
//   rows and the sentinel at h = 1 on an H100's 227 KB): a CTA owns one
//   tile of 8 words (256 targets) and copies that tile of every row, the
//   sentinel included, into shared memory once; 1,024 threads then run
//   rounds of 128 reads x 8 words against it, so every gathered word is a
//   shared-memory load and the matrix is read from device memory once per
//   CTA.  The reads' locations come in chunks of 64 windows (32 for h > 1),
//   double-buffered in shared memory, four windows to a 16-byte load.  Windows go eight at a time, loads first,
//   into a carry-save counter (bitslice.cuh CsaCounter), about two logic
//   ops a word.  With K < 512 the epilogue transposes the low 8 bit planes
//   into byte counts (bitslice_bytes8), thresholds four targets per
//   instruction (a ninth plane, K >= 256, is compared as one word of bit 8
//   beside them), and stores through a per-warp stage in shared memory (in
//   the location buffer the next chunk fills) so that each warp store
//   instruction writes 512 contiguous bytes of counts (scattered 16-byte
//   stores ran at a quarter of the card's write rate).
// - ring (W >= 8, rows past the tile: the DMA ring of make_pallas_count,
//   and past 5,077 rows the counterpart of make_pallas_count_resident's row
//   groups too): no row is worth keeping, so each warp streams the rows it
//   needs: 32 words of one read at a time, each window's h row segments
//   copied into the warp's own ring of 2-4 stages of shared memory with
//   cp.async (16-byte copies, stages in flight while one is counted, no
//   CTA barrier), ANDed and counted with the same counter, and stored
//   through the same byte-plane epilogue and 512-byte warp stores
//   (slice.cuh ring_count).  Slice tiles of 4, 2 and 1 words, which hold
//   up to 33,523 rows, ran slower than the ring at 16,000 rows (PERF.md).
// - gather (W < 8: the narrow DB, pass 1's one-word union rows): one
//   thread per (read, word), neighbouring threads on neighbouring words,
//   the locations read through L1; eight windows' loads are issued before
//   their adds into the same carry-save counter, and the 32 counts leave
//   as eight 16-byte stores.
//
// Counts need at most NL = 8, 9, 16 or 32 planes (K < 256, < 512, < 65,536,
// else).  Single-end rows (K = 140) take 8, paired rows of 2 x 150 bp (K =
// 300) and 2 x 250 bp (K = 492) take 9, which holds one more register than
// 8 and does not spill at 1,024 threads; 16 and 32 (K >= 512, off the main
// paths) keep the generic per-thread epilogue in the slice and spill
// there, and go a quarter word at a time through the warp stage in the
// ring.
// The caller bounds device memory by launching on read chunks whose counts
// stay near 1 GB (counts for a 16k-read batch at 131k targets would be
// 8.6 GB).

#include <cstdint>
#include <cuda_runtime.h>

#include "slice.cuh"

namespace {

using slice::SLICE_THREADS;
using slice::WT;

constexpr int GATHER_THREADS = 128;

// The slice variant (slice.cuh): CTA (x, y) counts word tile x of every
// row for reads y * reads_per_cta onwards.
template <int NL, int H>
__global__ void __launch_bounds__(SLICE_THREADS)
count_mask_slice(const uint32_t* __restrict__ bits, int W, int S_ext,
                 const int32_t* __restrict__ loc, int B, int K,
                 const int32_t* __restrict__ cthr,
                 const int32_t* __restrict__ thr,
                 int32_t* __restrict__ counts, uint32_t* __restrict__ mask,
                 int reads_per_cta) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int b_lo = blockIdx.y * reads_per_cta;
  slice::slice_count<NL, H>(
      bits, S_ext - 1, bits + (size_t)(S_ext - 1) * W, W, blockIdx.x * WT,
      loc, K, cthr, thr, counts, mask, b_lo, min(B, b_lo + reads_per_cta),
      slice::DenseRows{}, smem);
}

// The ring variant (slice.cuh ring_count): CTA (x, y) streams words x *
// span .. of the rows of reads y * reads_per_cta onwards.
template <int NL, int H>
__global__ void __launch_bounds__(geo::RING_THREADS, NL <= 9 ? 2 : 1)
count_mask_ring(const uint32_t* __restrict__ bits, int W, int S_ext,
                const int32_t* __restrict__ loc, int B, int K,
                const int32_t* __restrict__ cthr,
                const int32_t* __restrict__ thr,
                int32_t* __restrict__ counts, uint32_t* __restrict__ mask,
                int span, int reads_per_cta) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int b_lo = blockIdx.y * reads_per_cta;
  slice::ring_count<NL, H>(
      bits, S_ext - 1, bits + (size_t)(S_ext - 1) * W, W, blockIdx.x * span,
      span, loc, K, cthr, thr, counts, mask, b_lo,
      min(B, b_lo + reads_per_cta), slice::DenseRows{}, smem);
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

using slice::DeviceInfo;

struct Args {
  const uint32_t* bits;
  int W, S_ext;
  const int32_t* loc;
  int B, K;
  const int32_t *cthr, *thr;
  int32_t* counts;
  uint32_t* mask;
  cudaStream_t stream;
};

template <int NL, int H>
cudaError_t launch_slice(const DeviceInfo& dev, const Args& a) {
  const size_t smem = geo::slice_smem(a.S_ext, H);
  const cudaError_t err = cudaFuncSetAttribute(
      count_mask_slice<NL, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // at least one CTA per SM (1,024 threads of 64 registers fill an SM);
  // past that, one CTA per tile, so that each tile's rows are copied once
  // (at the wide shape that ran 5% faster than two CTAs per tile)
  const int tiles = (a.W + WT - 1) / WT;
  const int per_tile = max(1, (dev.sms + tiles - 1) / tiles);
  int reads = (a.B + per_tile - 1) / per_tile;
  reads = (reads + slice::SLICE_READS - 1) / slice::SLICE_READS *
          slice::SLICE_READS;
  const dim3 grid(tiles, (a.B + reads - 1) / reads);
  count_mask_slice<NL, H><<<grid, SLICE_THREADS, smem, a.stream>>>(
      a.bits, a.W, a.S_ext, a.loc, a.B, a.K, a.cthr, a.thr, a.counts, a.mask,
      reads);
  return cudaSuccess;
}

template <int NL, int H>
cudaError_t launch_ring(const DeviceInfo& dev, const Args& a) {
  const int span = geo::ring_span(a.W);
  const size_t smem = geo::ring_smem(span, H);
  const cudaError_t err = cudaFuncSetAttribute(
      count_mask_ring<NL, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // no row is kept, so CTAs need not be few: about 8 an SM over the launch
  // (4 waves of 2), whole rounds of reads each
  const int R = geo::ring_reads(span);
  const int tiles = (a.W + span - 1) / span;
  const int groups = max(1, (8 * dev.sms + tiles - 1) / tiles);
  int reads = (a.B + groups - 1) / groups;
  reads = (reads + R - 1) / R * R;
  const dim3 grid(tiles, (a.B + reads - 1) / reads);
  count_mask_ring<NL, H><<<grid, geo::RING_THREADS, smem, a.stream>>>(
      a.bits, a.W, a.S_ext, a.loc, a.B, a.K, a.cthr, a.thr, a.counts, a.mask,
      span, reads);
  return cudaSuccess;
}

template <int NL, int H>
cudaError_t launch_h(const DeviceInfo& dev, int variant, const Args& a) {
  return variant == geo::SLICE ? launch_slice<NL, H>(dev, a)
                               : launch_ring<NL, H>(dev, a);
}

template <int NL>
cudaError_t launch(const Args& a, int h) {
  DeviceInfo dev;
  cudaError_t err = slice::device_info(&dev);
  if (err != cudaSuccess) return err;
  const int variant = slice::variant(dev, a.W, a.S_ext, h);
  if (variant == geo::GATHER) {
    const long long n = (long long)a.B * a.W;
    const long long blocks = (n + GATHER_THREADS - 1) / GATHER_THREADS;
    count_mask_gather<NL><<<(unsigned)blocks, GATHER_THREADS, 0, a.stream>>>(
        a.bits, a.W, a.loc, a.B, a.K, h, a.cthr, a.thr, a.counts, a.mask);
  } else {
    switch (h) {
      case 1: err = launch_h<NL, 1>(dev, variant, a); break;
      case 2: err = launch_h<NL, 2>(dev, variant, a); break;
      case 3: err = launch_h<NL, 3>(dev, variant, a); break;
      default: err = launch_h<NL, 4>(dev, variant, a);
    }
    if (err != cudaSuccess) return err;
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
  const Args a{(const uint32_t*)bits, W, S_ext, (const int32_t*)loc, B, K,
               (const int32_t*)cthr, (const int32_t*)thr, (int32_t*)counts,
               (uint32_t*)mask, (cudaStream_t)stream};
  cudaError_t err;
  switch (geo::counter_planes(K)) {  // counts <= K
    case 8: err = launch<8>(a, h); break;
    case 9: err = launch<9>(a, h); break;
    case 16: err = launch<16>(a, h); break;
    default: err = launch<32>(a, h);
  }
  return (int)err;
}

// The variant kmcp_count_mask runs at these shapes on the current device
// (geometry.cuh geo::Variant: 0 gather, 1 slice, 2 ring), or minus the
// CUDA error of the device query.
extern "C" int kmcp_count_mask_variant(int W, int S_ext, int h) {
  DeviceInfo dev;
  const cudaError_t err = slice::device_info(&dev);
  if (err != cudaSuccess) return -(int)err;
  return slice::variant(dev, W, S_ext, h);
}
