// K5' pair_count: pass 2 of the two-pass screened search: for each (read,
// block) pair, gather the read's K Bloom rows from the pair's block,
// positional popcount, fused threshold mask.
//
// Replaces the Pallas TPU kernel kmcp_tpu/search/pallas_count.py:
// make_pallas_pair_count, which keeps one block's slab in VMEM while the
// pairs of that block, sorted by block, are folded against it.
//
// For pair p = (read b = pb[p], block g = pg[p]) and 32-target word w:
//   row(i)           = loc[b, i] + g * s_block, or the global sentinel row
//                      nb * s_block when loc[b, i] == s_block
//   counts[p, 32w+j] = sum_{i<K} bit_j(bits[row(i), w])
//   mask[p, w] bit j = counts[p, 32w+j] >= max(thr[g, 32w+j], cthr[b])
//
// What bounds it on an H100.  Counted once, the bytes are the blocks' rows
// the pairs touch, the locations, and the counts (4 B per (pair, target)):
// at 32 blocks of 3,578 rows x 128 words and 20,480 pairs, about 0.4 GB,
// 0.12 ms.  Gathered word by word the pairs read P * K * W * 4 bytes (1.5
// GB there) from rows the hash picks, and pairs in read order stream every
// block's slab through L2 in no order.
//
// What the design does about it: block-stationary, on K2''s counters
// (slice.cuh).  The wrapper sorts the pairs by block on the device (a
// stable sort of pg: `order`, and each block's range `seg`).  Where one
// tile of every row of a block fits in shared memory (slice: 8 words, up
// to 5,077 rows), CTA (x, g, z) copies word tile x of block g's s_block
// rows plus the sentinel row into shared memory once (16-byte cp.async,
// 160 KB at 5,077 rows), so a block's slab
// leaves device memory once per tile, and counts the z-th share of g's
// pairs in rounds: locations staged double-buffered, eight windows per
// carry-save add, the byte-plane epilogue with fused floors (8 planes
// single-end, 9 for paired rows up to K = 511), and 512-byte warp stores
// to each pair's own row p, so read-major order needs no restoring.
// Taller blocks (the rows of a real KMCP DB: about 2^20 at GTDB scale and
// -f 0.3) take the row ring: CTA (x, g, z) streams the rows its share of
// g's pairs hit, each warp 32 words of one pair at a time through its own
// cp.async ring in shared memory, into the same counter and epilogue.  Blocks narrower than one
// tile (W < 8) take the gather variant: a thread per (pair, word) in the
// given order, eight loads in flight into the same carry-save counter,
// 16-byte count stores.

#include <cstdint>
#include <cuda_runtime.h>

#include "slice.cuh"

namespace {

using slice::SLICE_THREADS;
using slice::WT;

constexpr int GATHER_THREADS = 128;

// Pairs order[lo .. hi) of CTA (x, g, z): the z-th of `splits` shares
// (whole rounds of `round` pairs) of block g's range seg[g] .. seg[g + 1].
struct Share {
  int lo, hi;
};
__device__ __forceinline__ Share block_share(const int32_t* __restrict__ seg,
                                             int g, int splits, int round) {
  const int lo0 = __ldg(seg + g), hi0 = __ldg(seg + g + 1);
  const int share =
      ((hi0 - lo0 + splits - 1) / splits + round - 1) / round * round;
  const int lo = lo0 + blockIdx.z * share;
  return {lo, min(hi0, lo + share)};
}

// The slice variant: CTA (x, g, z) counts word tile x of block g for its
// share of g's pairs.
template <int NL>
__global__ void __launch_bounds__(SLICE_THREADS)
pair_count_slice(const uint32_t* __restrict__ bits, int W, int s_block,
                 int n_blocks, const int32_t* __restrict__ loc, int K,
                 const int32_t* __restrict__ pb,
                 const int32_t* __restrict__ order,
                 const int32_t* __restrict__ seg, int splits,
                 const int32_t* __restrict__ cthr,
                 const int32_t* __restrict__ thr,
                 int32_t* __restrict__ counts, uint32_t* __restrict__ mask) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int g = blockIdx.y;
  const Share sh = block_share(seg, g, splits, slice::SLICE_READS);
  if (sh.lo >= sh.hi) return;
  slice::slice_count<NL, 1>(
      bits + (size_t)g * s_block * W, s_block,
      bits + (size_t)n_blocks * s_block * W, W, blockIdx.x * WT, loc, K,
      cthr, thr + (size_t)g * 32 * W, counts, mask, sh.lo, sh.hi,
      slice::PairRows{order, pb}, smem);
}

// The ring variant: CTA (x, g, z) streams words x * span .. of block g's
// rows for its share of g's pairs.
template <int NL>
__global__ void __launch_bounds__(geo::RING_THREADS, NL <= 9 ? 2 : 1)
pair_count_ring(const uint32_t* __restrict__ bits, int W, int s_block,
                int n_blocks, const int32_t* __restrict__ loc, int K,
                const int32_t* __restrict__ pb,
                const int32_t* __restrict__ order,
                const int32_t* __restrict__ seg, int splits, int span,
                const int32_t* __restrict__ cthr,
                const int32_t* __restrict__ thr,
                int32_t* __restrict__ counts, uint32_t* __restrict__ mask) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int g = blockIdx.y;
  const Share sh = block_share(seg, g, splits, geo::ring_reads(span));
  if (sh.lo >= sh.hi) return;
  slice::ring_count<NL, 1>(
      bits + (size_t)g * s_block * W, s_block,
      bits + (size_t)n_blocks * s_block * W, W, blockIdx.x * span, span, loc,
      K, cthr, thr + (size_t)g * 32 * W, counts, mask, sh.lo, sh.hi,
      slice::PairRows{order, pb}, smem);
}

// A padding pair (block n_blocks) gathers no row and writes a zero mask word.
template <int NL>
__global__ void __launch_bounds__(GATHER_THREADS)
pair_count_gather(const uint32_t* __restrict__ bits, int W, int s_block,
                  int n_blocks, const int32_t* __restrict__ loc,
                  int K, const int32_t* __restrict__ pb,
                  const int32_t* __restrict__ pg, int P,
                  const int32_t* __restrict__ cthr,
                  const int32_t* __restrict__ thr,
                  int32_t* __restrict__ counts, uint32_t* __restrict__ mask) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)P * W) return;
  const int p = (int)(g / W);
  const int w = (int)(g % W);
  const int b = __ldg(pb + p);
  const int blk = __ldg(pg + p);
  if (blk >= n_blocks) {
    mask[g] = 0;
    return;
  }
  const int32_t* lb = loc + (size_t)b * K;
  const uint32_t* slab = bits + (size_t)blk * s_block * W + w;
  const uint32_t* sentinel = bits + (size_t)n_blocks * s_block * W + w;

  CsaCounter<NL> acc;
  acc.init();
  int i = 0;
  for (; i + 8 <= K; i += 8) {
    int l[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) l[u] = __ldg(lb + i + u);
    uint32_t d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      d[u] = __ldg(l[u] == s_block ? sentinel : slab + (size_t)l[u] * W);
    acc.add8(d);
  }
  for (; i < K; ++i) {
    const int l = __ldg(lb + i);
    acc.add1(__ldg(l == s_block ? sentinel : slab + (size_t)l * W));
  }
  acc.finish();
  mask[g] = bitslice_store16(acc.c, thr + ((size_t)blk * W + w) * 32,
                             __ldg(cthr + b), counts + (size_t)g * 32);
}

using slice::DeviceInfo;

struct Args {
  const uint32_t* bits;
  int W, n_blocks, s_block;
  const int32_t* loc;
  int K;
  const int32_t *pb, *pg;
  int P;
  const int32_t *order, *seg, *cthr, *thr;
  int32_t* counts;
  uint32_t* mask;
  cudaStream_t stream;
};

// Shares of each block's pairs: one CTA per (span, block) when that fills
// the card `fill` times over; else each block's pairs are split so that it
// does, as if they were spread evenly, in whole rounds of `round` pairs.
int splits_for(const DeviceInfo& dev, const Args& a, int tiles, int fill,
               int round) {
  const long long cells = (long long)tiles * a.n_blocks;
  const long long want = (fill * (long long)dev.sms + cells - 1) / cells;
  const long long rounds = (a.P / a.n_blocks + round - 1) / round;
  return (int)(want < rounds ? want : rounds > 1 ? rounds : 1);
}

template <int NL>
cudaError_t launch_slice(const DeviceInfo& dev, const Args& a) {
  const size_t smem = geo::slice_smem(a.s_block + 1, 1);
  const cudaError_t err =
      cudaFuncSetAttribute(pair_count_slice<NL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return err;
  // twice over (512 CTAs at 32 blocks of 16 tiles, 2,048 at 128)
  const int tiles = (a.W + WT - 1) / WT;
  const int splits = splits_for(dev, a, tiles, 2, slice::SLICE_READS);
  const dim3 grid(tiles, a.n_blocks, splits);
  pair_count_slice<NL><<<grid, SLICE_THREADS, smem, a.stream>>>(
      a.bits, a.W, a.s_block, a.n_blocks, a.loc, a.K, a.pb, a.order, a.seg,
      splits, a.cthr, a.thr, a.counts, a.mask);
  return cudaSuccess;
}

template <int NL>
cudaError_t launch_ring(const DeviceInfo& dev, const Args& a) {
  const int span = geo::ring_span(a.W);
  const size_t smem = geo::ring_smem(span, 1);
  const cudaError_t err =
      cudaFuncSetAttribute(pair_count_ring<NL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return err;
  // about 8 CTAs an SM over the launch, as K2''s ring
  const int tiles = (a.W + span - 1) / span;
  const int splits = splits_for(dev, a, tiles, 8, geo::ring_reads(span));
  const dim3 grid(tiles, a.n_blocks, splits);
  pair_count_ring<NL><<<grid, geo::RING_THREADS, smem, a.stream>>>(
      a.bits, a.W, a.s_block, a.n_blocks, a.loc, a.K, a.pb, a.order, a.seg,
      splits, span, a.cthr, a.thr, a.counts, a.mask);
  return cudaSuccess;
}

template <int NL>
cudaError_t launch(const Args& a) {
  DeviceInfo dev;
  cudaError_t err = slice::device_info(&dev);
  if (err != cudaSuccess) return err;
  switch (slice::variant(dev, a.W, a.s_block + 1, 1)) {
    case geo::GATHER: {
      const long long n = (long long)a.P * a.W;
      const long long blocks = (n + GATHER_THREADS - 1) / GATHER_THREADS;
      pair_count_gather<NL><<<(unsigned)blocks, GATHER_THREADS, 0,
                              a.stream>>>(
          a.bits, a.W, a.s_block, a.n_blocks, a.loc, a.K, a.pb, a.pg, a.P,
          a.cthr, a.thr, a.counts, a.mask);
      break;
    }
    case geo::SLICE: err = launch_slice<NL>(dev, a); break;
    default: err = launch_ring<NL>(dev, a);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// bits int32/uint32 [nb * s_block + 1, W] (row nb * s_block all zero); loc
// int32 [B, K] (rows in the block modulus, sentinel s_block); pb, pg int32
// [P] (pg == nb marks a padding pair: no variant reads a row for it, and
// its counts row is not written); order int32 [P] (the pairs sorted by
// block, stably, padding last) and seg int32 [nb + 1] (block g's pairs are
// order[seg[g] .. seg[g+1]]), read by every variant but the gather
// (kmcp_pair_count_variant > 0); cthr int32 [B]; thr int32 [nb, 32 W];
// counts int32 [P, 32 W] (16-byte aligned); mask int32/uint32 [P, W],
// zeroed by the caller (the slice and ring variants write the rows of real
// pairs only).  Returns the CUDA error of the launch.
extern "C" int kmcp_pair_count(const void* bits, int W, int n_blocks,
                               int s_block, const void* loc, int K,
                               const void* pb, const void* pg, int P,
                               const void* order, const void* seg,
                               const void* cthr, const void* thr,
                               void* counts, void* mask, void* stream) {
  if (P <= 0 || W <= 0) return 0;
  const Args a{(const uint32_t*)bits, W, n_blocks, s_block,
               (const int32_t*)loc, K, (const int32_t*)pb, (const int32_t*)pg,
               P, (const int32_t*)order, (const int32_t*)seg,
               (const int32_t*)cthr, (const int32_t*)thr, (int32_t*)counts,
               (uint32_t*)mask, (cudaStream_t)stream};
  cudaError_t err;
  switch (geo::counter_planes(K)) {  // counts <= K
    case 8: err = launch<8>(a); break;
    case 9: err = launch<9>(a); break;
    case 16: err = launch<16>(a); break;
    default: err = launch<32>(a);
  }
  return (int)err;
}

// The variant kmcp_pair_count runs at these shapes on the current device
// (geometry.cuh geo::Variant; every one but the gather needs order and
// seg), or minus the CUDA error of the device query.
extern "C" int kmcp_pair_count_variant(int W, int s_block) {
  DeviceInfo dev;
  const cudaError_t err = slice::device_info(&dev);
  if (err != cudaSuccess) return -(int)err;
  return slice::variant(dev, W, s_block + 1, 1);
}
