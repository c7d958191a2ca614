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
// What the design does about it: block-stationary, on K2''s slice counter
// (slice.cuh).  The wrapper sorts the pairs by block on the device (a
// stable sort of pg: `order`, and each block's range `seg`); CTA (x, g, z)
// copies word tile x (8 words) of block g's s_block rows plus the sentinel
// row into shared memory once (115 KB at 3,578 rows, 16-byte cp.async), so
// a block's slab leaves device memory once per tile, and counts the z-th
// share of g's pairs in rounds of 128 pairs x 8 words: locations staged
// double-buffered, eight windows per carry-save add, the byte-plane
// epilogue with fused floors (8 planes single-end, 9 for paired rows up to
// K = 511), and 512-byte warp stores to each pair's own row p, so
// read-major order needs no restoring.  Blocks narrower than one
// tile (W < 8) or too tall for shared memory (over 4,053 rows on an H100's
// 227 KB: slice.cuh slice_smem) take the gather variant: a
// thread per (pair, word) in the given order, eight loads in flight into
// the same carry-save counter, 16-byte count stores.

#include <cstdint>
#include <cuda_runtime.h>

#include "slice.cuh"

namespace {

using slice::SLICE_THREADS;
using slice::WT;

constexpr int GATHER_THREADS = 128;

// CTA (x, g, z): word tile x of block g, pairs order[lo .. hi) with lo, hi
// the z-th of `splits` shares (whole rounds of 128) of g's range seg[g] ..
// seg[g + 1].
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
  const int lo0 = __ldg(seg + g), hi0 = __ldg(seg + g + 1);
  const int share = ((hi0 - lo0 + splits - 1) / splits + slice::SLICE_READS -
                     1) / slice::SLICE_READS * slice::SLICE_READS;
  const int lo = lo0 + blockIdx.z * share;
  const int hi = min(hi0, lo + share);
  if (lo >= hi) return;
  slice::slice_count<NL, 1>(
      bits + (size_t)g * s_block * W, s_block,
      bits + (size_t)n_blocks * s_block * W, W, blockIdx.x * WT, loc, K, cthr,
      thr + (size_t)g * 32 * W, counts, mask, lo, hi,
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

template <int NL>
cudaError_t launch(const uint32_t* bits, int W, int n_blocks, int s_block,
                   const int32_t* loc, int K, const int32_t* pb,
                   const int32_t* pg, int P, const int32_t* order,
                   const int32_t* seg, const int32_t* cthr,
                   const int32_t* thr, int32_t* counts, uint32_t* mask,
                   cudaStream_t stream) {
  DeviceInfo dev;
  cudaError_t err = slice::device_info(&dev);
  if (err != cudaSuccess) return err;
  if (slice::use_slice(dev, W, s_block + 1, 1)) {
    const size_t smem = slice::slice_smem(s_block + 1, 1);
    err = cudaFuncSetAttribute(pair_count_slice<NL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    // one CTA per (tile, block) when that fills the card twice over (512
    // at 32 blocks of 16 tiles, 2,048 at 128); else each block's pairs
    // are split so that it does, as if they were spread evenly
    const int tiles = (W + WT - 1) / WT;
    const long long cells = (long long)tiles * n_blocks;
    const long long fill = (2LL * dev.sms + cells - 1) / cells;
    const long long rounds =
        (P / n_blocks + slice::SLICE_READS - 1) / slice::SLICE_READS;
    const int splits = (int)(fill < rounds ? fill : rounds > 1 ? rounds : 1);
    const dim3 grid(tiles, n_blocks, splits);
    pair_count_slice<NL><<<grid, SLICE_THREADS, smem, stream>>>(
        bits, W, s_block, n_blocks, loc, K, pb, order, seg, splits, cthr, thr,
        counts, mask);
  } else {
    const long long n = (long long)P * W;
    const long long blocks = (n + GATHER_THREADS - 1) / GATHER_THREADS;
    pair_count_gather<NL><<<(unsigned)blocks, GATHER_THREADS, 0, stream>>>(
        bits, W, s_block, n_blocks, loc, K, pb, pg, P, cthr, thr, counts,
        mask);
  }
  return cudaGetLastError();
}

}  // namespace

// bits int32/uint32 [nb * s_block + 1, W] (row nb * s_block all zero); loc
// int32 [B, K] (rows in the block modulus, sentinel s_block); pb, pg int32
// [P] (pg == nb marks a padding pair: no variant reads a row for it, and
// its counts row is not written); order int32 [P] (the pairs sorted by
// block, stably, padding last) and seg int32 [nb + 1] (block g's pairs are
// order[seg[g] .. seg[g+1]]), read only by the slice variant
// (kmcp_pair_count_variant == 1); cthr int32 [B]; thr int32 [nb, 32 W];
// counts int32 [P, 32 W] (16-byte aligned); mask int32/uint32 [P, W],
// zeroed by the caller (the slice variant writes the rows of real pairs
// only).  Returns the CUDA error of the launch.
extern "C" int kmcp_pair_count(const void* bits, int W, int n_blocks,
                               int s_block, const void* loc, int K,
                               const void* pb, const void* pg, int P,
                               const void* order, const void* seg,
                               const void* cthr, const void* thr,
                               void* counts, void* mask, void* stream) {
  if (P <= 0 || W <= 0) return 0;
  const int nlev = bitslice_levels(K);  // counts <= K
  const auto* b = (const uint32_t*)bits;
  const auto* l = (const int32_t*)loc;
  const auto* b_ = (const int32_t*)pb;
  const auto* g_ = (const int32_t*)pg;
  const auto* o = (const int32_t*)order;
  const auto* sg = (const int32_t*)seg;
  const auto* ct = (const int32_t*)cthr;
  const auto* t = (const int32_t*)thr;
  auto* c = (int32_t*)counts;
  auto* m = (uint32_t*)mask;
  const auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (nlev <= 8)
    err = launch<8>(b, W, n_blocks, s_block, l, K, b_, g_, P, o, sg, ct, t,
                    c, m, s);
  else if (nlev == 9)
    err = launch<9>(b, W, n_blocks, s_block, l, K, b_, g_, P, o, sg, ct, t,
                    c, m, s);
  else if (nlev <= 16)
    err = launch<16>(b, W, n_blocks, s_block, l, K, b_, g_, P, o, sg, ct, t,
                     c, m, s);
  else
    err = launch<32>(b, W, n_blocks, s_block, l, K, b_, g_, P, o, sg, ct, t,
                     c, m, s);
  return (int)err;
}

// The variant kmcp_pair_count runs at these shapes on the current device:
// 1 slice (needs order and seg), 0 gather, or minus the CUDA error of the
// device query.
extern "C" int kmcp_pair_count_variant(int W, int s_block) {
  DeviceInfo dev;
  const cudaError_t err = slice::device_info(&dev);
  if (err != cudaSuccess) return -(int)err;
  return slice::use_slice(dev, W, s_block + 1, 1) ? 1 : 0;
}
