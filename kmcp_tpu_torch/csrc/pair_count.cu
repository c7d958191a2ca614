// K5' pair_count: pass 2 of the two-pass screened search, one (read, block)
// pair at a time: gather the read's K Bloom rows from the pair's block,
// positional popcount, fused threshold mask.
//
// Replaces the Pallas TPU kernel kmcp_tpu/search/pallas_count.py:
// make_pallas_pair_count.  On the TPU the pairs arrive sorted by block so
// that one block's slab (s_block rows of 512 bytes) stays in VMEM while its
// pairs are folded.  Here the row-stacked matrix stays in device memory and
// L2 serves the gathers, so pairs come in any order (the caller passes them
// read-major) and row p of the outputs is pair p: no sort, no restore.
//
// For pair p = (read b = pb[p], block g = pg[p]) and 32-target word w:
//   row(i)           = loc[b, i] + g * s_block, or the global sentinel row
//                      nb * s_block when loc[b, i] == s_block
//   counts[p, 32w+j] = sum_{i<K} bit_j(bits[row(i), w])
//   mask[p, w] bit j = counts[p, 32w+j] >= max(thr[g, 32w+j], cthr[b])
//
// What bounds it on an H100: the gather, as in K2'.  Every (pair, word)
// thread loads K words of 4 bytes from rows chosen by the hash: P * K * W * 4
// bytes in all (2.9 GB for 20k pairs of 140 windows at W = 128), from a
// block slab of about 1.8 MB that L2 (50 MB) holds while its pairs run; the
// counts output (P * 32 W * 4 bytes) is the other large stream.
//
// What the design does about it: K2''s layout.  One thread per (pair,
// word), neighbouring threads on neighbouring words of the same row, so a
// warp reads whole 128-byte lines at W = 128 and spans several pairs on
// narrow blocks (W = 1, 2), so no thread idles.  The locations are read
// straight from device memory (every thread of a pair loads the same
// address, which the cache broadcasts).  The bit-sliced counter of
// bitslice.cuh keeps the 32 counts in registers.  Whether sorting pairs by
// block keeps L2 hotter is left to measurement.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitslice.cuh"

namespace {

__global__ void pair_count_kernel(const uint32_t* __restrict__ bits, int W,
                                  int s_block, long long sentinel_row,
                                  const int32_t* __restrict__ loc, int K,
                                  const int32_t* __restrict__ pb,
                                  const int32_t* __restrict__ pg, int P,
                                  const int32_t* __restrict__ cthr,
                                  const int32_t* __restrict__ thr,
                                  int32_t* __restrict__ counts,
                                  uint32_t* __restrict__ mask, int nlev) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)P * W) return;
  const int p = (int)(g / W);
  const int w = (int)(g % W);
  const int b = pb[p];
  const int blk = pg[p];
  const int32_t* lb = loc + (size_t)b * K;
  const uint32_t* slab = bits + (size_t)blk * s_block * W + w;
  const uint32_t* sentinel = bits + (size_t)sentinel_row * W + w;

  uint32_t c[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) c[l] = 0;

  for (int i = 0; i < K; ++i) {
    const int l = lb[i];
    const uint32_t* r = l == s_block ? sentinel : slab + (size_t)l * W;
    bitslice_add(c, __ldg(r));
  }

  mask[g] = bitslice_store(c, nlev, thr + ((size_t)blk * W + w) * 32, cthr[b],
                           counts + (size_t)g * 32);
}

}  // namespace

// bits int32/uint32 [nb * s_block + 1, W] (row nb * s_block all zero); loc
// int32 [B, K] (rows in the block modulus, sentinel s_block); pb, pg int32
// [P]; cthr int32 [B]; thr int32 [nb, 32 W]; counts int32 [P, 32 W]; mask
// int32/uint32 [P, W].  Returns cudaGetLastError() after the launch.
extern "C" int kmcp_pair_count(const void* bits, int W, int n_blocks,
                               int s_block, const void* loc, int K,
                               const void* pb, const void* pg, int P,
                               const void* cthr, const void* thr,
                               void* counts, void* mask, void* stream) {
  const int nlev = bitslice_levels(K);  // counts <= K
  const int threads = 256;
  const long long n = (long long)P * W;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    pair_count_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)bits, W, s_block, (long long)n_blocks * s_block,
        (const int32_t*)loc, K, (const int32_t*)pb, (const int32_t*)pg, P,
        (const int32_t*)cthr, (const int32_t*)thr, (int32_t*)counts,
        (uint32_t*)mask, nlev);
  }
  return (int)cudaGetLastError();
}
