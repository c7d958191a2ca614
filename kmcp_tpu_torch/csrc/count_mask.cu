// K2' count_mask: Bloom-row gather + row-AND + positional popcount + fused
// threshold mask.
//
// Replaces the Pallas TPU kernels kmcp_tpu/search/pallas_count.py:
// make_pallas_count (DMA-ring, masked=), make_pallas_count_resident and
// make_pallas_count_masked.  Those three differ only in where the TPU keeps
// the bit matrix (HBM ring, VMEM slabs, VMEM with mask); here the matrix
// stays in device memory and L2 serves the gathers, so one kernel covers
// all three and every row width (the TPU's W % 1024 tiling gate does not
// exist here).  Targets stay in natural order t = 32 w + j: the TPU's
// bit-major lane layout is not ported.
//
// For read b and 32-target word w:
//   counts[b, 32w + j] = sum_{i<K} bit_j( AND_{jj<h} bits[loc[b, i, jj], w] )
//   mask[b, w] bit j   = counts[b, 32w + j] >= max(thr[32w + j], cthr[b])
//
// What bounds it on an H100: the gather.  Every (read, word) thread loads
// K * h words of 4 bytes from rows chosen by the hash, about B * K * h * W
// * 4 bytes in all (35 GB for 16k reads at 131k targets), which L2 and
// device memory serve; the per-plane arithmetic is a few integer ops.  The
// counts output is the other large stream (4 bytes per (read, target)).
//
// What the design does about it: one thread per (read, word), with
// neighbouring threads on neighbouring words of the same gathered row, so a
// warp reads whole 128-byte lines on wide rows; on narrow rows (W = 5) a
// warp spans several reads, so no thread idles.  Each read's locations are
// read straight from device memory: every thread of a read loads the same
// address, which the cache broadcasts, so there is no shared-memory staging
// and no limit on K.  The positional popcount is a bit-sliced vertical
// counter in registers (bitslice.cuh, shared with K5' pair_count.cu) and
// unpacks once per thread at the end.  The caller bounds device memory
// by launching on read chunks whose counts stay near 1 GB (counts for a
// whole 16k-read batch at 131k targets would be 8.6 GB).

#include <cstdint>
#include <cuda_runtime.h>

#include "bitslice.cuh"

namespace {

__global__ void count_mask_kernel(const uint32_t* __restrict__ bits, int W,
                                  const int32_t* __restrict__ loc, int B,
                                  int K, int h,
                                  const int32_t* __restrict__ cthr,
                                  const int32_t* __restrict__ thr,
                                  int32_t* __restrict__ counts,
                                  uint32_t* __restrict__ mask, int nlev) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)B * W) return;
  const int b = (int)(g / W);
  const int w = (int)(g % W);
  const int32_t* lb = loc + (size_t)b * K * h;

  uint32_t c[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) c[l] = 0;

  for (int i = 0; i < K; ++i) {
    const int32_t* li = lb + (size_t)i * h;
    uint32_t x = __ldg(bits + (size_t)li[0] * W + w);
    for (int jj = 1; jj < h; ++jj) x &= __ldg(bits + (size_t)li[jj] * W + w);
    bitslice_add(c, x);
  }

  const uint32_t m = bitslice_store(c, nlev, thr + (size_t)w * 32, cthr[b],
                                    counts + (size_t)g * 32);
  mask[g] = m;
}

}  // namespace

// bits int32/uint32 [S_ext, W] (row S_ext-1 all zero); loc int32 [B, K, h];
// cthr int32 [B]; thr int32 [32 W]; counts int32 [B, 32 W]; mask int32/uint32
// [B, W].  Returns cudaGetLastError() after the launch.
extern "C" int kmcp_count_mask(const void* bits, int W, const void* loc, int B,
                               int K, int h, const void* cthr, const void* thr,
                               void* counts, void* mask, void* stream) {
  const int nlev = bitslice_levels(K);  // counts <= K
  const int threads = 256;
  const long long n = (long long)B * W;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    count_mask_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)bits, W, (const int32_t*)loc, B, K, h,
        (const int32_t*)cthr, (const int32_t*)thr, (int32_t*)counts,
        (uint32_t*)mask, nlev);
  }
  return (int)cudaGetLastError();
}
