// K6' group_count: pass 2 of the two-pass screened search as a grouped GEMM
// on the tensor cores.
//
// Replaces the Pallas TPU kernel kmcp_tpu/search/pallas_count.py:
// make_pallas_group_count.  The count contraction is
//   counts[p, t] = sum_s U[p, s] * bits01[blk(p), s, t]
// with U[p, s] the number of the pair's read windows that hash to Bloom row
// s of the block (sentinel windows land on a row whose bits are zero) and
// bits01 the block's Bloom bits unpacked to 0/1 bytes.  Pairs arrive sorted
// by block and padded per block to whole tiles of 64 pairs, so every tile
// reads one block, whose id is blk[tile]; a tile with blk == nb writes zeros.
//
// Exact by construction: bf16 holds every integer up to 256 (the caller
// allows this route only when the k-mer dedup threshold, hence every real
// row's multiplicity, is at most 256; sentinel multiplicities may round but
// multiply a zero row), the 0/1 bits are exact, and the f32 accumulators
// hold integers exactly below 2^24 (a count is at most K).
//
// What bounds it on an H100: tensor-core issue and the operand loads.  A
// pair costs 2 * S_pad * 32 W flops (1.1 TFLOP for 37k pairs at S_pad =
// 3,584 and 4,096 targets per block), against 989 TFLOP/s of dense bf16;
// this simple kernel uses warp-level mma.sync through nvcuda::wmma, not
// wgmma, and stages operands through shared memory with plain loads, so it
// runs well below that.  The operands: U is read once per target tile (P *
// S_pad * 2 bytes each time) and the int8 slab once per pair tile.
//
// What the design does about it: one CUDA block of 4 warps owns a 64-pair x
// 64-target output tile and walks S in steps of 32: it loads the U tile
// (bf16, 16-byte vector loads) and the slab tile (int8, 4-byte loads,
// widened to bf16 in shared memory), and each warp runs 2 x 2 wmma
// 16x16x16 products per 16-deep slice into f32 fragments.  The epilogue
// goes through shared memory and converts to int32.  Ragged edges (a block
// narrower than 64 targets, S_pad not a multiple of 32) are masked with
// zero fill.  wgmma, TMA and a pipelined ring of tiles are for a later
// change.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int PT = 64;  // pairs per tile (the caller pads block groups to it)
constexpr int BN = 64;  // targets per tile
constexpr int BK = 32;  // Bloom rows per step
constexpr int LDA = BK + 8;  // bf16 pitches: multiples of 8, rows 16-byte aligned
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // f32 pitch: a multiple of 4
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    group_count_kernel(const int8_t* __restrict__ bits01, int n_blocks,
                       int S_pad, int T, const __nv_bfloat16* __restrict__ u,
                       const int32_t* __restrict__ blk,
                       int32_t* __restrict__ counts) {
  __shared__ __align__(32) __nv_bfloat16 As[PT * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(32) float Cs[PT * LDC];

  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int g = blk[tile];
  const size_t row0 = (size_t)tile * PT;

  if (g < 0 || g >= n_blocks) {  // an all-padding tile
    for (int e = tid; e < PT * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      if (n0 + c < T) counts[(row0 + r) * T + n0 + c] = 0;
    }
    return;
  }

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // this warp's 32 x 32 quarter
  const int wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const __nv_bfloat16* ut = u + row0 * S_pad;
  const int8_t* slab = bits01 + (size_t)g * S_pad * T;
  const bool vec_a = S_pad % 8 == 0;  // 16-byte aligned U rows

  for (int k0 = 0; k0 < S_pad; k0 += BK) {
    // U tile [PT, BK]: 8 bf16 per load, 4 loads per row
    for (int e = tid; e < PT * (BK / 8); e += THREADS) {
      const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
      __nv_bfloat16* dst = As + r * LDA + c;
      const __nv_bfloat16* src = ut + (size_t)r * S_pad + k0 + c;
      if (vec_a && k0 + c + 8 <= S_pad) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int q = 0; q < 8; ++q)
          dst[q] = k0 + c + q < S_pad ? src[q] : __float2bfloat16(0.0f);
      }
    }
    // slab tile [BK, BN]: 4 int8 per load (T is a multiple of 32), widened
    for (int e = tid; e < BK * (BN / 4); e += THREADS) {
      const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
      __nv_bfloat16* dst = Bs + r * LDB + c;
      if (k0 + r < S_pad && n0 + c < T) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(
            slab + (size_t)(k0 + r) * T + n0 + c);
        for (int q = 0; q < 4; ++q)
          dst[q] = __float2bfloat16((float)(int8_t)(v >> (8 * q)));
      } else {
        for (int q = 0; q < 4; ++q) dst[q] = __float2bfloat16(0.0f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < PT * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    if (n0 + c < T) counts[(row0 + r) * T + n0 + c] = (int32_t)Cs[r * LDC + c];
  }
}

}  // namespace

// bits01 int8 [nb, S_pad, T] (0/1; T a multiple of 32); u bf16 [P_pad,
// S_pad]; blk int32 [P_pad / 64]; counts int32 [P_pad, T].  Returns
// cudaGetLastError() after the launch.
extern "C" int kmcp_group_count(const void* bits01, int n_blocks, int S_pad,
                                int T, const void* u, const void* blk,
                                int n_tiles, void* counts, void* stream) {
  const dim3 grid(n_tiles, (T + BN - 1) / BN);
  if (n_tiles > 0) {
    group_count_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)bits01, n_blocks, S_pad, T,
        (const __nv_bfloat16*)u, (const int32_t*)blk, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}
