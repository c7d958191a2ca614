// K6' group_count: pass 2 of the two-pass screened search as a grouped GEMM
// on Hopper's tensor cores (wgmma), with the row-multiplicity matrix U built
// on chip from the locations and the floors fused.
//
// Replaces the Pallas TPU kernel kmcp_tpu/search/pallas_count.py:
// make_pallas_group_count.  For pair p = (read b = pb[p], block g = pg[p]):
//   counts[p, t] = sum_s U[p, s] * bits01[g, s, t]
//   mask[p, w] bit j = counts[p, 32w+j] >= max(thr[g, 32w+j], cthr[b])
// with U[p, s] the number of the read's windows that hash to Bloom row s of
// the block (sentinel windows, loc == s_block, multiply a zero row and are
// skipped) and bits01 the block's bits as 0/1.
//
// Exact by construction, in integers: the product is u8 x u8 -> s32 on the
// tensor cores.  A sweep adds at most 255 windows of a pair, so every U
// value fits u8; the bits are 0/1; the s32 sums are exact.  Reads with more
// windows take several sweeps over S into the same accumulators.
//
// What bounds it on an H100: tensor-core operations.  The dense product is
// 2 * P * S_pad * T operations (0.60 T at 32 blocks of 4,096 targets,
// S_pad = 3,584 and 20,480 pairs: 0.30 ms at 1,979 TOP/s of dense int8,
// 0.61 ms in bf16), against 0.47 GB of u8 slabs read once.
//
// What the design does about it:
// - wgmma m64n256k32 u8 -> s32 (twice bf16's rate, half its slab bytes),
//   A from registers, B from shared memory; a CTA owns 64 x NWG pairs (one
//   consumer warpgroup of accumulators per 64) x 256 targets, and walks S in
//   k-steps of 128 Bloom rows (one 128-byte swizzle row of u8).
// - B, the slabs: u8, pre-tiled by gemm_slabs as [nb, T/256, S/128, 256,
//   128] in the 128-byte-swizzled K-major layout wgmma reads, so one TMA
//   bulk copy (cp.async.bulk, 32 KB) per k-step lands a tile ready for the
//   tensor cores, into a ring of STAGES buffers guarded by mbarriers, fed by
//   one thread of the producer warpgroup.
// - A, the U tile, is never materialised, in device memory or in shared
//   memory.  Per sweep the consumers bucket the tile's pairs' windows in
//   shared memory by (pair, k-step, owning lane) with a counting sort
//   (coalesced loads, 32 in flight a thread, shared atomics); each
//   k-step every thread adds its own windows of its two rows straight into
//   the u8 lanes of its wgmma A registers, for the next k-step while the
//   tensor cores run this one.  The buckets take 16 bytes a (pair,
//   k-step): a block too tall for all of them at once (on an H100, over
//   4,992 rows at 140 windows a read, 4,096 at 255) is swept in chunks of
//   the k-steps that fit, each chunk bucketing only the windows whose rows
//   it holds.  (A first design built bf16 A tiles in shared memory with
//   atomics, fed B as bf16 and spent most of its time there: PERF.md.)
// - Raster: one grid row of (T/256/ntc) x (pair tiles) CTAs (a 2-D grid
//   would cap the pair tiles at 65,535), target tiles fastest, pair tiles
//   of a block adjacent (the wrapper sorts pairs by block), so the CTAs in
//   flight share one or two blocks' slabs and L2 serves the re-reads; a CTA
//   runs ntc target tiles with one staging of the windows.
// - Epilogue: the accumulators are the int32 counts, stored at the row of
//   the pair's own index p (read-major; padding rows write nothing), and the
//   floors are compared in registers, mask words OR-reduced across the quad
//   of lanes that shares a row.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "slice.cuh"

namespace {

constexpr int BN = 256;        // targets per CTA tile (wgmma N)
constexpr int BK = 128;        // Bloom rows per k-step (128 bytes of u8)
constexpr int WC_MAX = 255;    // windows of a pair per sweep (u8 exact)
constexpr int PRODUCER = 128;  // threads of the producer warpgroup
constexpr int B_BYTES = BN * BK;
constexpr int ILP = 32;        // window loads in flight per consumer thread
// Consumer warpgroups a CTA, so pair tiles of 64 x PAIR_WARPGROUPS: 128-pair
// tiles ran about 1.5x faster than 64-pair ones at the main path's shapes
// (tools/group_count_probe.py builds the other; PERF.md).
constexpr int PAIR_WARPGROUPS = 2;
constexpr int STAGES = 4;  // slab tiles in flight in the B ring

template <int NWG>
struct Cfg {
  static constexpr int BM = 64 * NWG;  // pairs per CTA tile
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + PRODUCER;
};

// Row pitch of the sorted window lists (u8 columns).
__host__ __device__ constexpr int list_pitch(int wc) {
  return (wc + 15) / 16 * 16;
}

// Dynamic shared memory: the B ring (1024-byte aligned for the swizzle), its
// barriers, the list ends per (pair, k-step of a chunk, lane of the quad),
// the tile's pairs' rows and the sorted lists, plus alignment slack.
size_t smem_bytes(int bm, int wc, int n_kc) {
  return 1024 + (size_t)STAGES * B_BYTES + STAGES * 16 +
         (size_t)bm * n_kc * 4 * 4 + (size_t)bm * 4 +
         (size_t)bm * list_pitch(wc);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// TMA bulk copy global -> shared, completing `bytes` on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Barrier 1 among the consumer warpgroups' threads only.
template <int N>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// wgmma operand descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle: leading offset 16 B, 8-row groups 1,024 B apart.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return ((uint64_t)(smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void pin(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 32] * B[32 x 256]: A u8 in registers (this
// thread's fragment a[0..3]), B u8 K-major in shared memory.
__device__ __forceinline__ void wgmma_u8(int (&d)[128], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// This thread's A fragment of k-step kt of the chunk: a[4 k + 2 h + rs]
// holds rows r0 (rs 0) and r0 + 8 (rs 1), columns 32 k + 16 h + 4 q +
// (0..3) of the k-step, one u8 count a byte.  The windows of (k-step kt,
// lane q) of row r are list[r][ends[r][kt][q] - count .. ends[r][kt][q]),
// the buckets of a row in (k-step, lane) order, so each starts where the
// one before ended; a row's ends are n_kc k-steps apart.
__device__ __forceinline__ void build_a(uint32_t (&a)[16], int kt,
                                        const uint8_t* list, const int* ends,
                                        int r0, int q, int n_kc, int lp) {
#pragma unroll
  for (int x = 0; x < 16; ++x) a[x] = 0;
#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    const int r = r0 + 8 * rs;
    const int* er = ends + (r * n_kc + kt) * 4 + q;
    int e = kt || q ? er[-1] : 0;
    const int z = er[0];
    const uint8_t* lr = list + r * lp;
    for (; e < z; ++e) {
      const int col = lr[e];
      const uint32_t inc = 1u << (8 * (col & 3));
      const int sel = (col >> 5) * 2 + ((col >> 4) & 1);
#pragma unroll
      for (int x = 0; x < 8; ++x)
        a[(x >> 1) * 4 + (x & 1) * 2 + rs] += sel == x ? inc : 0u;
    }
  }
}

// One k-step of a consumer warpgroup, k-step kt of a chunk of nks: its
// products on stage it % STAGES with fragment a, then (the previous
// k-step's products done) that stage released and the next k-step's
// fragment built into an.
__device__ __forceinline__ void mma_step(int (&d)[128],
                                         const uint32_t (&a)[16],
                                         uint32_t (&an)[16], int kt, int nks,
                                         int it, const uint8_t* Bs,
                                         uint64_t* full, uint64_t* empty,
                                         const uint8_t* list, const int* ends,
                                         int r0, int q, int n_kc, int lp) {
  const int s = it % STAGES;
  mbar_wait(&full[s], (it / STAGES) & 1);
  const uint8_t* b = Bs + s * B_BYTES;
  pin(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < BK / 32; ++k)
    wgmma_u8(d, a + 4 * k, desc_sw128(b + k * 32));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  pin(d);
  if (kt > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  if (kt + 1 < nks) build_a(an, kt + 1, list, ends, r0, q, n_kc, lp);
}

// Pair tile y -> its block g (n_blocks past the last tile) and the position
// in order of its first pair: block g's tiles follow those of the blocks
// before it, ceil(count / bm) of them.  Every thread scans the block counts
// 32 at a time with warp shuffles (seg is a few hundred bytes, in L1).
__device__ __forceinline__ void tile_of(int y, int bm,
                                        const int32_t* __restrict__ seg,
                                        int n_blocks, int* g, int* first) {
  const int lane = threadIdx.x & 31;
  int run = 0;  // tiles of the blocks before this round of 32
  *g = n_blocks;
  *first = 0;
  for (int g0 = 0; g0 < n_blocks; g0 += 32) {
    const int gg = g0 + lane;
    const int lo = gg < n_blocks ? __ldg(seg + gg) : 0;
    const int n = gg < n_blocks ? (__ldg(seg + gg + 1) - lo + bm - 1) / bm : 0;
    int x = n;  // inclusive scan of the tile counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += v;
    }
    const int start = run + x - n;
    const unsigned hit =
        __ballot_sync(0xffffffffu, y >= start && y < start + n);
    if (hit) {
      const int src = __ffs(hit) - 1;
      *g = g0 + src;
      *first = __shfl_sync(0xffffffffu, lo + (y - start) * bm, src);
      return;
    }
    run += __shfl_sync(0xffffffffu, x, 31);
  }
}

// CTA x + nx * y: target tiles x * ntc .. x * ntc + ntc - 1 of pair tile
// y, one after another.  Each block's pairs, order[seg[g] .. seg[g+1]), fill
// whole pair tiles of BM in block order; the grid has a bound of the tile
// count, and the CTAs past the last tile return.  Per target tile the
// windows go in sweeps of wc_max, and each sweep's k-steps in chunks of
// n_kc (the order the producer loads the slab tiles in either way).
template <int NWG>
__global__ void __launch_bounds__(Cfg<NWG>::THREADS, 1)
group_count_kernel(const uint8_t* __restrict__ slabs, int n_blocks, int NT,
                   int ntc, int n_k, int n_kc, int T, int s_block,
                   const int32_t* __restrict__ loc, int K, int wc_max,
                   const int32_t* __restrict__ pb,
                   const int32_t* __restrict__ order,
                   const int32_t* __restrict__ seg,
                   const int32_t* __restrict__ cthr,
                   const int32_t* __restrict__ thr,
                   int32_t* __restrict__ counts, uint32_t* __restrict__ mask) {
  using C = Cfg<NWG>;
  constexpr int BM = C::BM;
  int g, first;
  const int nx = (NT + ntc - 1) / ntc;
  tile_of(blockIdx.x / nx, BM, seg, n_blocks, &g, &first);
  if (g >= n_blocks) return;  // past the last tile
  const int nr = min(BM, __ldg(seg + g + 1) - first);
  const int nt0 = blockIdx.x % nx * ntc;
  const int n_nt = min(ntc, NT - nt0);
  const int n_sweeps = (K + wc_max - 1) / wc_max;
  // bucketings of a target tile: one per (sweep, chunk of S)
  const int n_buckets = n_sweeps * ((n_k + n_kc - 1) / n_kc);
  const int LP = list_pitch(wc_max);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Bs = smem;  // [STAGES][256][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;
  int* ends = reinterpret_cast<int*>(empty + STAGES);  // [BM][n_kc][4]
  int* srow = ends + BM * n_kc * 4;                     // [BM]
  uint8_t* list = reinterpret_cast<uint8_t*>(srow + BM);  // [BM][LP]

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::CONSUMERS) {
    // ---- producer: one thread keeps the B ring full ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == C::CONSUMERS) {
      int it = 0;
      for (int i = 0; i < n_nt; ++i) {
        const uint8_t* slab =
            slabs + ((size_t)g * NT + nt0 + i) * n_k * B_BYTES;
        for (int c = 0; c < n_sweeps; ++c) {
          for (int kt = 0; kt < n_k; ++kt, ++it) {
            const int s = it % STAGES;
            mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            mbar_arrive_tx(&full[s], B_BYTES);
            bulk_load(Bs + s * B_BYTES, slab + (size_t)kt * B_BYTES, B_BYTES,
                      &full[s]);
          }
        }
      }
    }
  } else {
    // ---- consumers: stage and sort the windows, then wgmma over the ring
    // with A built in registers, then the fused epilogue ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid / 128;
    const int lane = tid & 31, q = lane & 3;
    // this thread's rows (local pair indices) of the wgmma fragments
    const int r0 = wg * 64 + (tid & 127) / 32 * 16 + lane / 4;
    const int W = T / 32;
    for (int r = tid; r < BM; r += C::CONSUMERS)
      srow[r] = r < nr ? __ldg(pb + __ldg(order + first + r)) : 0;
    int p0 = -1, p1 = -1, f0 = INT_MAX, f1 = INT_MAX;
    if (r0 < nr) {
      p0 = __ldg(order + first + r0);
      f0 = __ldg(cthr + __ldg(pb + p0));
    }
    if (r0 + 8 < nr) {
      p1 = __ldg(order + first + r0 + 8);
      f1 = __ldg(cthr + __ldg(pb + p1));
    }
    const int32_t* tg = thr + (size_t)g * T;
    int d[128];
    int it = 0;
    for (int i = 0; i < n_nt; ++i) {
#pragma unroll
      for (int e = 0; e < 128; ++e) d[e] = 0;
      for (int c = 0; c < n_sweeps; ++c) {
        const int i0 = c * wc_max;
        const int wc = min(wc_max, K - i0);
        for (int k0 = 0; k0 < n_k; k0 += n_kc) {
          // this chunk: k-steps k0 .. k0 + nks - 1, rows lo .. lo + span-1
          const int nks = min(n_kc, n_k - k0);
          const unsigned lo = k0 * BK, span = nks * BK;
          if (i == 0 || n_buckets > 1) {
            // bucket the sweep's windows of each pair in the chunk's rows
            // by (k-step, owning lane): counts (shared atomics), each row's
            // exclusive scan, then the entries (the window's column in its
            // k-step); the windows are read twice, coalesced, ILP loads in
            // flight a thread
            consumer_sync<C::CONSUMERS>();  // the previous lists are done
            for (int e = tid; e < BM * n_kc * 4; e += C::CONSUMERS)
              ends[e] = 0;
            consumer_sync<C::CONSUMERS>();
            const int nwin = nr * wc;
            for (int pass = 0; pass < 2; ++pass) {
              for (int e0 = tid; e0 < nwin; e0 += ILP * C::CONSUMERS) {
                int l[ILP];
#pragma unroll
                for (int u = 0; u < ILP; ++u) {
                  const int e = e0 + u * C::CONSUMERS;
                  l[u] = s_block;
                  if (e < nwin) {
                    const int r = e / wc;
                    l[u] =
                        __ldg(loc + (size_t)srow[r] * K + i0 + e - r * wc);
                  }
                }
#pragma unroll
                for (int u = 0; u < ILP; ++u) {
                  const unsigned rel = (unsigned)l[u] - lo;  // chunk's row
                  if (l[u] == s_block || rel >= span) continue;
                  const int r = (e0 + u * C::CONSUMERS) / wc;
                  int* x = ends + (r * n_kc + (int)(rel >> 7)) * 4 +
                           (int)((rel & 15) >> 2);
                  if (pass == 0)
                    atomicAdd(x, 1);
                  else
                    list[r * LP + atomicAdd(x, 1)] = (uint8_t)(rel & 127);
                }
              }
              consumer_sync<C::CONSUMERS>();
              if (pass == 0) {
                if (tid < nr) {  // counts -> starts of row tid's buckets
                  int4* er = reinterpret_cast<int4*>(ends + tid * n_kc * 4);
                  int run = 0;
                  for (int kt = 0; kt < nks; ++kt) {
                    int4 v = er[kt];
                    const int4 c = v;
                    v.x = run;
                    v.y = run += c.x;
                    v.z = run += c.y;
                    v.w = run += c.z;
                    run += c.w;
                    er[kt] = v;
                  }
                }
                consumer_sync<C::CONSUMERS>();
              }
            }
          }
          // k-steps in pairs, A fragments double-buffered: the next
          // k-step's fragment is built while this one's products run
          uint32_t a0[16], a1[16];
          build_a(a0, 0, list, ends, r0, q, n_kc, LP);
          for (int kt = 0; kt < nks; kt += 2) {
            mma_step(d, a0, a1, kt, nks, it++, Bs, full, empty, list, ends,
                     r0, q, n_kc, LP);
            if (kt + 1 < nks)
              mma_step(d, a1, a0, kt + 1, nks, it++, Bs, full, empty, list,
                       ends, r0, q, n_kc, LP);
          }
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          pin(d);
          mbar_arrive(&empty[(it - 1) % STAGES]);
        }
      }

      // d[4j + e]: row r0 (+ 8 for e >= 2), target n0 + 8 j + 2 q + (e & 1)
      const int n0 = (nt0 + i) * BN;
      uint32_t m0[8], m1[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) m0[w] = m1[w] = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = n0 + 8 * j + 2 * q;
        int t0 = INT_MAX, t1 = INT_MAX;  // no bit past the last target
        if (col < T) {
          t0 = __ldg(tg + col);
          t1 = __ldg(tg + col + 1);
        }
        const int sh = 8 * (j & 3) + 2 * q;
        m0[j >> 2] |= (uint32_t)(d[4 * j] >= max(t0, f0)) << sh |
                      (uint32_t)(d[4 * j + 1] >= max(t1, f0)) << (sh + 1);
        m1[j >> 2] |= (uint32_t)(d[4 * j + 2] >= max(t0, f1)) << sh |
                      (uint32_t)(d[4 * j + 3] >= max(t1, f1)) << (sh + 1);
        if (col < T) {
          if (p0 >= 0)
            *reinterpret_cast<int2*>(counts + (size_t)p0 * T + col) =
                make_int2(d[4 * j], d[4 * j + 1]);
          if (p1 >= 0)
            *reinterpret_cast<int2*>(counts + (size_t)p1 * T + col) =
                make_int2(d[4 * j + 2], d[4 * j + 3]);
        }
      }
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        uint32_t x = m0[w], y = m1[w];
        x |= __shfl_xor_sync(0xffffffffu, x, 1);
        x |= __shfl_xor_sync(0xffffffffu, x, 2);
        y |= __shfl_xor_sync(0xffffffffu, y, 1);
        y |= __shfl_xor_sync(0xffffffffu, y, 2);
        const int word = n0 / 32 + w;
        if ((w & 3) == q && word < W) {
          if (p0 >= 0) mask[(size_t)p0 * W + word] = x;
          if (p1 >= 0) mask[(size_t)p1 * W + word] = y;
        }
      }
    }
  }
}

template <int NWG>
cudaError_t launch(const uint8_t* slabs, int n_blocks, int NT, int n_k,
                   int T, int s_block, const int32_t* loc, int K,
                   const int32_t* pb, const int32_t* order,
                   const int32_t* seg, int n_tiles,
                   const int32_t* cthr, const int32_t* thr, int32_t* counts,
                   uint32_t* mask, cudaStream_t stream) {
  using C = Cfg<NWG>;
  slice::DeviceInfo dev;
  cudaError_t err = slice::device_info(&dev);
  if (err != cudaSuccess) return err;
  // windows per sweep: all of a read's up to the 255 that u8 holds; k-steps
  // per chunk of S: all of them when their buckets fit in shared memory
  const int wc = max(1, min(K, WC_MAX));
  const size_t fixed = smem_bytes(C::BM, wc, 0);
  const size_t per_k = smem_bytes(C::BM, wc, 1) - fixed;
  if (fixed + per_k > (size_t)dev.smem_optin) return cudaErrorInvalidValue;
  const int n_kc =
      (int)std::min<size_t>(n_k, ((size_t)dev.smem_optin - fixed) / per_k);
  const size_t smem = smem_bytes(C::BM, wc, n_kc);
  err = cudaFuncSetAttribute(group_count_kernel<NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  // target tiles per CTA: as many as keep two CTAs per SM in the grid
  // (the pair tiles counted by their bound), so that a pair tile's windows
  // are bucketed once for several target tiles
  int ntc = 1;
  while (ntc < 8 && ntc < NT &&
         (long long)n_tiles * ((NT + 2 * ntc - 1) / (2 * ntc)) >= 2LL * dev.sms)
    ntc *= 2;
  const long long ctas = (long long)((NT + ntc - 1) / ntc) * n_tiles;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  group_count_kernel<NWG><<<(unsigned)ctas, C::THREADS, smem, stream>>>(
      slabs, n_blocks, NT, ntc, n_k, n_kc, T, s_block, loc, K, wc, pb, order,
      seg, cthr, thr, counts, mask);
  return cudaGetLastError();
}

}  // namespace

// slabs u8 [nb, NT, n_k, 256, 128] (gemm_slabs: 0/1, swizzled K-major
// tiles; NT = ceil(T / 256)); loc int32 [B, K] (rows in the block modulus,
// sentinel s_block); pb int32 [P]; order int32 [P] and seg int32
// [nb + 1] (the pairs sorted by block, block g's at order[seg[g] ..
// seg[g+1]]; padding pairs, of block nb, sort past seg[nb] and fall in no
// tile, so their rows are not written); n_tiles a bound of the pair tiles
// (P / 128 + min(nb, P) for the tiles of 128 pairs); cthr int32 [B]; thr
// int32 [nb, T]; counts int32 [P, T]; mask int32/uint32 [P, T / 32].
// Returns the CUDA error of the launch.
extern "C" int kmcp_group_count(const void* slabs, int n_blocks, int NT,
                                int n_k, int T, int s_block, const void* loc,
                                int K, const void* pb, const void* order,
                                const void* seg, int n_tiles,
                                const void* cthr, const void* thr,
                                void* counts, void* mask, void* stream) {
  if (n_tiles <= 0 || T <= 0) return 0;
  const auto* sl = (const uint8_t*)slabs;
  const auto* l = (const int32_t*)loc;
  const auto* b = (const int32_t*)pb;
  const auto* o = (const int32_t*)order;
  const auto* sg = (const int32_t*)seg;
  const auto* ct = (const int32_t*)cthr;
  const auto* t = (const int32_t*)thr;
  auto* c = (int32_t*)counts;
  auto* m = (uint32_t*)mask;
  const auto s = (cudaStream_t)stream;
  return (int)launch<PAIR_WARPGROUPS>(sl, n_blocks, NT, n_k, T, s_block, l,
                                      K, b, o, sg, n_tiles, ct, t, c, m, s);
}
