// K7' compact: the dense tail's compaction of K2''s mask into the (meta,
// aux) result layout (search/device_step.py, "Result layout").
//
// It replaces no Pallas kernel: the JAX package leaves the compaction to
// XLA (kmcp_tpu/search/device_step.py:97-137, _nonzero_asc and
// _compact_candidates: a cumsum over every mask lane and a binary search
// for each output slot), and the port first ran the same lowering as some
// forty PyTorch launches a batch, each writing a full-size temporary.
//
// For a read chunk of mask words int32 [B_c, W] (bit j of word w of row r:
// target 32 w + j), its counts int32 [B_c, 32 W] and the chunk's first flat
// id `off` (b0 * 32 W):
//   the set bits in ascending order of flat id, ranked after every set bit
//   of the batch's earlier chunks; a bit of rank r < budget writes
//   meta[1 + r] = off + 32 * word + j (the word's flat index in the chunk)
//   aux[r]      = counts[32 * word + j] clamped to 0..65535;
// and the batch's last chunk writes meta[0] = the exact total clamped to
// int32, the lanes past the total (meta: `fill`, aux: 0) and aux[budget +
// b] = nk[b] clamped to 0..65535.  The running total crosses chunks on the
// device (`carry`, int64 [2], read from one slot and written to the other
// by each chunk), so the total stays exact past the budget and the host
// never waits.
//
// What bounds it on an H100: the mask's bytes read once (5.24 MB for
// 16,384 reads of 80 words), meta and aux written once and the counts read
// at the emitted bits alone (at most `budget` 32-byte sectors): ~1.7 us at
// 3.35 TB/s for the benchmark's batch and 32,768 slots.  The design reads
// the mask twice, the second time from L2:
//
// - pass 1 (tile_counts): a CTA of 256 threads popcounts one tile of 4,096
//   words (16 KB), four coalesced 16-byte loads a thread, and writes the
//   tile's count: 320 tiles at the benchmark's batch;
// - pass 2 (emit): every CTA sums the tile counts before its tile (a few
//   hundred ints, from L2) and after it, so it knows its base rank and the
//   chunk's total; a CTA whose base is past the budget stops there.  Else
//   each thread takes 16 consecutive words (four 16-byte loads), ranks its
//   words by a block-wide exclusive scan of their popcounts and walks its
//   set bits lowest first (__ffs), writing each whose rank is below the
//   budget.  In the last chunk every CTA also writes its share of the
//   padding lanes and of nk, and CTA 0 writes meta[0]; CTA 0 of every
//   chunk writes the running total for the next.  A dense mask puts the
//   whole budget in the first tile or two, and one CTA then emits it all
//   (0.12 ms a batch at 21 bits a word; PERF.md §7).
//
// Two launches a chunk, and one chunk a batch at the benchmark's widths;
// no scratch but the tile counts and the carry, which the caller
// allocates.  Rows whose words are not 16-byte aligned (a chunk starting
// at an odd row of a narrow mask) take scalar loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WORDS_PER_THREAD = 16;
constexpr int TILE = THREADS * WORDS_PER_THREAD;  // words a CTA ranks
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Sum of v over the CTA, returned to every thread.
__device__ long long block_sum(long long v, long long* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long s = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) s += red[i];
  return s;
}

// Exclusive prefix sum of v over the CTA's threads in thread order.
__device__ int block_exclusive_scan(int v, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += sums[i];
  return before + inc - v;
}

__global__ void __launch_bounds__(THREADS)
tile_counts(const uint32_t* __restrict__ mask, long long n_words,
            int* __restrict__ tiles) {
  __shared__ long long red[WARPS];
  const long long t0 = (long long)blockIdx.x * TILE;
  int c = 0;
  if (t0 + TILE <= n_words && aligned16(mask)) {
    const uint4* p = reinterpret_cast<const uint4*>(mask + t0);
#pragma unroll
    for (int k = 0; k < WORDS_PER_THREAD / 4; ++k)
      c += popc4(p[k * THREADS + threadIdx.x]);
  } else {
    const long long end = min(t0 + TILE, n_words);
    for (long long i = t0 + threadIdx.x; i < end; i += THREADS)
      c += __popc(mask[i]);
  }
  const long long s = block_sum(c, red);
  if (threadIdx.x == 0) tiles[blockIdx.x] = (int)s;
}

struct EmitArgs {
  const uint32_t* mask;
  const int32_t* counts;
  long long n_words;
  const int* tiles;
  int n_tiles;
  long long off;
  const long long* carry_in;  // nullptr: the batch's first chunk
  long long* carry_out;
  int budget;
  int32_t* meta;
  int32_t* aux;
  // the batch's last chunk: nk int32 [B] and the padding id; else nk null
  const int32_t* nk;
  int B;
  int fill;
};

__global__ void __launch_bounds__(THREADS) emit(const EmitArgs a) {
  __shared__ long long red[WARPS];
  __shared__ int sums[WARPS];
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;

  // this tile's base rank in the chunk, and the chunk's total
  long long before = 0, all = 0;
  for (int i = tid; i < a.n_tiles; i += THREADS) {
    const int v = a.tiles[i];
    all += v;
    if (i < tile) before += v;
  }
  before = block_sum(before, red);
  all = block_sum(all, red);
  const long long carry = a.carry_in ? *a.carry_in : 0;
  const long long base = carry + before;
  const long long total = carry + all;
  if (blockIdx.x == 0 && tid == 0) *a.carry_out = total;

  const long long t0 = tile * TILE;
  if (base < a.budget && t0 < a.n_words) {  // uniform over the CTA
    const long long w0 = t0 + (long long)tid * WORDS_PER_THREAD;
    uint32_t w[WORDS_PER_THREAD];
    if (t0 + TILE <= a.n_words && aligned16(a.mask)) {
      const uint4* p = reinterpret_cast<const uint4*>(a.mask + w0);
#pragma unroll
      for (int k = 0; k < WORDS_PER_THREAD / 4; ++k) {
        const uint4 v = p[k];
        w[4 * k] = v.x;
        w[4 * k + 1] = v.y;
        w[4 * k + 2] = v.z;
        w[4 * k + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < WORDS_PER_THREAD; ++k)
        w[k] = w0 + k < a.n_words ? a.mask[w0 + k] : 0u;
    }
    int c = 0;
#pragma unroll
    for (int k = 0; k < WORDS_PER_THREAD; ++k) c += __popc(w[k]);
    long long r = base + block_exclusive_scan(c, sums);
    // unrolled, so that w stays in registers
#pragma unroll
    for (int k = 0; k < WORDS_PER_THREAD; ++k) {
      uint32_t x = w[k];
      while (x && r < a.budget) {
        const int j = __ffs(x) - 1;
        x &= x - 1;
        const long long flat = (w0 + k) * 32 + j;
        const int cnt = a.counts[flat];
        a.meta[1 + r] = (int32_t)(a.off + flat);
        a.aux[r] = min(max(cnt, 0), 65535);
        ++r;
      }
    }
  }

  if (a.nk == nullptr) return;
  // the last chunk: padding past the total, the k-mer counts, meta[0]
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + tid;
  for (long long l = min(total, (long long)a.budget) + first; l < a.budget;
       l += stride) {
    a.meta[1 + l] = a.fill;
    a.aux[l] = 0;
  }
  for (long long b = first; b < a.B; b += stride)
    a.aux[a.budget + b] = min(max(a.nk[b], 0), 65535);
  if (blockIdx.x == 0 && tid == 0)
    a.meta[0] = (int32_t)min(total, (long long)INT32_MAX);
}

}  // namespace

// One read chunk of the dense tail's compaction (see the top of this file):
// `tiles` int32 scratch of at least kmcp_compact_tiles(n_words) ints,
// `carry` int64 [2] (slot `parity` holds the running total before this
// chunk unless `first`; the other slot gets it after), `last` the batch's
// last chunk (then nk int32 [B] and the padding id `fill` are read).
// Returns the CUDA error of the launches (0 on success).
extern "C" int kmcp_compact(const void* mask, const void* counts,
                            long long n_words, long long off, void* tiles,
                            long long n_tiles, void* carry, int parity,
                            int first, int last, int budget, void* meta,
                            void* aux, const void* nk, int B, int fill,
                            void* stream) {
  const long long need = (n_words + TILE - 1) / TILE;
  if (n_words <= 0 || budget < 0 || n_tiles < need || need > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long* c = (long long*)carry;
  tile_counts<<<(unsigned)need, THREADS, 0, s>>>((const uint32_t*)mask,
                                                 n_words, (int*)tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  EmitArgs a{(const uint32_t*)mask, (const int32_t*)counts, n_words,
             (const int*)tiles, (int)need, off,
             first ? nullptr : c + (parity & 1), c + ((parity + 1) & 1),
             budget, (int32_t*)meta, (int32_t*)aux,
             last ? (const int32_t*)nk : nullptr, B, fill};
  long long grid = need;
  if (last) {  // enough threads for the padding and nk, 4 lanes a thread
    const long long lanes = (long long)budget + B;
    const long long pad = (lanes + 4LL * THREADS - 1) / (4LL * THREADS);
    if (pad > grid) grid = pad;
  }
  emit<<<(unsigned)grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Tile-count scratch ints kmcp_compact needs for n_words mask words.
extern "C" long long kmcp_compact_tiles(long long n_words) {
  return (n_words + TILE - 1) / TILE;
}
