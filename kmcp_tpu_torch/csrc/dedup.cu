// K8' dedup: paired streaming's in-step k-mer dedup (search/dedup.py,
// ``dedup_planes``) on the card.
//
// It replaces no Pallas kernel: the JAX package leaves the step to XLA
// (kmcp_tpu/search/device_step.py:458, _dedup_value_planes: ``lax.sort`` of
// every read's values, a duplicate mask, a gather of every location plane
// by the sort's order), and the port first ran the same lowering with
// ``torch.sort`` and ``torch.gather`` over every row, whatever its count.
//
// For a row r of the value plane vals [B, K] (64-bit; 0 marks an invalid
// window and is never a duplicate) whose raw count nk[r] exceeds
// `threshold`: each distinct non-zero value keeps its first window, the
// lowest index, and every later window of that value gets its plane's
// sentinel in each location plane ([B, K, h] int32, one sentinel for the
// plane or one per column); nk[r] loses the windows dropped.  A row at or
// under the threshold is left as it is.  The planes and nk are updated in
// place: the tail reads them once, and a candidate-overflow retry re-runs
// the whole search from K1', which writes them afresh
// (search/stream.py, ``rerun``).  The windows keep their order, so the
// result is the same from run to run and equals the plain version's
// (stable sort, first copy kept).
//
// What bounds it on an H100: each uniqued row's values read once (8 B a
// window), nk read and written and a sentinel written over each dropped
// window; the locations are never read.  For the benchmark's batch of
// 16,384 pairs of 300 windows: 39 MB, ~12 us at 3.35 TB/s.
//
// The design: one CTA of 128 threads a row (a grid-stride loop over rows,
// as many CTAs as fit on the card at once), which reads nk first and skips
// a row at or under the threshold.  Else it builds an open-addressing table
// keyed by the 64-bit value (at least 2 K slots, so at most half full;
// Fibonacci hashing, linear probing): atomicCAS claims a slot for a value,
// atomicMin keeps its lowest window, and each window notes its slot.  A
// second sweep reads each window's slot's kept window and writes the
// sentinels where it is another, and a block sum gives the row's drops.
// The table and the slots live in shared memory for K up to SHARED_K (13
// KB at K = 300); past it the same kernel keeps them in a global scratch
// buffer, one set a CTA, which the caller allocates (kmcp_dedup_scratch
// bytes).  With a tally pointer (tracing on) each CTA adds its rows and
// drops to it once.  On the H100 the benchmark's batch takes ~42 us: the
// rows' loads, clears and barriers alone take ~20 (chip_smoke.py phase
// 3; a second probe of each window's slot, a warp a row with
// __match_any_sync, 32-bit keys of a window index, smaller tables and 32
// to 256 threads a row measured no faster).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_PLANES = 2;
constexpr int MAX_SENT = 32;     // per-column sentinels a plane may give
constexpr int SHARED_K = 4096;   // the widest row whose table fits shared
constexpr int GLOBAL_CTAS = 256; // CTAs (tables) of the global-table route
constexpr unsigned long long EMPTY = 0;  // an empty slot; never a value

struct Plane {
  int32_t* loc;  // [B, K, h]
  int h;
  int n_sent;    // 1, or h: one sentinel a column
  int sent[MAX_SENT];
};

struct Args {
  const unsigned long long* vals;
  int32_t* nk;
  long long B;
  int K;
  int threshold;
  int n_planes;
  Plane plane[MAX_PLANES];
  int log2_slots;
  // the global route's tables and slots, [grid, slots] and [grid, K]
  unsigned long long* g_key;
  int* g_first;
  int* g_pos;
  unsigned long long* tally;  // [2]: rows uniqued, windows dropped; or null
};

__host__ __device__ __forceinline__ int log2_slots_for(int K) {
  int l = 1;
  while ((1 << l) < 2 * K) ++l;
  return l;
}

// Bytes of a row's table (a key and a kept window a slot) and of its
// windows' slots.
__host__ __device__ __forceinline__ long long row_bytes(int log2_slots,
                                                       int K) {
  return (1LL << log2_slots) * (long long)(sizeof(unsigned long long) +
                                          sizeof(int)) +
         (long long)sizeof(int) * K;
}

__device__ __forceinline__ unsigned slot_of(unsigned long long v, int l) {
  return (unsigned)((v * 0x9E3779B97F4A7C15ull) >> (64 - l));
}

// A global table's slots are written by atomics in L2: read them past L1.
template <bool SHARED, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (SHARED) return *p;
  else return __ldcg(p);
}

// Sum of v over the CTA, returned to every thread; its first barrier also
// ends every thread's use of the table.
__device__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) s += red[i];
  return s;
}

template <bool SHARED>
__global__ void __launch_bounds__(THREADS) dedup_rows(const Args a) {
  extern __shared__ unsigned long long smem[];
  __shared__ int red[WARPS];
  const int tid = threadIdx.x;
  const int l = a.log2_slots;
  const unsigned slots = 1u << l, wrap = slots - 1;
  unsigned long long* key =
      SHARED ? smem : a.g_key + (size_t)blockIdx.x * slots;
  int* first = SHARED ? reinterpret_cast<int*>(smem + slots)
                      : a.g_first + (size_t)blockIdx.x * slots;
  int* pos = SHARED ? first + slots : a.g_pos + (size_t)blockIdx.x * a.K;
  long long rows = 0, dropped_all = 0;
  for (long long row = blockIdx.x; row < a.B; row += gridDim.x) {
    const int n = a.nk[row];
    if (n <= a.threshold) continue;  // uniform over the CTA
    for (unsigned s = tid; s < slots; s += THREADS) {
      key[s] = EMPTY;
      first[s] = INT_MAX;
    }
    __syncthreads();
    const unsigned long long* v = a.vals + row * a.K;
    for (int i = tid; i < a.K; i += THREADS) {
      const unsigned long long x = v[i];
      int at = -1;
      if (x != EMPTY) {
        for (unsigned s = slot_of(x, l);; s = (s + 1) & wrap) {
          const unsigned long long old = atomicCAS(key + s, EMPTY, x);
          if (old == EMPTY || old == x) {
            atomicMin(first + s, i);
            at = (int)s;
            break;
          }
        }
      }
      pos[i] = at;
    }
    __syncthreads();
    int dropped = 0;
    for (int i = tid; i < a.K; i += THREADS) {
      const int s = pos[i];
      if (s < 0 || load<SHARED>(first + s) == i) continue;
      ++dropped;
      const long long w = row * a.K + i;
      for (int p = 0; p < a.n_planes; ++p) {
        const Plane& pl = a.plane[p];
        for (int c = 0; c < pl.h; ++c)
          pl.loc[w * pl.h + c] = pl.sent[pl.n_sent == 1 ? 0 : c];
      }
    }
    const int total = block_sum(dropped, red);
    if (tid == 0) a.nk[row] = n - total;
    ++rows;
    dropped_all += total;
  }
  if (a.tally != nullptr && tid == 0 && rows > 0) {
    atomicAdd(a.tally, (unsigned long long)rows);
    atomicAdd(a.tally + 1, (unsigned long long)dropped_all);
  }
}

}  // namespace

// Bytes of global scratch kmcp_dedup needs for B rows of K windows: 0
// while a row's table fits shared memory (K <= SHARED_K).
extern "C" long long kmcp_dedup_scratch(long long B, int K) {
  if (K <= SHARED_K || B <= 0) return 0;
  return (B < GLOBAL_CTAS ? B : GLOBAL_CTAS) * row_bytes(log2_slots_for(K), K);
}

// The dedup of rows over `threshold` (see the top of this file): vals
// int64 [B, K], nk int32 [B] and n_planes (1 or 2) location planes int32
// [B, K, h_p] updated in place, each plane's sentinels a host array of
// n_sent_p (1 or h_p) ints; `scratch` of kmcp_dedup_scratch(B, K) bytes;
// `tally` an int64 [2] on the card, or null.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int kmcp_dedup(const void* vals, void* nk, long long B, int K,
                          int threshold, int n_planes, void* loc0, int h0,
                          const int* sent0, int n_sent0, void* loc1, int h1,
                          const int* sent1, int n_sent1, void* scratch,
                          long long scratch_bytes, void* tally,
                          void* stream) {
  if (B < 0 || K < 0 || n_planes < 1 || n_planes > MAX_PLANES)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0) return 0;
  if (K > (1 << 29)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.vals = (const unsigned long long*)vals;
  a.nk = (int32_t*)nk;
  a.B = B;
  a.K = K;
  a.threshold = threshold;
  a.n_planes = n_planes;
  void* locs[MAX_PLANES] = {loc0, loc1};
  const int hs[MAX_PLANES] = {h0, h1};
  const int* sents[MAX_PLANES] = {sent0, sent1};
  const int n_sents[MAX_PLANES] = {n_sent0, n_sent1};
  for (int p = 0; p < n_planes; ++p) {
    Plane& pl = a.plane[p];
    if (hs[p] < 1 || n_sents[p] < 1 || n_sents[p] > MAX_SENT ||
        (n_sents[p] != 1 && n_sents[p] != hs[p]))
      return (int)cudaErrorInvalidValue;
    pl.loc = (int32_t*)locs[p];
    pl.h = hs[p];
    pl.n_sent = n_sents[p];
    for (int c = 0; c < n_sents[p]; ++c) pl.sent[c] = sents[p][c];
  }
  a.log2_slots = log2_slots_for(K);
  a.tally = (unsigned long long*)tally;
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= SHARED_K) {
    const int smem = (int)row_bytes(a.log2_slots, K);
    cudaError_t err = cudaFuncSetAttribute(
        dedup_rows<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dedup_rows<true>, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const long long grid = B < fit ? B : fit;
    dedup_rows<true><<<(unsigned)grid, THREADS, smem, s>>>(a);
  } else {
    const long long grid = B < GLOBAL_CTAS ? B : GLOBAL_CTAS;
    const long long slots = 1LL << a.log2_slots;
    if (scratch == nullptr ||
        scratch_bytes < grid * row_bytes(a.log2_slots, K))
      return (int)cudaErrorInvalidValue;
    a.g_key = (unsigned long long*)scratch;
    a.g_first = (int*)(a.g_key + grid * slots);
    a.g_pos = a.g_first + grid * slots;
    dedup_rows<false><<<(unsigned)grid, THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
