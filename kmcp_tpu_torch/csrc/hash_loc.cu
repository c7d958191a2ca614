// K1' hash_loc: canonical ntHash1 of every read window -> Bloom row
// locations, per-read valid-window counts and, when asked, the union-screen
// plane and the 64-bit window values.
//
// Replaces the Pallas TPU kernel kmcp_tpu/search/pallas_hash.py:36
// make_pallas_hash_loc: its loc planes, nk, the screen plane of the two-pass
// screened search (h mod screen_sigs, :282-286) and the value planes of
// emit_values (:287-289, the dedup key of paired streaming), here one int64
// plane holding (hi << 32) | lo.  Its 2-/4-bit read packings exist for the
// TPU's host link and are not ported.
//
// What bounds it on an H100: at 16,384 reads of 160 bytes the launch moves
// 2.6 MB of reads and 9-40 MB of outputs, a few microseconds at 3.35 TB/s,
// and does about 2.3 M windows of 64-bit integer work.  Rolling one read
// base by base in one thread, as the TPU kernel rolls a lane, is a serial
// chain: 16k threads, each waiting on its own loads and 64-bit modulo.
//
// What the design does about it (nthash_window.cuh holds the arithmetic):
//   - a CTA stages the base codes of R reads in shared memory, read with
//     16-byte coalesced loads;
//   - threads map to (read, strip of windows): ns strips a read, ns a power
//     of two <= 32, so a read's strips are neighbouring lanes of one warp.
//     Each strip starts from state 0 and warms up over k - 1 bases, which
//     gives its first window's hash by the direct formula, then rolls; every
//     valid window equals the read's rolling hash (nthash_window.cuh says
//     why), and validity needs only the strip's own bases;
//   - moduli are exact and cheap: an AND for 2^N rows (the 2^25-row screen
//     plane), Barrett with a host-made reciprocal otherwise;
//   - outputs go to shared-memory tiles in the [B, K, h] layout and leave in
//     coalesced 16-byte stores (a CTA's reads are contiguous in every
//     plane); nk is a shuffle reduction over a read's lanes;
//   - the value plane costs nothing when it is off (a null pointer: no tile,
//     no store).
// Tiles that do not fit in shared memory (reads of thousands of bases) skip
// the staging: the same strips read the reads and write their outputs in
// device memory directly.
//
// Bit-exact contract (pallas_hash.py:226-290): bases fold to upper case with
// & 0xDF; h = unsigned min(fh, rh); a window is valid when its k bases are
// clean, h != 0 and h <= max_hash; h == 1 takes the full 64-bit h % S, h > 1
// takes uint32(hi + lo * j) % S; invalid windows point at the sentinel row
// S (the screen plane at screen_sigs) and have value 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "nthash_window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory
constexpr int kTableBytes = sizeof(nt::Tables);

struct SmemCodes {
  const uint8_t* p;
  __host__ __device__ int operator()(int i) const { return p[i]; }
};

struct RawCodes {
  const uint8_t* p;
  __host__ __device__ int operator()(int i) const {
    return nt::base_code(p[i]);
  }
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Shared-memory layout of a staged CTA of R reads: tables, then the value,
// location and screen tiles, then the base codes, each 16-byte aligned.
struct Layout {
  size_t vals, loc, locu, codes, total;
};

__host__ __device__ inline Layout layout(int R, int K, int h, int lmax,
                                         bool vals, bool locu) {
  Layout L;
  L.vals = align16(kTableBytes);
  L.loc = L.vals + (vals ? align16((size_t)R * K * 8) : 0);
  L.locu = L.loc + align16((size_t)R * K * h * 4);
  L.codes = L.locu + (locu ? align16((size_t)R * K * 4) : 0);
  L.total = L.codes + align16((size_t)R * lmax);
  return L;
}

// n elements of T from shared memory to device memory, coalesced, in
// 16-byte pieces when both ends allow it.
template <class T>
__device__ void copy_out(T* dst, const T* src, size_t n) {
  const bool vec = (((uintptr_t)dst | (uintptr_t)src) & 15) == 0 &&
                   (n * sizeof(T)) % 16 == 0;
  if (vec) {
    const size_t n4 = n * sizeof(T) / 16;
    for (size_t i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__device__ inline uint32_t codes4(uint32_t bytes) {
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out |= (uint32_t)nt::base_code((uint8_t)(bytes >> (8 * j))) << (8 * j);
  return out;
}

template <bool STAGE>
__global__ void __launch_bounds__(kThreads)
    hash_loc_kernel(const uint8_t* __restrict__ reads, int B, int lmax,
                    nt::Params P, nt::Tables tables, int ns, int ls, int R,
                    int32_t* __restrict__ loc, int32_t* __restrict__ locu,
                    int32_t* __restrict__ nk, int64_t* __restrict__ vals) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int K = lmax - P.k + 1, h = P.h;
  const int b0 = blockIdx.x * R;
  const int nr = min(R, B - b0);
  uint64_t(*tab_s)[5] = reinterpret_cast<uint64_t(*)[5]>(smem);
  for (int i = threadIdx.x; i < 20; i += blockDim.x)
    tab_s[i / 5][i % 5] = tables.t[i / 5][i % 5];
  const uint64_t(*tab)[5] = tab_s;
  const Layout L = layout(R, K, h, lmax, vals != nullptr, locu != nullptr);
  int64_t* vals_s = reinterpret_cast<int64_t*>(smem + L.vals);
  int32_t* loc_s = reinterpret_cast<int32_t*>(smem + L.loc);
  int32_t* locu_s = reinterpret_cast<int32_t*>(smem + L.locu);
  uint8_t* codes_s = smem + L.codes;
  if (STAGE) {  // the tile's reads are contiguous: nr * lmax bytes
    const uint8_t* src = reads + (size_t)b0 * lmax;
    const int n = nr * lmax;
    if ((((uintptr_t)src) & 15) == 0 && (n & 15) == 0) {
      for (int i = threadIdx.x; i < n / 16; i += blockDim.x) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
        reinterpret_cast<uint4*>(codes_s)[i] =
            make_uint4(codes4(v.x), codes4(v.y), codes4(v.z), codes4(v.w));
      }
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        codes_s[i] = (uint8_t)nt::base_code(src[i]);
    }
  }
  __syncthreads();

  const int r = threadIdx.x / ns, s = threadIdx.x % ns;
  const int w0 = s * ls, w1 = min(K, w0 + ls);
  int cnt = 0;
  if (r < nr && w0 < w1) {
    const size_t row = STAGE ? (size_t)r : (size_t)(b0 + r);
    int32_t* o_loc = (STAGE ? loc_s : loc) + row * K * h;
    int32_t* o_locu = locu ? (STAGE ? locu_s : locu) + row * K : nullptr;
    int64_t* o_vals = vals ? (STAGE ? vals_s : vals) + row * K : nullptr;
    if (STAGE)
      cnt = nt::nt_strip(SmemCodes{codes_s + (size_t)r * lmax}, w0, w1, tab, P,
                         o_loc, o_locu, o_vals);
    else
      cnt = nt::nt_strip(RawCodes{reads + (size_t)(b0 + r) * lmax}, w0, w1,
                         tab, P, o_loc, o_locu, o_vals);
  }
  // nk: a read's ns lanes are an aligned group of one warp
  for (int o = ns / 2; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if (s == 0 && r < nr) nk[b0 + r] = cnt;

  if (STAGE) {
    __syncthreads();
    copy_out(loc + (size_t)b0 * K * h, loc_s, (size_t)nr * K * h);
    if (locu) copy_out(locu + (size_t)b0 * K, locu_s, (size_t)nr * K);
    if (vals) copy_out(vals + (size_t)b0 * K, vals_s, (size_t)nr * K);
  }
}

}  // namespace

// reads uint8 [B, lmax] (zero padded ASCII); loc int32 [B, lmax-k+1, h];
// locu int32 [B, lmax-k+1] (the screen plane, h = 1) or null; nk int32 [B];
// vals int64 [B, lmax-k+1] (window values, 0 when invalid) or null.
// Returns cudaGetLastError() after the launch.
extern "C" int kmcp_hash_loc(const void* reads, int B, int lmax, int k,
                             long long num_sigs, unsigned long long max_hash,
                             int h, unsigned long long seed_a,
                             unsigned long long seed_c,
                             unsigned long long seed_g,
                             unsigned long long seed_t,
                             long long screen_sigs, void* loc, void* locu,
                             void* nk, void* vals, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const uint64_t seeds[4] = {seed_a, seed_c, seed_g, seed_t};
  nt::Params P;
  P.k = k;
  P.h = h;
  P.max_hash = max_hash;
  P.rows = nt::make_modulus((uint32_t)num_sigs);
  P.screen = nt::make_modulus((uint32_t)screen_sigs);
  const nt::Tables tables = nt::make_tables(seeds, k);
  const int K = lmax - k + 1;
  // strips of about 16 windows: ns a power of two in 1..32
  int ns = 1;
  while (ns < 32 && ns * 2 * 16 <= K) ns *= 2;
  const int ls = (K + ns - 1) / ns;
  int R = kThreads / ns;
  auto bytes = [&](int r) {
    return layout(r, K, h, lmax, vals != nullptr, locu != nullptr).total;
  };
  while (bytes(R) > (size_t)kMaxSmem && R * ns > 32) R /= 2;
  const bool stage = bytes(R) <= (size_t)kMaxSmem;
  if (!stage) R = kThreads / ns;
  const size_t smem = stage ? bytes(R) : align16(kTableBytes);
  const int grid = (B + R - 1) / R;
  cudaStream_t st = (cudaStream_t)stream;
  if (stage) {
    // raise the kernel's shared-memory cap once per device and size, so a
    // launch inside a CUDA graph capture makes no attribute call
    static size_t cap[64];
    if (smem > 48 * 1024) {
      int dev = 0;
      cudaGetDevice(&dev);
      const bool known = dev >= 0 && dev < 64;
      if (!known || smem > cap[dev]) {
        cudaFuncSetAttribute(hash_loc_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
        if (known) cap[dev] = smem;
      }
    }
    hash_loc_kernel<true><<<grid, R * ns, smem, st>>>(
        (const uint8_t*)reads, B, lmax, P, tables, ns, ls, R, (int32_t*)loc,
        (int32_t*)locu, (int32_t*)nk, (int64_t*)vals);
  } else {
    hash_loc_kernel<false><<<grid, R * ns, smem, st>>>(
        (const uint8_t*)reads, B, lmax, P, tables, ns, ls, R, (int32_t*)loc,
        (int32_t*)locu, (int32_t*)nk, (int64_t*)vals);
  }
  return (int)cudaGetLastError();
}
