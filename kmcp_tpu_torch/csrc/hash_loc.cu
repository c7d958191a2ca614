// K1' hash_loc: rolling canonical ntHash1 -> Bloom row locations.
//
// Replaces the Pallas TPU kernel kmcp_tpu/search/pallas_hash.py:
// make_pallas_hash_loc (the loc planes, nk and, for one hash, the screen
// plane of the two-pass screened search; the value planes and the 2-/4-bit
// read packings are not ported).
//
// What bounds it on an H100: latency of one sequential dependency chain per
// read.  Each thread walks its read base by base (rol/ror/xor on 64-bit
// state, a 64-bit modulo per window), so a 16k-read batch is only 16k
// threads; the card's integer throughput is far from the limit.  The reads
// are loaded with a stride of lmax bytes between neighbouring threads and
// the [B, K, h] locations are stored with a stride of K*h ints, so neither
// access is coalesced: staging read tiles through shared memory is a later
// optimisation.
//
// What the design does about it: the rolling state is native uint64_t (the
// TPU kernel emulates it with uint32 hi/lo pairs and three modulus
// lowerings, pallas_hash.py:134-195); small blocks of 64 threads spread the
// reads over every SM.
//
// Bit-exact contract (pallas_hash.py:226-290): use_out = i >= k && run > k;
// the state resets to 0 after an invalid base; bases fold to upper case
// with & 0xDF; h = unsigned min(fh, rh); a window is valid when run >= k,
// h != 0 and h <= max_hash; h == 1 takes the full 64-bit h % S, h > 1 takes
// uint32(hi + lo * j) % S; invalid windows point at the sentinel row S.
// The screen plane (h = 1 only, pallas_hash.py:282-286) is the full 64-bit
// h % screen_sigs of the same window, with sentinel screen_sigs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Seeds {
  uint64_t a, c, g, t;
};

__device__ __forceinline__ uint64_t rol64(uint64_t x, int r) {
  r &= 63;
  return r ? (x << r) | (x >> (64 - r)) : x;
}

__device__ __forceinline__ uint64_t ror64(uint64_t x, int r) {
  return rol64(x, (64 - (r & 63)) & 63);
}

// Forward and complement seed of one ASCII base; false for a non-ACGT byte.
__device__ __forceinline__ bool seed_of(uint8_t byte, const Seeds& s,
                                        uint64_t* fwd, uint64_t* comp) {
  switch (byte & 0xDF) {
    case 'A': *fwd = s.a; *comp = s.t; return true;
    case 'C': *fwd = s.c; *comp = s.g; return true;
    case 'G': *fwd = s.g; *comp = s.c; return true;
    case 'T': *fwd = s.t; *comp = s.a; return true;
    default: *fwd = 0; *comp = 0; return false;
  }
}

__global__ void hash_loc_kernel(const uint8_t* __restrict__ reads, int B,
                                int lmax, int k, uint32_t num_sigs,
                                uint64_t max_hash, int h, Seeds seeds,
                                uint32_t screen_sigs,
                                int32_t* __restrict__ loc,
                                int32_t* __restrict__ locu,
                                int32_t* __restrict__ nk) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* r = reads + (size_t)b * lmax;
  const int K = lmax - k + 1;
  int32_t* out = loc + (size_t)b * K * h;
  int32_t* outu = locu ? locu + (size_t)b * K : nullptr;
  const int32_t sentinel = (int32_t)num_sigs;
  uint64_t fh = 0, rh = 0;
  int run = 0, count = 0;
  for (int i = 0; i < lmax; ++i) {
    uint64_t s_in, sc_in;
    const bool ok = seed_of(r[i], seeds, &s_in, &sc_in);
    run = ok ? run + 1 : 0;
    // the previous window was complete: roll the out-base off
    const bool use_out = i >= k && run > k;
    uint64_t s_out = 0, sc_out = 0;
    if (use_out) seed_of(r[i - k], seeds, &s_out, &sc_out);
    fh = rol64(fh, 1) ^ (use_out ? rol64(s_out, k) : 0) ^ s_in;
    rh = ror64(rh, 1) ^ (use_out ? ror64(sc_out, 1) : 0) ^ rol64(sc_in, k - 1);
    if (!ok) {
      fh = 0;
      rh = 0;
    }
    if (i < k - 1) continue;  // no full window yet
    const uint64_t hv = rh < fh ? rh : fh;
    const bool valid = run >= k && hv != 0 && hv <= max_hash;
    int32_t* o = out + (size_t)(i - (k - 1)) * h;
    if (h == 1) {
      o[0] = valid ? (int32_t)(hv % num_sigs) : sentinel;
      if (outu)
        outu[i - (k - 1)] =
            valid ? (int32_t)(hv % screen_sigs) : (int32_t)screen_sigs;
    } else {
      const uint32_t hi = (uint32_t)(hv >> 32), lo = (uint32_t)hv;
      for (int j = 0; j < h; ++j) {
        const uint32_t v = hi + lo * (uint32_t)j;  // uint32 wrap
        o[j] = valid ? (int32_t)(v % num_sigs) : sentinel;
      }
    }
    count += valid;
  }
  nk[b] = count;
}

}  // namespace

// reads uint8 [B, lmax] (zero padded); loc int32 [B, lmax-k+1, h];
// locu int32 [B, lmax-k+1] (the screen plane, h = 1) or null; nk int32 [B].
// Returns cudaGetLastError() after the launch.
extern "C" int kmcp_hash_loc(const void* reads, int B, int lmax, int k,
                             long long num_sigs, unsigned long long max_hash,
                             int h, unsigned long long seed_a,
                             unsigned long long seed_c,
                             unsigned long long seed_g,
                             unsigned long long seed_t,
                             long long screen_sigs, void* loc, void* locu,
                             void* nk, void* stream) {
  const Seeds seeds{seed_a, seed_c, seed_g, seed_t};
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  if (blocks > 0) {
    hash_loc_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, B, lmax, k, (uint32_t)num_sigs,
        (uint64_t)max_hash, h, seeds, (uint32_t)screen_sigs, (int32_t*)loc,
        (int32_t*)locu, (int32_t*)nk);
  }
  return (int)cudaGetLastError();
}
