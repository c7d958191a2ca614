// K1''s per-thread arithmetic (nthash_window.cuh) built for the CPU with
// g++, so that tests hold it against the plain PyTorch version without a
// card:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libnt_host.so hash_loc_host.cpp
//
// kmcp_hash_loc_host runs the kernel's strips, ``ls`` windows each, one
// after another over every read; kmcp_nt_direct evaluates the direct
// formula of every window; kmcp_nt_mod reduces values by one modulus.
// Not part of the product path: the CUDA kernel (hash_loc.cu) includes the
// same header.

#include <cstddef>
#include <cstdint>

#include "nthash_window.cuh"

namespace {

struct HostCodes {
  const uint8_t* p;
  int operator()(int i) const { return nt::base_code(p[i]); }
};

}  // namespace

// Arguments as kmcp_hash_loc's (hash_loc.cu), plus the strip length ls.
extern "C" void kmcp_hash_loc_host(const uint8_t* reads, int B, int lmax,
                                   int k, long long num_sigs,
                                   unsigned long long max_hash, int h,
                                   const unsigned long long* seeds,
                                   long long screen_sigs, int ls,
                                   int32_t* loc, int32_t* locu, int32_t* nk,
                                   int64_t* vals) {
  const uint64_t s[4] = {seeds[0], seeds[1], seeds[2], seeds[3]};
  nt::Params P;
  P.k = k;
  P.h = h;
  P.max_hash = max_hash;
  P.rows = nt::make_modulus((uint32_t)num_sigs);
  P.screen = nt::make_modulus((uint32_t)screen_sigs);
  const nt::Tables tab = nt::make_tables(s, k);
  const int K = lmax - k + 1;
  for (int b = 0; b < B; ++b) {
    const HostCodes code{reads + (size_t)b * lmax};
    int count = 0;
    for (int w0 = 0; w0 < K; w0 += ls) {
      const int w1 = w0 + ls < K ? w0 + ls : K;
      count += nt::nt_strip(code, w0, w1, tab.t, P,
                            loc + (size_t)b * K * h,
                            locu ? locu + (size_t)b * K : nullptr,
                            vals ? vals + (size_t)b * K : nullptr);
    }
    nk[b] = count;
  }
}

// out[b, w] = the direct formula's canonical value of window w of read b
// (0 when one of its k bases is invalid).
extern "C" void kmcp_nt_direct(const uint8_t* reads, int B, int lmax, int k,
                               const unsigned long long* seeds,
                               uint64_t* out) {
  const uint64_t s[4] = {seeds[0], seeds[1], seeds[2], seeds[3]};
  const int K = lmax - k + 1;
  for (int b = 0; b < B; ++b) {
    const HostCodes code{reads + (size_t)b * lmax};
    for (int w = 0; w < K; ++w) out[(size_t)b * K + w] = nt::nt_direct(code, w, k, s);
  }
}

// out[i] = x[i] mod d through nt::mod (d in 1..2^31-1).
extern "C" void kmcp_nt_mod(const uint64_t* x, long long n, unsigned d,
                            uint32_t* out) {
  const nt::Modulus M = nt::make_modulus(d);
  for (long long i = 0; i < n; ++i) out[i] = nt::mod(x[i], M);
}
