// The slice counter's per-thread arithmetic for counts up to 511
// (bitslice.cuh: CsaCounter<9>, bitslice_bytes8, floor_split,
// bitslice_mask9, bitslice_expand4) built for the CPU with g++, so that
// tests hold it against the plain PyTorch version without a card:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libbitslice_host.so bitslice_host.cpp
//
// kmcp_bitslice9_host counts each (read, word) as one thread of the slice
// variant (slice.cuh, NL = 9) does: windows in chunks of kc, eight at a time
// through the carry-save tree and the rest one by one, then the epilogue on
// the floors staged as the CTA stages them.  Not part of the product path:
// the CUDA kernels include the same header.

#include <cstddef>
#include <cstdint>

#include "bitslice.cuh"

// words uint32 [B, K, W] (the AND of window i's rows for read b), cthr int32
// [B], thr int32 [32 W], kc >= 1 -> counts int32 [B, 32 W], mask uint32
// [B, W] with bit j of word w set iff counts[b, 32 w + j] >= max(thr[32 w +
// j], cthr[b]).  Needs K <= 511.
extern "C" void kmcp_bitslice9_host(const uint32_t* words, int B, int K, int W,
                                    int kc, const int32_t* cthr,
                                    const int32_t* thr, int32_t* counts,
                                    uint32_t* mask) {
  for (int b = 0; b < B; ++b) {
    for (int w = 0; w < W; ++w) {
      CsaCounter<9> acc;
      acc.init();
      for (int k0 = 0; k0 < K; k0 += kc) {
        const int n = K - k0 < kc ? K - k0 : kc;
        const uint32_t* x = words + ((size_t)b * K + k0) * W + w;
        int i = 0;
        for (; i + 8 <= n; i += 8) {
          uint32_t d[8];
          for (int u = 0; u < 8; ++u) d[u] = x[(size_t)(i + u) * W];
          acc.add8(d);
        }
        for (; i < n; ++i) acc.add1(x[(size_t)i * W]);
      }
      acc.finish();

      // the floors of word w as the CTA stages them
      uint32_t t8[8], thi = 0, tnever = 0;
      for (int k = 0; k < 8; ++k) {
        t8[k] = 0;
        for (int e = 0; e < 4; ++e) {
          const FloorSplit f = floor_split(thr[(size_t)w * 32 + 4 * k + e], 511);
          t8[k] |= f.lo << (8 * e);
          thi |= f.hi << (4 * k + e);
          tnever |= f.never << (4 * k + e);
        }
      }
      uint32_t out[8];
      bitslice_bytes8(acc.c, out);
      const uint32_t c8 = acc.c[8];
      mask[(size_t)b * W + w] =
          bitslice_mask9(out, c8, t8, thi, tnever, cthr[b]);
      int32_t* cw = counts + ((size_t)b * W + w) * 32;
      for (int k = 0; k < 8; ++k) {
        int v[4];
        bitslice_expand4(out[k], c8 >> (4 * k), v);
        for (int e = 0; e < 4; ++e) cw[4 * k + e] = v[e];
      }
    }
  }
}
