// The slice counter's and the row ring's geometry (geometry.cuh) built for
// the CPU with g++, so that tests check, without a card, which variant each
// row count takes and that a ring warp's copies cover every word of its
// row segments once:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libgeometry_host.so geometry_host.cpp
//
// Not part of the product path: the CUDA kernels include the same header.

#include <cstddef>

#include "geometry.cuh"

extern "C" int kmcp_geo_pick(int smem_optin, int W, int S_ext, int h) {
  return geo::pick(smem_optin, W, S_ext, h);
}

extern "C" long long kmcp_geo_slice_smem(int S_ext, int h) {
  return (long long)geo::slice_smem(S_ext, h);
}

extern "C" long long kmcp_geo_ring_smem(int span, int h) {
  return (long long)geo::ring_smem(span, h);
}

extern "C" int kmcp_geo_ring_span(int W) { return geo::ring_span(W); }

// Runs every lane's copies of one stage of a ring warp as ring_count issues
// them (16-byte copies: wpc = 4, else 1) for a warp whose first nw of 32
// words lie in the rows, adding 1 to hits[seg * 32 + word] for each word
// copied (hits int32 [ring_stage_words(h)], zeroed by the caller).
// Returns the number of copies whose segment has no row (past RING_KC h)
// or whose destination falls outside the stage (0 of each).
extern "C" int kmcp_geo_ring_stage_hits(int h, int nw, int wpc, int* hits) {
  int outside = 0;
  const int stage = geo::ring_stage_words(h);
  for (int lane = 0; lane < 32; ++lane) {
    for (int m = 0; m < geo::ring_copies_per_lane(h, wpc); ++m) {
      const geo::Copy c = geo::ring_copy(lane + 32 * m, wpc);
      if (c.seg >= geo::RING_KC * h) {
        ++outside;
        continue;
      }
      if (c.word >= nw) continue;
      for (int j = 0; j < wpc; ++j) {
        const int at = c.seg * 32 + c.word + j;
        if (at < 0 || at >= stage)
          ++outside;
        else
          ++hits[at];
      }
    }
  }
  return outside;
}
