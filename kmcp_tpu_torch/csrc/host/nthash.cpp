// Host hot loops of compute and index: the rolling ntHash1 scan, the Bloom
// word-column build, the union-screen fill and the parallel sort + unique.
//
// The port's copy of native/nthash.cpp, cut to the entry points
// kmcp_tpu_torch/kmer/native.py binds (kthash_scan_mt, kt_build_word_column,
// kt_union_fill, kt_sort_unique); the code of each is unchanged, so DBs
// come out byte-identical to kmcp_tpu's.  The read hashing of a search runs
// on the card (csrc/hash_loc.cu), not here.
//
// Build: g++ -O3 -march=native -funroll-loops -shared -fPIC -fopenmp
//        (kmcp_tpu_torch/kmer/native.py, with writer.cpp and parser.cpp)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint64_t SEED_A = 0x3c8bfbb395c60474ULL;
constexpr uint64_t SEED_C = 0x3193c18562a02b4cULL;
constexpr uint64_t SEED_G = 0x20323ed082572324ULL;
constexpr uint64_t SEED_T = 0x295549f54be24456ULL;

inline uint64_t rol(uint64_t x, unsigned r) {
  r &= 63u;
  if (r == 0) return x;
  return (x << r) | (x >> (64 - r));
}
inline uint64_t ror(uint64_t x, unsigned r) {
  r &= 63u;
  if (r == 0) return x;
  return (x >> r) | (x << (64 - r));
}

struct Tables {
  uint64_t seed[256];
  uint64_t seedc[256];  // seed of complement base
  uint8_t ok[256];
  Tables() {
    std::memset(seed, 0, sizeof(seed));
    std::memset(seedc, 0, sizeof(seedc));
    std::memset(ok, 0, sizeof(ok));
    auto set = [&](char b, uint64_t s, uint64_t sc) {
      seed[(uint8_t)b] = s;
      seedc[(uint8_t)b] = sc;
      ok[(uint8_t)b] = 1;
      char lo = b - 'A' + 'a';
      seed[(uint8_t)lo] = s;
      seedc[(uint8_t)lo] = sc;
      ok[(uint8_t)lo] = 1;
    };
    set('A', SEED_A, SEED_T);
    set('C', SEED_C, SEED_G);
    set('G', SEED_G, SEED_C);
    set('T', SEED_T, SEED_A);
  }
};
const Tables T;

// Scan [seq, seq+L); write out[i]/valid[i] for each window start i in
// [0, L-k].  canonical: min(fh, rh); else forward hash.
void scan_range(const uint8_t* seq, int64_t L, int k, int canonical,
                uint64_t* out, uint8_t* valid) {
  const int64_t n = L - k + 1;
  if (n <= 0) return;
  int64_t run = 0;   // consecutive valid bases ending at current position
  uint64_t fh = 0, rh = 0;
  const unsigned ku = (unsigned)k;
  for (int64_t i = 0; i < L; ++i) {
    const uint8_t b = seq[i];
    if (!T.ok[b]) {
      run = 0;
      continue;
    }
    ++run;
    if (run < k) continue;
    const int64_t w = i - k + 1;  // window start
    if (run == k) {
      // fresh window: direct sums
      fh = 0;
      rh = 0;
      for (int j = 0; j < k; ++j) {
        const uint8_t c = seq[w + j];
        fh ^= rol(T.seed[c], (unsigned)(k - 1 - j));
        rh ^= rol(T.seedc[c], (unsigned)j);
      }
    } else {
      // roll from window w-1 to w: out-base seq[w-1], in-base seq[i]
      const uint8_t ob = seq[w - 1];
      fh = rol(fh, 1) ^ rol(T.seed[ob], ku) ^ T.seed[b];
      rh = ror(rh, 1) ^ ror(T.seedc[ob], 1) ^ rol(T.seedc[b], ku - 1);
    }
    if (w < n) {
      out[w] = canonical ? (rh < fh ? rh : fh) : fh;
      valid[w] = 1;
    }
  }
}

}  // namespace

extern "C" {

// Parallel scan: chunks overlap by k-1 so every window is produced
// exactly once; safe because chunk c writes windows [start_c, end_c).
// valid must be zero-initialized by the caller.
void kthash_scan_mt(const uint8_t* seq, int64_t L, int k, int canonical,
                    uint64_t* out, uint8_t* valid, int threads) {
  const int64_t n = L - k + 1;
  if (n <= 0) return;
#ifdef _OPENMP
  if (threads > 1 && n > 1 << 16) {
    const int nt = threads;
    const int64_t chunk = (n + nt - 1) / nt;
#pragma omp parallel for num_threads(nt) schedule(static, 1)
    for (int nchunk = 0; nchunk < nt; ++nchunk) {
      const int64_t w0 = (int64_t)nchunk * chunk;
      if (w0 >= n) continue;
      int64_t w1 = w0 + chunk;
      if (w1 > n) w1 = n;
      // scan bases [w0, w1 + k - 1); windows [w0, w1)
      const int64_t len = (w1 - w0) + k - 1;
      scan_range(seq + w0, len, k, canonical, out + w0, valid + w0);
    }
    return;
  }
#endif
  (void)threads;
  scan_range(seq, L, k, canonical, out, valid);
}

// Build one 32-target word-column of a Bloom bit matrix.
// For each target t in [0, n_targets): set bit (t mod 32) of
// col[loc] for every Bloom location of its hash set.
// hashes are concatenated; target t owns [h_offsets[t], h_offsets[t+1]).
// Multi-hash locations split the 64-bit value into a=hi32, b=lo32 and use
// uint32(a + b*j) — deliberate uint32 wraparound.
void kt_build_word_column(const uint64_t* hashes, const int64_t* h_offsets,
                          int n_targets, int num_hashes, uint64_t num_sigs,
                          uint32_t* col) {
  for (int t = 0; t < n_targets && t < 32; ++t) {
    const uint32_t bit = 1u << t;
    for (int64_t i = h_offsets[t]; i < h_offsets[t + 1]; ++i) {
      const uint64_t h = hashes[i];
      if (num_hashes == 1) {
        col[h % num_sigs] |= bit;
      } else {
        const uint32_t a = (uint32_t)(h >> 32);
        const uint32_t b = (uint32_t)h;
        for (int j = 0; j < num_hashes; ++j) {
          const uint32_t v = a + b * (uint32_t)j;
          col[(uint64_t)v % num_sigs] |= bit;
        }
      }
    }
  }
}

// Fill a Bloom bitset (1 hash) with hashes % U: the per-block union
// screen for large-T search (each block's k-mer union in one bitset, so
// reads cheaply skip blocks they share no k-mers with).
void kt_union_fill(const uint64_t* hashes, int64_t n, uint64_t U,
                   uint64_t* words, int threads) {
#ifdef _OPENMP
#pragma omp parallel for num_threads(threads > 0 ? threads : 1) \
    schedule(static) if (threads > 1 && n > 1 << 20)
#endif
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t b = hashes[i] % U;
#ifdef _OPENMP
#pragma omp atomic
#endif
    words[b >> 6] |= 1ull << (b & 63);
  }
}

// Parallel sort + unique of a uint64 hash array, in place: radix
// partition by the top byte (hashes are uniform, so buckets balance),
// sort each bucket concurrently, then compact out duplicates.  Returns
// the unique count.
int64_t kt_sort_unique(uint64_t* a, int64_t n, int threads) {
  if (n <= 1) return n;
  if (threads <= 0) threads = 1;
  if (n < (int64_t)1 << 16 || threads == 1) {
    std::sort(a, a + n);
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i)
      if (i == 0 || a[i] != a[i - 1]) a[m++] = a[i];
    return m;
  }
  constexpr int B = 256;
  std::vector<int64_t> count(B, 0);
  // count pass (parallel, per-thread counts merged)
#ifdef _OPENMP
#pragma omp parallel num_threads(threads)
  {
    std::vector<int64_t> local(B, 0);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) ++local[a[i] >> 56];
#pragma omp critical
    for (int b = 0; b < B; ++b) count[b] += local[b];
  }
#else
  for (int64_t i = 0; i < n; ++i) ++count[a[i] >> 56];
#endif
  std::vector<int64_t> off(B + 1, 0);
  for (int b = 0; b < B; ++b) off[b + 1] = off[b] + count[b];
  // scatter into bucket order (single pass; memory = one extra copy)
  std::vector<uint64_t> tmp((size_t)n);
  {
    std::vector<int64_t> cur(off.begin(), off.end() - 1);
    for (int64_t i = 0; i < n; ++i) tmp[cur[a[i] >> 56]++] = a[i];
  }
  std::memcpy(a, tmp.data(), (size_t)n * 8);
  // sort buckets in parallel; buckets are independent ranges
#ifdef _OPENMP
#pragma omp parallel for num_threads(threads) schedule(dynamic, 1)
#endif
  for (int b = 0; b < B; ++b) std::sort(a + off[b], a + off[b + 1]);
  // compact duplicates (bucket boundaries preserve global order)
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i)
    if (i == 0 || a[i] != a[i - 1]) a[m++] = a[i];
  return m;
}

// Bloom-row locations: out[i*num_hashes + j] = loc_j(hashes[i]) mod num_sigs
// (the multi-hash split of kt_build_word_column).
void kt_locations(const uint64_t* hashes, int64_t n, int num_hashes,
                  uint64_t num_sigs, int32_t* out, int threads) {
  if (num_sigs == 0) return;
#ifdef _OPENMP
#pragma omp parallel for num_threads(threads > 0 ? threads : 1) \
    schedule(static) if (threads > 1 && n > 1 << 15)
#endif
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t h = hashes[i];
    if (num_hashes == 1) {
      out[i] = (int32_t)(h % num_sigs);
    } else {
      const uint32_t a = (uint32_t)(h >> 32);
      const uint32_t b = (uint32_t)h;
      for (int j = 0; j < num_hashes; ++j) {
        const uint32_t v = a + b * (uint32_t)j;
        out[i * num_hashes + j] = (int32_t)((uint64_t)v % num_sigs);
      }
    }
  }
}

}  // extern "C"
