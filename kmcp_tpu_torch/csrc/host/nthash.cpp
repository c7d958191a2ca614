// Host hot loops: the rolling ntHash1 scan, the Bloom word-column build,
// the union-screen fill and the parallel sort + unique of compute and index,
// and the read hashing (plain k-mers, minimizers, closed syncmers) and match
// counting of the host search backend (search/device.py HostDB, the object
// engine's C++ counter).
//
// The port's copy of native/nthash.cpp, cut to the entry points
// kmcp_tpu_torch/kmer/native.py binds; the code of each is unchanged, so DBs
// and search TSVs come out byte-identical to kmcp_tpu's.  Not copied:
// kthash_scan (the single-thread scan) and kt_count_blocks (kmcp_tpu's dense
// multi-block fallback for native builds without the sparse counters: the
// port builds these sources at first use, so the sparse counters are always
// there).  The counters have an AVX2 branch (int8 lane accumulators widened
// every <= 255 k-mers) and a scalar branch (ctz walk) for hosts without
// AVX2; both give the same counts.
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

#if defined(__AVX2__)
#include <immintrin.h>
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

// Per-window canonical hashes with NO value filtering: invalid windows
// (containing non-ACGT) emit UINT64_MAX, everything else (including 0
// and values above any scale cutoff) emits the raw hash.  Feeds the
// minimizer selection, which must see every position.
static int64_t hash_row_positions(const uint8_t* seq, int64_t L, int k,
                                  int canonical, uint64_t* vals) {
  const int64_t n = L - k + 1;
  if (n <= 0) return n < 0 ? 0 : n;
  int64_t run = 0;
  uint64_t fh = 0, rh = 0;
  const unsigned ku = (unsigned)k;
  for (int64_t w = 0; w < n; ++w) vals[w] = UINT64_MAX;
  for (int64_t i = 0; i < L; ++i) {
    const uint8_t b = seq[i];
    if (!T.ok[b]) {
      run = 0;
      continue;
    }
    ++run;
    if (run < k) continue;
    const int64_t w = i - k + 1;
    if (run == k) {
      fh = 0;
      rh = 0;
      for (int j = 0; j < k; ++j) {
        const uint8_t c = seq[w + j];
        fh ^= rol(T.seed[c], (unsigned)(k - 1 - j));
        rh ^= rol(T.seedc[c], (unsigned)j);
      }
    } else {
      const uint8_t ob = seq[w - 1];
      fh = rol(fh, 1) ^ rol(T.seed[ob], ku) ^ T.seed[b];
      rh = ror(rh, 1) ^ ror(T.seedc[ob], 1) ^ rol(T.seedc[b], ku - 1);
    }
    vals[w] = canonical ? (rh < fh ? rh : fh) : fh;
  }
  return n;
}

// Minimizer selection over per-window values: sliding window of w
// positions, monotonic deque keeping the FIRST index of the minimum on
// ties, one emission per distinct chosen position; fully-invalid
// windows emit nothing; scale cutoff and the hash!=0 drop apply to the
// selected values (sketches.py minimizer_sketch semantics, mirroring
// the reference's NewMinimizerSketch, compute.go:750,776-788).
static int64_t select_minimizers(const uint64_t* vals, int64_t n, int w,
                                 uint64_t max_hash, uint64_t* out,
                                 int64_t cap) {
  int64_t m = 0;
  auto emit = [&](uint64_t v) {
    if (v != 0 && v <= max_hash && m < cap) out[m++] = v;
  };
  if (n == 0) return 0;
  if (n < w) {
    uint64_t mn = UINT64_MAX;
    for (int64_t i = 0; i < n; ++i) {
      if (vals[i] == UINT64_MAX) return 0;  // any invalid k-mer: skip
      if (vals[i] < mn) mn = vals[i];
    }
    emit(mn);
    return m;
  }
  std::vector<int64_t> dq((size_t)n);
  int64_t head = 0, tail = 0;  // dq[head..tail) indices, values ascending
  int64_t last_pos = -1;
  for (int64_t i = 0; i < n; ++i) {
    // strict > keeps the earliest index on equal values
    while (tail > head && vals[dq[tail - 1]] > vals[i]) --tail;
    dq[tail++] = i;
    if (dq[head] <= i - w) ++head;
    if (i >= w - 1) {
      const int64_t pos = dq[head];
      if (pos != last_pos && vals[pos] != UINT64_MAX) {
        emit(vals[pos]);
        last_pos = pos;
      }
    }
  }
  return m;
}

// Closed-syncmer selection: k-mer i is kept when the minimum canonical
// s-mer hash within it (window [i, i+k-s], invalid s-mers = UINT64_MAX,
// value-based comparison) equals the first or last s-mer's value
// (sketches.py closed_syncmer_sketch; reference NewSyncmerSketch,
// compute.go:748,763-775).  kvals/svals are per-position hashes from
// hash_row_positions at k and s.
static int64_t select_syncmers(const uint64_t* kvals, int64_t nk,
                               const uint64_t* svals, int64_t ns, int w,
                               uint64_t max_hash, uint64_t* out,
                               int64_t cap) {
  int64_t m = 0;
  if (nk <= 0 || w <= 0 || ns < w) return 0;
  std::vector<int64_t> dq((size_t)ns);
  int64_t head = 0, tail = 0;
  // prime the deque with the first w-1 s-mers
  for (int64_t i = 0; i < w - 1 && i < ns; ++i) {
    while (tail > head && svals[dq[tail - 1]] > svals[i]) --tail;
    dq[tail++] = i;
  }
  for (int64_t i = 0; i < nk; ++i) {
    const int64_t j = i + w - 1;  // last s-mer of k-mer i
    while (tail > head && svals[dq[tail - 1]] > svals[j]) --tail;
    dq[tail++] = j;
    if (dq[head] < i) ++head;
    const uint64_t v = kvals[i];
    if (v == UINT64_MAX) continue;
    const uint64_t mn = svals[dq[head]];
    if ((mn == svals[i] || mn == svals[j]) && v != 0 && v <= max_hash &&
        m < cap)
      out[m++] = v;
  }
  return m;
}

// Hash one read's k-mers (canonical, hash!=0, <= max_hash) into buf
// (capacity cap); returns the number kept (never exceeds cap — callers
// size cap to the window count).  If dedup_threshold > 0 and more than
// that many k-mers were kept, the buffer is sorted and deduplicated in
// place (the reference's deduplication of large queries,
// util-db-search.go:874-908) and the unique count is returned.
static int64_t hash_row(const uint8_t* seq, int64_t L, int k, int canonical,
                        uint64_t max_hash, uint64_t* buf, int64_t cap,
                        int64_t dedup_threshold, int minimizer_w = 0,
                        uint64_t* vals_scratch = nullptr, int syncmer_s = 0,
                        uint64_t* svals_scratch = nullptr) {
  int64_t nout = 0;
  if ((minimizer_w > 0 || syncmer_s > 0) && vals_scratch != nullptr) {
    const int64_t n =
        hash_row_positions(seq, L, k, canonical, vals_scratch);
    if (syncmer_s > 0 && svals_scratch != nullptr) {
      const int64_t ns =
          hash_row_positions(seq, L, syncmer_s, canonical, svals_scratch);
      nout = select_syncmers(vals_scratch, n, svals_scratch, ns,
                             k - syncmer_s + 1, max_hash, buf, cap);
    } else {
      nout = select_minimizers(vals_scratch, n, minimizer_w, max_hash, buf,
                               cap);
    }
    if (dedup_threshold > 0 && nout > dedup_threshold) {
      std::sort(buf, buf + nout);
      int64_t m = 0;
      for (int64_t i = 0; i < nout; ++i)
        if (i == 0 || buf[i] != buf[i - 1]) buf[m++] = buf[i];
      nout = m;
    }
    return nout;
  }
  const int64_t n = L - k + 1;
  if (n > 0) {
    int64_t run = 0;
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
      const int64_t w = i - k + 1;
      if (run == k) {
        fh = 0;
        rh = 0;
        for (int j = 0; j < k; ++j) {
          const uint8_t c = seq[w + j];
          fh ^= rol(T.seed[c], (unsigned)(k - 1 - j));
          rh ^= rol(T.seedc[c], (unsigned)j);
        }
      } else {
        const uint8_t ob = seq[w - 1];
        fh = rol(fh, 1) ^ rol(T.seed[ob], ku) ^ T.seed[b];
        rh = ror(rh, 1) ^ ror(T.seedc[ob], 1) ^ rol(T.seedc[b], ku - 1);
      }
      const uint64_t h = canonical ? (rh < fh ? rh : fh) : fh;
      if (h == 0 || h > max_hash) continue;
      if (nout < cap) buf[nout++] = h;
    }
  }
  if (dedup_threshold > 0 && nout > dedup_threshold) {
    std::sort(buf, buf + nout);
    int64_t m = 0;
    for (int64_t i = 0; i < nout; ++i) {
      if (i == 0 || buf[i] != buf[i - 1]) buf[m++] = buf[i];
    }
    nout = m;
  }
  return nout;
}

}  // namespace

extern "C" {

// Parallel scan: chunks overlap by k-1 so every window is produced
// exactly once; safe because chunk c writes windows [start_c, end_c).
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

// Batched read hashing with padded output: hash every read of a batch and
// write row r of out[B, kmax] with its k-mer hashes (canonical, hash!=0,
// optionally <= max_hash), zero-padded; counts[r] = number of valid k-mers.
// reads are given concatenated with their (start, len) tables.
void kt_hash_reads(const uint8_t* concat, const int64_t* starts,
                   const int64_t* lens, int64_t n_reads, int k, int canonical,
                   uint64_t max_hash, uint64_t* out, int64_t kmax,
                   int64_t* counts, int threads, int64_t dedup_threshold,
                   int minimizer_w, int syncmer_s) {
  const int sketchy = minimizer_w > 0 || syncmer_s > 0;
#ifdef _OPENMP
#pragma omp parallel num_threads(threads > 0 ? threads : 1) \
    if (threads > 1 && n_reads > 256)
#endif
  {
    std::vector<uint64_t> vals(sketchy ? (size_t)(kmax + k) : 0);
    std::vector<uint64_t> svals(syncmer_s > 0 ? (size_t)(kmax + k) : 0);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
    for (int64_t r = 0; r < n_reads; ++r) {
      uint64_t* row = out + r * kmax;
      counts[r] =
          hash_row(concat + starts[r], lens[r], k, canonical, max_hash, row,
                   kmax, dedup_threshold, minimizer_w, vals.data(),
                   syncmer_s, svals.data());
      // zero-pad so callers can mask padded lanes by hash == 0
      for (int64_t j = counts[r]; j < kmax; ++j) row[j] = 0;
    }
  }
}

// Same, but emit int32 Bloom-row locations directly (fused hash+mod),
// with a sentinel row ``num_sigs`` for padding lanes so the device gather
// needs no separate mask.
void kt_hash_reads_loc(const uint8_t* concat, const int64_t* starts,
                       const int64_t* lens, int64_t n_reads, int k,
                       int canonical, uint64_t max_hash, uint64_t num_sigs,
                       int num_hashes, int32_t* out, int64_t kmax,
                       int64_t* counts, int threads, int64_t dedup_threshold,
                       int minimizer_w, int syncmer_s) {
  const int sketchy = minimizer_w > 0 || syncmer_s > 0;
#ifdef _OPENMP
#pragma omp parallel num_threads(threads > 0 ? threads : 1) \
    if (threads > 1 && n_reads > 256)
#endif
  {
    std::vector<uint64_t> buf((size_t)kmax);
    std::vector<uint64_t> vals(sketchy ? (size_t)(kmax + k) : 0);
    std::vector<uint64_t> svals(syncmer_s > 0 ? (size_t)(kmax + k) : 0);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
    for (int64_t r = 0; r < n_reads; ++r) {
      int32_t* row = out + r * kmax * num_hashes;
      const int64_t nout =
          hash_row(concat + starts[r], lens[r], k, canonical, max_hash,
                   buf.data(), kmax, dedup_threshold, minimizer_w,
                   vals.data(), syncmer_s, svals.data());
      if (num_hashes == 1) {
        for (int64_t i = 0; i < nout; ++i)
          row[i] = (int32_t)(buf[i] % num_sigs);
        for (int64_t i = nout; i < kmax; ++i) row[i] = (int32_t)num_sigs;
      } else {
        for (int64_t i = 0; i < nout; ++i) {
          const uint32_t a = (uint32_t)(buf[i] >> 32);
          const uint32_t bb = (uint32_t)buf[i];
          for (int j = 0; j < num_hashes; ++j) {
            const uint32_t v = a + bb * (uint32_t)j;
            row[i * num_hashes + j] = (int32_t)((uint64_t)v % num_sigs);
          }
        }
        for (int64_t i = nout * num_hashes; i < kmax * num_hashes; ++i)
          row[i] = (int32_t)num_sigs;
      }
      counts[r] = nout;
    }
  }
}

// Match counting on host: for each read, gather its Bloom rows, AND over
// the hash functions, and accumulate per-target counts — the pospop/pand
// equivalent.  AVX2 path: each uint32 word expands to 32 0/1 byte lanes
// (shuffle + bit-mask + cmpeq) subtracted into int8 accumulators, widened
// every <=255 k-mers; ~5 instructions per 32 targets vs the scalar
// ctz-walk fallback.  counts_out is [B, W*32] int32, zeroed here.
void kt_count_block(const uint32_t* bits /* (S+1) x W */, int64_t W,
                    const int32_t* loc /* B x K x h */, int64_t B, int64_t K,
                    int num_hashes, int32_t* counts_out, int threads,
                    const uint8_t* active /* B, NULL = all */) {
  const int64_t T = W * 32;
#ifdef _OPENMP
#pragma omp parallel num_threads(threads > 0 ? threads : 1) if (threads > 1 && B > 64)
#endif
  {
#if defined(__AVX2__)
    const __m256i shuf = _mm256_setr_epi8(
        0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
        2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3);
    const __m256i bitsel = _mm256_set1_epi64x(0x8040201008040201ULL);
    // per-read int8 accumulators, one 32-byte lane group per word
    std::vector<uint8_t> accbuf(W * 32);
    uint8_t* acc = accbuf.data();
#endif
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int64_t r = 0; r < B; ++r) {
      int32_t* counts = counts_out + r * T;
      std::memset(counts, 0, T * sizeof(int32_t));
      if (active && !active[r]) continue;  // block-screened read
      const int32_t* lrow = loc + r * K * num_hashes;
      const int64_t PF = 8;  // prefetch distance (k-mers ahead)
#if defined(__AVX2__)
      for (int64_t k0 = 0; k0 < K; k0 += 255) {
        const int64_t k1 = (k0 + 255 < K) ? k0 + 255 : K;
        std::memset(acc, 0, W * 32);
        for (int64_t kk = k0; kk < k1; ++kk) {
          if (kk + PF < K) {
            const int32_t* lp = lrow + (kk + PF) * num_hashes;
            for (int j = 0; j < num_hashes; ++j) {
              __builtin_prefetch(bits + (int64_t)lp[j] * W, 0, 1);
            }
          }
          const int32_t* lk = lrow + kk * num_hashes;
          const uint32_t* row0 = bits + (int64_t)lk[0] * W;
          for (int64_t w = 0; w < W; ++w) {
            uint32_t word = row0[w];
            for (int j = 1; j < num_hashes; ++j) {
              word &= bits[(int64_t)lk[j] * W + w];
            }
            if (!word) continue;
            __m256i v = _mm256_set1_epi32((int)word);
            v = _mm256_shuffle_epi8(v, shuf);
            v = _mm256_and_si256(v, bitsel);
            v = _mm256_cmpeq_epi8(v, bitsel);  // 0xFF where bit set
            __m256i* ap = (__m256i*)(acc + w * 32);
            _mm256_storeu_si256(
                ap, _mm256_sub_epi8(_mm256_loadu_si256(ap), v));
          }
        }
        // widen int8 accumulators into the int32 counters
        for (int64_t t = 0; t < T; ++t) counts[t] += acc[t];
      }
#else
      for (int64_t kk = 0; kk < K; ++kk) {
        if (kk + PF < K) {
          const int32_t* lp = lrow + (kk + PF) * num_hashes;
          for (int j = 0; j < num_hashes; ++j) {
            __builtin_prefetch(bits + (int64_t)lp[j] * W, 0, 1);
          }
        }
        const int32_t* lk = lrow + kk * num_hashes;
        for (int64_t w = 0; w < W; ++w) {
          uint32_t word = bits[(int64_t)lk[0] * W + w];
          for (int j = 1; j < num_hashes; ++j) {
            word &= bits[(int64_t)lk[j] * W + w];
          }
          const int64_t base = w * 32;
          while (word) {
            const int b = __builtin_ctz(word);
            ++counts[base + b];
            word &= word - 1;
          }
        }
      }
#endif
    }
  }
}

// Build one 32-target word-column of a Bloom bit matrix.
// For each target t in [0, n_targets): set bit (t mod 32) of
// col[loc] for every Bloom location of its hash set.
// hashes are concatenated; target t owns [h_offsets[t], h_offsets[t+1]).
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

// Per-read count of k-mers present in a union bitset.  hashes is the
// padded [B, kmax] matrix (0 = padding, never counted since hash 0 is
// dropped upstream).
void kt_union_count(const uint64_t* words, uint64_t U,
                    const uint64_t* hashes, int64_t B, int64_t kmax,
                    int32_t* out, int threads) {
#ifdef _OPENMP
#pragma omp parallel for num_threads(threads > 0 ? threads : 1) \
    schedule(dynamic, 16) if (threads > 1 && B > 64)
#endif
  for (int64_t r = 0; r < B; ++r) {
    const uint64_t* row = hashes + r * kmax;
    int32_t c = 0;
    for (int64_t i = 0; i < kmax; ++i) {
      const uint64_t h = row[i];
      if (h == 0) continue;
      const uint64_t b = h % U;
      c += (int32_t)((words[b >> 6] >> (b & 63)) & 1ull);
    }
    out[r] = c;
  }
}

// Parallel sort + unique of a uint64 hash array, in place: radix
// partition by the top byte (hashes are uniform, so buckets balance),
// sort each bucket concurrently, then compact out duplicates.  Returns
// the unique count.  Replaces numpy's single-threaded sort in the
// compute dedup (reference sortutil.Uint64s + unique counting,
// kmcp/cmd/compute.go:832-858) and in large-query dedup.
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

// Bloom-row locations: out[i*num_hashes + j] = loc_j(hashes[i]) mod num_sigs.
// Multi-hash derivation splits the 64-bit value into a=hi32, b=lo32 and uses
// uint32(a + b*j) — deliberate uint32 wraparound, matching
// kmcp/cmd/util-hash.go:61-142.
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

// Fused count + threshold + compaction for the large-target regime:
// counts per-target matched k-mers like kt_count_block, but instead of
// materializing the dense [B, T] count matrix (262 MB at B=16k, T=131k —
// the NumPy threshold pass over it dominated host search beyond ~10k
// targets), each read's counts live in a thread-local buffer and only
// candidates passing
//     cnt >= cmin_per_read[r]  &&  cnt >= tmin_eff[t]
// are emitted as (r * T_total + t_offset + t, cnt) pairs.  Threshold
// exactness matches kmcp_tpu/search/device.py: cmin/tmin are the
// integerized float64 thresholds (util-db-search.go:7466-7493), with
// INT32_MAX marking excluded reads / padding lanes.
//
// Append semantics for multi-block search: `cursor` is the candidate
// count from previous calls; entries beyond `budget` are counted but not
// stored (the caller retries with a larger budget, stream.py::drain).
// Returns the new total candidate count.
int64_t kt_count_block_sparse(
    const uint32_t* bits /* (S+1) x W */, int64_t W,
    const int32_t* loc /* B x K x h */, int64_t B, int64_t K,
    int num_hashes, const int32_t* cmin_per_read /* B */,
    const int32_t* tmin_eff /* W*32 */, const uint8_t* active /* B|NULL */,
    int64_t t_offset, int64_t T_total, int64_t budget,
    int64_t* idx_out, int32_t* cnt_out, int64_t cursor, int threads) {
  const int64_t T = W * 32;
  const int nthr = threads > 0 ? threads : 1;
  std::vector<std::vector<int64_t>> tidx(nthr);
  std::vector<std::vector<int32_t>> tcnt(nthr);
#ifdef _OPENMP
#pragma omp parallel num_threads(nthr) if (nthr > 1 && B > 64)
#endif
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    std::vector<int32_t> cntbuf(T);
    int32_t* counts = cntbuf.data();
#if defined(__AVX2__)
    const __m256i shuf = _mm256_setr_epi8(
        0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
        2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3);
    const __m256i bitsel = _mm256_set1_epi64x(0x8040201008040201ULL);
    std::vector<uint8_t> accbuf(W * 32);
    uint8_t* acc = accbuf.data();
#endif
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int64_t r = 0; r < B; ++r) {
      const int32_t cmin_r = cmin_per_read[r];
      if (cmin_r == INT32_MAX) continue;       // excluded read
      if (active && !active[r]) continue;      // block-screened read
      std::memset(counts, 0, T * sizeof(int32_t));
      const int32_t* lrow = loc + r * K * num_hashes;
      const int64_t PF = 8;
#if defined(__AVX2__)
      for (int64_t k0 = 0; k0 < K; k0 += 255) {
        const int64_t k1 = (k0 + 255 < K) ? k0 + 255 : K;
        std::memset(acc, 0, W * 32);
        for (int64_t kk = k0; kk < k1; ++kk) {
          if (kk + PF < K) {
            const int32_t* lp = lrow + (kk + PF) * num_hashes;
            for (int j = 0; j < num_hashes; ++j) {
              __builtin_prefetch(bits + (int64_t)lp[j] * W, 0, 1);
            }
          }
          const int32_t* lk = lrow + kk * num_hashes;
          const uint32_t* row0 = bits + (int64_t)lk[0] * W;
          for (int64_t w = 0; w < W; ++w) {
            uint32_t word = row0[w];
            for (int j = 1; j < num_hashes; ++j) {
              word &= bits[(int64_t)lk[j] * W + w];
            }
            if (!word) continue;
            __m256i v = _mm256_set1_epi32((int)word);
            v = _mm256_shuffle_epi8(v, shuf);
            v = _mm256_and_si256(v, bitsel);
            v = _mm256_cmpeq_epi8(v, bitsel);
            __m256i* ap = (__m256i*)(acc + w * 32);
            _mm256_storeu_si256(
                ap, _mm256_sub_epi8(_mm256_loadu_si256(ap), v));
          }
        }
        for (int64_t t = 0; t < T; ++t) counts[t] += acc[t];
      }
#else
      for (int64_t kk = 0; kk < K; ++kk) {
        const int32_t* lk = lrow + kk * num_hashes;
        for (int64_t w = 0; w < W; ++w) {
          uint32_t word = bits[(int64_t)lk[0] * W + w];
          for (int j = 1; j < num_hashes; ++j) {
            word &= bits[(int64_t)lk[j] * W + w];
          }
          const int64_t base = w * 32;
          while (word) {
            const int b = __builtin_ctz(word);
            ++counts[base + b];
            word &= word - 1;
          }
        }
      }
#endif
      // threshold scan: most lanes fail cnt >= cmin_r immediately
      const int64_t gbase = r * T_total + t_offset;
      for (int64_t t = 0; t < T; ++t) {
        const int32_t c = counts[t];
        if (c >= cmin_r && c >= tmin_eff[t]) {
          tidx[tid].push_back(gbase + t);
          tcnt[tid].push_back(c);
        }
      }
    }
  }
  int64_t total = cursor;
  for (int i = 0; i < nthr; ++i) {
    const int64_t n = (int64_t)tidx[i].size();
    for (int64_t j = 0; j < n; ++j) {
      if (total < budget) {
        idx_out[total] = tidx[i][j];
        cnt_out[total] = tcnt[i][j];
      }
      ++total;
    }
  }
  return total;
}

// kt_count_block_sparse variant taking raw uint64 hashes: Bloom
// locations derive inline (hash % num_sigs + row_offset, multi-hash via
// the uint32 a+b*j split, kt_locations above) so the multi-block search
// loop makes ONE native call per block with no [B,K,h] loc arrays or
// NumPy offset/sentinel passes in between (those dominated the screened
// large-T profile).  hash==0 marks padding lanes (skipped).
int64_t kt_count_hashes_sparse(
    const uint32_t* bits /* (S+1) x W */, int64_t W,
    const uint64_t* hashes /* B x K */, int64_t B, int64_t K,
    int num_hashes, uint64_t num_sigs, int64_t row_offset,
    const int32_t* cmin_per_read /* B */,
    const int32_t* tmin_eff /* W*32 */, const uint8_t* active /* B|NULL */,
    int64_t t_offset, int64_t T_total, int64_t budget,
    int64_t* idx_out, int32_t* cnt_out, int64_t cursor, int threads) {
  const int64_t T = W * 32;
  const int nthr = threads > 0 ? threads : 1;
  std::vector<std::vector<int64_t>> tidx(nthr);
  std::vector<std::vector<int32_t>> tcnt(nthr);
#ifdef _OPENMP
#pragma omp parallel num_threads(nthr) if (nthr > 1 && B > 64)
#endif
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    std::vector<int32_t> cntbuf(T);
    int32_t* counts = cntbuf.data();
    std::vector<int64_t> locbuf(8);  // per-kmer rows (num_hashes <= 8)
#if defined(__AVX2__)
    const __m256i shuf = _mm256_setr_epi8(
        0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
        2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3);
    const __m256i bitsel = _mm256_set1_epi64x(0x8040201008040201ULL);
    std::vector<uint8_t> accbuf(W * 32);
    uint8_t* acc = accbuf.data();
#endif
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int64_t r = 0; r < B; ++r) {
      const int32_t cmin_r = cmin_per_read[r];
      if (cmin_r == INT32_MAX) continue;
      if (active && !active[r]) continue;
      std::memset(counts, 0, T * sizeof(int32_t));
      const uint64_t* hrow = hashes + r * K;
      const int nh = num_hashes > 8 ? 8 : num_hashes;
      const int64_t PF = 8;
#if defined(__AVX2__)
      for (int64_t k0 = 0; k0 < K; k0 += 255) {
        const int64_t k1 = (k0 + 255 < K) ? k0 + 255 : K;
        std::memset(acc, 0, W * 32);
        for (int64_t kk = k0; kk < k1; ++kk) {
          const uint64_t h = hrow[kk];
          if (!h) continue;
          if (kk + PF < K && hrow[kk + PF]) {
            // prefetch the next k-mer's first row
            const uint64_t hp = hrow[kk + PF];
            uint64_t lp;
            if (num_hashes == 1) {
              lp = hp % num_sigs;
            } else {
              lp = (uint64_t)(uint32_t)(hp >> 32) % num_sigs;
            }
            __builtin_prefetch(bits + (row_offset + (int64_t)lp) * W, 0, 1);
          }
          int64_t* lk = locbuf.data();
          if (num_hashes == 1) {
            lk[0] = row_offset + (int64_t)(h % num_sigs);
          } else {
            const uint32_t a = (uint32_t)(h >> 32);
            const uint32_t b = (uint32_t)h;
            for (int j = 0; j < nh; ++j) {
              const uint32_t v = a + b * (uint32_t)j;
              lk[j] = row_offset + (int64_t)((uint64_t)v % num_sigs);
            }
          }
          const uint32_t* row0 = bits + lk[0] * W;
          for (int64_t w = 0; w < W; ++w) {
            uint32_t word = row0[w];
            for (int j = 1; j < nh; ++j) {
              word &= bits[lk[j] * W + w];
            }
            if (!word) continue;
            __m256i v = _mm256_set1_epi32((int)word);
            v = _mm256_shuffle_epi8(v, shuf);
            v = _mm256_and_si256(v, bitsel);
            v = _mm256_cmpeq_epi8(v, bitsel);
            __m256i* ap = (__m256i*)(acc + w * 32);
            _mm256_storeu_si256(
                ap, _mm256_sub_epi8(_mm256_loadu_si256(ap), v));
          }
        }
        for (int64_t t = 0; t < T; ++t) counts[t] += acc[t];
      }
#else
      for (int64_t kk = 0; kk < K; ++kk) {
        const uint64_t h = hrow[kk];
        if (!h) continue;
        int64_t* lk = locbuf.data();
        if (num_hashes == 1) {
          lk[0] = row_offset + (int64_t)(h % num_sigs);
        } else {
          const uint32_t a = (uint32_t)(h >> 32);
          const uint32_t b = (uint32_t)h;
          for (int j = 0; j < nh; ++j) {
            const uint32_t v = a + b * (uint32_t)j;
            lk[j] = row_offset + (int64_t)((uint64_t)v % num_sigs);
          }
        }
        for (int64_t w = 0; w < W; ++w) {
          uint32_t word = bits[lk[0] * W + w];
          for (int j = 1; j < nh; ++j) {
            word &= bits[lk[j] * W + w];
          }
          const int64_t base = w * 32;
          while (word) {
            const int b = __builtin_ctz(word);
            ++counts[base + b];
            word &= word - 1;
          }
        }
      }
#endif
      const int64_t gbase = r * T_total + t_offset;
      for (int64_t t = 0; t < T; ++t) {
        const int32_t c = counts[t];
        if (c >= cmin_r && c >= tmin_eff[t]) {
          tidx[tid].push_back(gbase + t);
          tcnt[tid].push_back(c);
        }
      }
    }
  }
  int64_t total = cursor;
  for (int i = 0; i < nthr; ++i) {
    const int64_t n = (int64_t)tidx[i].size();
    for (int64_t j = 0; j < n; ++j) {
      if (total < budget) {
        idx_out[total] = tidx[i][j];
        cnt_out[total] = tcnt[i][j];
      }
      ++total;
    }
  }
  return total;
}

}  // extern "C"
