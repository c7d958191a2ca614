// Native TSV row formatter for search results.
//
// Formats match rows byte-identically to the reference's hand-inlined
// writer (kmcp/cmd/search.go:529-575): 15 tab-separated columns with
// qCov/tCov/jacc as %.4f and FPR via a precomputed string table.
// The caller passes sorted per-candidate arrays plus per-read and
// per-target metadata; rows are appended to a caller-provided buffer.
// The port's copy of native/writer.cpp, unchanged, so the port's TSVs are
// byte-identical to kmcp_tpu's.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline char* put_str(char* p, const char* s, int64_t len) {
  std::memcpy(p, s, len);
  return p + len;
}

inline char* put_int(char* p, int64_t v) {
  if (v == 0) {
    *p++ = '0';
    return p;
  }
  if (v < 0) {
    *p++ = '-';
    v = -v;
  }
  char tmp[24];
  int n = 0;
  while (v > 0) {
    tmp[n++] = '0' + (v % 10);
    v /= 10;
  }
  while (n > 0) *p++ = tmp[--n];
  return p;
}

inline char* put_ratio4(char* p, double v) {
  // %.4f of a double in [0, ~1e6); snprintf matches Go's correctly-rounded
  // FormatFloat(v, 'f', 4, 64) for these magnitudes.
  int n = std::snprintf(p, 32, "%.4f", v);
  return p + n;
}

struct StrTab {
  const char* data;
  const int64_t* offsets;  // len n+1
  inline const char* at(int64_t i, int64_t* len) const {
    *len = offsets[i + 1] - offsets[i];
    return data + offsets[i];
  }
};

}  // namespace

extern "C" {

// Returns the number of bytes written to buf (caller sizes it generously:
// ~(n_rows + n_unmatched) * 256).
//
// Candidate arrays (already sorted by read, score desc): qi, t, cnt [n_rows].
// Per-read arrays (length n_reads, indexed by local read id): qlen, nkmers,
// hits, flags (bit0: skip entirely — slow-path read written by the caller;
// bit1: too-short read, unmatched row reports 0 k-mers).
// Per-target tables: names/chunkidx/chunks/gsize strings, sizes int64.
// fpr_tab: string table indexed by n*(nmax+1)+c.
// keep_unmatched emits the reference's unmatched row (search.go:593-605):
// qid qlen nk 0 0 "" -1 0 0 k 0 0 0 0 idx.
int64_t kt_write_rows(
    const int32_t* qi, const int32_t* t, const int32_t* cnt, int64_t n_rows,
    int64_t n_reads, const int64_t* qlen, const int64_t* nkmers,
    const int32_t* hits, const uint8_t* flags,
    const char* qid_data, const int64_t* qid_offsets,
    const char* tname_data, const int64_t* tname_offsets,
    const char* tmeta_data, const int64_t* tmeta_offsets,  // "\tchunkIdx\tchunks\tgsize\tk\t" per target
    const int64_t* sizes,
    const char* fpr_data, const int64_t* fpr_offsets, int64_t fpr_nmax,
    int64_t qidx_base, char* buf, int keep_unmatched, const char* k_str,
    int64_t k_str_len) {
  StrTab qid{qid_data, qid_offsets};
  StrTab tname{tname_data, tname_offsets};
  StrTab tmeta{tmeta_data, tmeta_offsets};
  StrTab fpr{fpr_data, fpr_offsets};

  // candidate-row start per read (rows are grouped by read in order)
  std::vector<int64_t> row_start(n_reads + 1);
  {
    int64_t acc = 0;
    for (int64_t r = 0; r < n_reads; ++r) {
      row_start[r] = acc;
      if (!(flags[r] & 1)) acc += hits[r];
    }
    row_start[n_reads] = acc;
  }

  auto emit_read = [&](int64_t r, char* p) -> char* {
    const int32_t h = hits[r];
    int64_t row = row_start[r];
    int64_t lq;
    const char* sq = qid.at(r, &lq);
    const int64_t n = nkmers[r];
    if (h == 0) {
      if (!keep_unmatched) return p;
      p = put_str(p, sq, lq);
      *p++ = '\t';
      p = put_int(p, qlen[r]);
      *p++ = '\t';
      p = put_int(p, (flags[r] & 2) ? 0 : n);
      std::memcpy(p, "\t0\t0\t\t-1\t0\t0\t", 13);
      p += 13;
      p = put_str(p, k_str, k_str_len);
      std::memcpy(p, "\t0\t0\t0\t0\t", 9);
      p += 9;
      p = put_int(p, qidx_base + r);
      *p++ = '\n';
      return p;
    }
    for (int32_t j = 0; j < h; ++j, ++row) {
      const int64_t ti = t[row];
      const int64_t c = cnt[row];
      p = put_str(p, sq, lq);
      *p++ = '\t';
      p = put_int(p, qlen[r]);
      *p++ = '\t';
      p = put_int(p, n);
      *p++ = '\t';
      int64_t lf;
      const char* sf = fpr.at(n * (fpr_nmax + 1) + c, &lf);
      p = put_str(p, sf, lf);
      *p++ = '\t';
      p = put_int(p, h);
      *p++ = '\t';
      int64_t lt;
      const char* st = tname.at(ti, &lt);
      p = put_str(p, st, lt);
      int64_t lm;
      const char* sm = tmeta.at(ti, &lm);  // "\tchunkIdx\tchunks\tgsize\tk\t"
      p = put_str(p, sm, lm);
      p = put_int(p, c);
      *p++ = '\t';
      const int64_t size = sizes[ti];
      p = put_ratio4(p, (double)c / (double)n);
      *p++ = '\t';
      p = put_ratio4(p, (double)c / (double)size);
      *p++ = '\t';
      p = put_ratio4(p, (double)c / (double)(n + size - c));
      *p++ = '\t';
      p = put_int(p, qidx_base + r);
      *p++ = '\n';
    }
    return p;
  };

#ifdef _OPENMP
  const int nt_req = 4;
  if (n_rows > 4096) {
    // parallel format into per-chunk scratch, then concatenate in order
    const int nt = nt_req;
    const int64_t per = (n_reads + nt - 1) / nt;
    std::vector<std::vector<char>> bufs(nt);
    std::vector<int64_t> lens(nt, 0);
#pragma omp parallel num_threads(nt)
    {
      const int tid = omp_get_thread_num();
      const int64_t r0 = tid * per;
      const int64_t r1 = (r0 + per < n_reads) ? r0 + per : n_reads;
      if (r0 < n_reads) {
        const int64_t rows_here = row_start[r1] - row_start[r0];
        bufs[tid].resize((size_t)(rows_here + (r1 - r0)) * 256 + 64);
        char* p = bufs[tid].data();
        for (int64_t r = r0; r < r1; ++r) {
          if (flags[r] & 1) continue;
          p = emit_read(r, p);
        }
        lens[tid] = p - bufs[tid].data();
      }
    }
    char* p = buf;
    for (int tid = 0; tid < nt; ++tid) {
      std::memcpy(p, bufs[tid].data(), lens[tid]);
      p += lens[tid];
    }
    return p - buf;
  }
#endif
  char* p = buf;
  for (int64_t r = 0; r < n_reads; ++r) {
    if (flags[r] & 1) continue;
    p = emit_read(r, p);
  }
  return p - buf;
}

}  // extern "C"
