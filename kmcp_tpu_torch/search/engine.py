"""Batched object search engine: query reads vs bit-sliced Bloom DBs.

The port's copy of kmcp_tpu/search/engine.py.  Given a torch device, a
block counts with ``TorchBlockCounter`` (search/kernel.py: K2' on a CUDA
device, its plain version on the CPU), the counterpart of the JAX
package's ``backend="jax"``.  With ``SearchOptions.backend == "host"``
(and no device) it counts with the C++ counter on the host, the JAX
package's ``--backend host`` (``Block._counts_host``), and under
``--low-mem`` reads only the Bloom rows a batch gathers from the block
files (``Block._counts_low_mem``, row seek); on a device ``--low-mem`` is
ignored with a warning, as on the JAX backend.  With neither, the NumPy
counter counts: the tests' oracle.  It opens DBs, its own
layout or the reference's ``.kmcp`` layout (index/uniki.py), for the
streamer, searches the reads the streamer hands over (those with more
k-mers than the dedup threshold), and runs every search the streamer does
not take (search/stream.py ``usable``).

  reads -> k-mer hash batches (padded [B, Kmax]) -> per-block counts
        -> vectorized thresholding -> sparse match extraction -> rows

Semantics, as in the reference:
- query k-mers are deduplicated only when more than
  ``kmer_dedup_threshold`` (256) k-mers; qCov denominators therefore count
  duplicate k-mers for short reads
- paired-end mates hash into one k-mer set
- fewer than ``min_kmers`` k-mers aborts the query with no retries
- multi-k fallback: ks tried descending, retry with smaller k on no match
- ``try_se``: paired query with no hits retried as read1-only then read2
- thresholds: count >= min_kmers, count > qKmers*min_query_cov (strict),
  tCov >= min_target_cov, Theorem-2 query FPR <= max_fpr
- sorting: qcov desc (tie tcov desc) / tcov / jacc (tie mKmers desc)
- ``keep_top_scores``: keep the first N distinct score groups, plus the
  first element of group N+1 when truncation happens mid-scan
- multi-DB AND-intersection keyed by (target, chunkIdx): keeps the first
  DB's match but takes qCov/tCov/jacc from the DB with fewer matched
  k-mers; NumKmers/FPR keep the first DB's values
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import numpy as np

from ..index.format import (
    BlockRowReader,
    read_block_bits,
    read_block_meta,
    read_db_info,
)
from ..index.uniki import DB_YML, load_ref_db
from ..kmer import native
from ..kmer.nthash import hash_reads_batch
from ..kmer.sketches import generate_kmers, max_hash_for_scale, unique_sorted
from .fpr import QueryFPRCache
from .kernel import TorchBlockCounter, count_matches_numpy

# Bytes of the NumPy counter's bit-unpacked intermediate per call: reads
# over the dedup threshold on a wide DB count in chunks of reads.
COUNT_CHUNK_BYTES = 1 << 28


@dataclass
class SearchOptions:
    min_query_len: int = 30
    min_kmers: int = 10
    min_query_cov: float = 0.55
    min_target_cov: float = 0.0
    max_fpr: float = 0.01
    kmer_dedup_threshold: int = 256
    sort_by: str = "qcov"  # qcov | tcov | jacc
    do_not_sort: bool = False
    keep_top_scores: int = 0
    try_se: bool = False
    keep_unmatched: bool = False
    name_map: dict[str, str] = field(default_factory=dict)
    load_default_name_map: bool = False
    backend: str = "numpy"  # numpy (a torch device or NumPy) | host (C++)
    batch_size: int = 8192
    paired_fpr_buf: bool = False
    load_whole_db: bool = False  # read index into RAM instead of mmap
    low_mem: bool = False  # host backend: row seek; ignored on a device


@dataclass
class Match:
    target: str
    chunk_idx: int
    chunks: int
    gsize: int
    num_kmers: int
    fpr: float
    qcov: float
    tcov: float
    jacc: float


@dataclass
class QueryResult:
    query_idx: int
    query_id: str
    query_len: int
    num_kmers: int
    k: int
    matches: list[Match]


class Block:
    """One block's metadata and bits; ``device`` (a torch device, or None)
    is where it counts.  Without a device, ``host`` counts with the C++
    counter and ``low_mem`` then seeks the rows from the block file."""

    def __init__(self, db_dir: str, block_id: int, load_whole: bool = False,
                 device=None, host: bool = False, low_mem: bool = False):
        self.meta = read_block_meta(db_dir, block_id)
        self.low_mem = host and low_mem
        if self.low_mem:
            # row seek: the matrix is never mapped, only the rows each
            # batch gathers are read (util-db-search.go:6975-7176)
            self.bits = None
            self.rows = BlockRowReader(db_dir, block_id)
        else:
            self.bits = read_block_bits(db_dir, block_id, mmap=not load_whole)
        self.sizes = np.asarray(self.meta.sizes, dtype=np.float64)
        self.device = device
        self.host = host
        self._counter = None
        self._bits_ext = None

    @classmethod
    def from_arrays(cls, meta, bits: np.ndarray, device=None,
                    host: bool = False) -> "Block":
        """Block over an in-memory matrix (reference-layout DBs load
        through the .uniki converter, index/uniki.py)."""
        self = cls.__new__(cls)
        self.meta = meta
        self.low_mem = False
        self.bits = bits
        self.sizes = np.asarray(meta.sizes, dtype=np.float64)
        self.device = device
        self.host = host
        self._counter = None
        self._bits_ext = None
        return self

    def counts(self, hashes, mask, num_hashes) -> np.ndarray:
        """[B, num_targets] int32 counts: on the block's device, with the
        C++ counter, or with the NumPy counter in chunks of reads whose
        unpacked bits stay near COUNT_CHUNK_BYTES."""
        if self.device is not None:
            if self._counter is None:
                self._counter = TorchBlockCounter(
                    np.ascontiguousarray(self.bits), num_hashes, self.device
                )
            c = self._counter(hashes, mask)
        elif self.low_mem:
            c = self._counts_low_mem(hashes, mask, num_hashes)
        elif self.host:
            c = self._counts_host(hashes, mask, num_hashes)
        else:
            B, K = hashes.shape
            T = self.bits.shape[1] * 32
            step = max(1, COUNT_CHUNK_BYTES // max(1, K * T))
            parts = [
                count_matches_numpy(self.bits, hashes[lo:lo + step],
                                    mask[lo:lo + step], num_hashes)
                for lo in range(0, B, step)
            ]
            c = np.concatenate(parts) if parts else np.zeros((0, T),
                                                             np.int32)
        return c[:, : self.meta.num_targets]

    def _counts_host(self, hashes, mask, num_hashes) -> np.ndarray:
        """Bloom locations (``kt_locations``) counted by ``kt_count_block``
        against the matrix with a zero sentinel row appended, where the
        masked windows point (JAX engine.py:149-164)."""
        if self._bits_ext is None:
            b = np.ascontiguousarray(self.bits)
            self._bits_ext = np.concatenate(
                [b, np.zeros((1, b.shape[1]), np.uint32)], axis=0
            )
        S = self.meta.num_sigs
        loc = native.locations(hashes, num_hashes, S)
        loc[~mask] = S
        return native.count_block(self._bits_ext, loc, num_hashes)

    def _counts_low_mem(self, hashes, mask, num_hashes) -> np.ndarray:
        """Gather only the batch's unique Bloom rows from disk, then count
        against the small [n_unique(+1), W] matrix with remapped
        locations: the resident counter's counts (JAX engine.py:166-198)."""
        S = self.meta.num_sigs
        loc = native.locations(hashes, num_hashes, S)
        loc = np.where(mask[..., None], loc, np.int64(S))
        uniq, inv = np.unique(loc, return_inverse=True)
        n_real = len(uniq) - 1 if len(uniq) and uniq[-1] == S else len(uniq)
        small = self.rows.gather(uniq[:n_real])
        small_ext = np.concatenate(
            [small, np.zeros((1, small.shape[1]), np.uint32)], axis=0
        )  # sentinel row at index n_real (where S sorted, if present)
        loc_small = inv.reshape(loc.shape).astype(np.int32)
        return native.count_block(small_ext, loc_small, num_hashes)


class SearchDB:
    """One database directory: the port's layout (db.json) or the
    reference's (__db.yml + _blockNNN.uniki)."""

    def __init__(self, db_dir: str, opt: SearchOptions, device=None):
        self.path = db_dir
        self.opt = opt
        host = opt.backend == "host"
        if os.path.isfile(os.path.join(db_dir, DB_YML)):
            self.info, ref_blocks = load_ref_db(db_dir)
            self.blocks = [Block.from_arrays(m, b, device, host)
                           for m, b in ref_blocks]
        else:
            self.info = read_db_info(db_dir)
            self.blocks = [
                Block(db_dir, i, opt.load_whole_db, device, host,
                      opt.low_mem)
                for i in range(len(self.info.blocks))
            ]
        buf = 499 if opt.paired_fpr_buf else 249
        self.query_fpr = QueryFPRCache(self.info.fpr, buf)
        self.ks_desc = sorted(self.info.ks, reverse=True)
        self.is_sketch = self.info.minimizer or self.info.syncmer
        self.max_hash = (
            int(max_hash_for_scale(self.info.scale)) if self.info.scaled else None
        )

    def generate_query_kmers(self, seq: bytes, k: int) -> np.ndarray:
        info = self.info
        return generate_kmers(
            seq,
            k,
            canonical=info.canonical,
            circular=False,
            scale=info.scale if info.scaled else 1,
            minimizer_w=info.minimizer_w if info.minimizer else 0,
            syncmer_s=info.syncmer_s if info.syncmer else 0,
        )


def _merge_mate_rows(H, M, counts, paired_rows):
    """Collapse consecutive mate-pair rows (r, r+1) of a hash batch into
    single combined rows (both mates hash into one k-mer set)."""
    out_rows = []
    r = 0
    for p in paired_rows:
        out_rows.append((r, r + 1) if p else (r,))
        r += 2 if p else 1
    B = len(out_rows)
    new_counts = np.array(
        [sum(int(counts[i]) for i in rows) for rows in out_rows], dtype=np.int64
    )
    kmax = max(int(new_counts.max()) if B else 0, 1)
    H2 = np.zeros((B, kmax), dtype=np.uint64)
    M2 = np.zeros((B, kmax), dtype=bool)
    for b, rows in enumerate(out_rows):
        off = 0
        for i in rows:
            n = int(counts[i])
            H2[b, off : off + n] = H[i, :n]
            M2[b, off : off + n] = True
            off += n
    return H2, M2, new_counts


def _sort_matches(matches: list[Match], sort_by: str):
    if sort_by == "qcov":
        return sorted(matches, key=lambda m: (-m.qcov, -m.tcov))
    if sort_by == "tcov":
        return sorted(matches, key=lambda m: (-m.tcov, -m.num_kmers))
    if sort_by == "jacc":
        return sorted(matches, key=lambda m: (-m.jacc, -m.num_kmers))
    raise ValueError(sort_by)


def _score(m: Match, sort_by: str) -> float:
    return {"qcov": m.qcov, "tcov": m.tcov, "jacc": m.jacc}[sort_by]


def _top_n_scores(matches: list[Match], n: int, sort_by: str) -> list[Match]:
    """The reference's truncation loop (including keeping the first element
    of the (n+1)-th distinct score group on break)."""
    if n <= 0 or not matches:
        return matches
    count = 0
    p_score = 1024.0
    i = 0
    for i, m in enumerate(matches):
        s = _score(m, sort_by)
        if s < p_score:
            count += 1
            if count > n:
                break
            p_score = s
    return matches[: i + 1]


class SearchEngine:
    """Multi-database batched search; ``device`` (a torch device) is where
    the blocks count; without one they count with the C++ counter when
    ``opt.backend`` is "host", else with the NumPy counter."""

    def __init__(self, db_dirs: list[str], opt: SearchOptions, device=None):
        self.opt = opt
        if opt.backend not in ("numpy", "host"):
            raise ValueError(f"backend must be numpy or host, got "
                             f"{opt.backend!r}")
        if opt.backend == "host" and device is not None:
            raise ValueError("the host backend counts on the host: give no "
                             "torch device")
        if opt.low_mem and device is not None:
            # the blocks live in device memory, so row seek cannot apply:
            # say so rather than drop the flag silently
            print(
                "[search] warning: --low-mem is ignored on a torch device "
                "(index blocks are materialized in device memory); use "
                "--backend host for row-seek mode",
                file=sys.stderr,
            )
        self.dbs = [SearchDB(d, opt, device) for d in db_dirs]
        for db in self.dbs:
            if opt.min_query_cov <= db.info.fpr:
                raise SystemExit(
                    f"min-query-cov ({opt.min_query_cov}) must be > "
                    f"single-filter FPR of the database ({db.info.fpr})"
                )

    # ---------------------------------------------------------------- batch

    def search_batch(
        self,
        queries: list[tuple[str, bytes, bytes | None]],
        start_idx: int = 0,
    ) -> list[QueryResult]:
        """Search a batch of (id, seq, seq2-or-None) queries, in order."""
        opt = self.opt
        per_db = []
        meta: list[tuple[int, int, int]] = []
        for db_i, db in enumerate(self.dbs):
            db_res, db_meta = self._search_batch_one_db(db, queries)
            per_db.append(db_res)
            if db_i == 0:
                meta = db_meta

        results: list[QueryResult] = []
        for qi, (qid, seq, seq2) in enumerate(queries):
            qlen, nkmers, k = meta[qi]
            if len(self.dbs) == 1:
                matches = per_db[0][qi]
            else:
                matches = self._intersect_dbs([d[qi] for d in per_db])
            matches = matches or []
            if matches:
                if not opt.do_not_sort:
                    matches = _sort_matches(matches, opt.sort_by)
                    matches = _top_n_scores(
                        matches, opt.keep_top_scores, opt.sort_by
                    )
                if opt.name_map:
                    for m in matches:
                        if m.target in opt.name_map:
                            m.target = opt.name_map[m.target]
            results.append(
                QueryResult(
                    query_idx=start_idx + qi,
                    query_id=qid,
                    query_len=qlen,
                    num_kmers=nkmers,
                    k=k,
                    matches=matches,
                )
            )
        return results

    # ------------------------------------------------------------- one db

    def _search_batch_one_db(self, db: SearchDB, queries):
        """Multi-k fallback + try-se retries, batched per attempt round."""
        opt = self.opt
        n = len(queries)
        out: list[list[Match] | None] = [None] * n
        meta: list[tuple[int, int, int] | None] = [None] * n
        done = [False] * n

        ks = db.ks_desc
        plans: list[list[tuple[int, int]]] = []
        for qi, (qid, seq, seq2) in enumerate(queries):
            plan = []
            for k in ks:
                plan.append((k, 0))
                if opt.try_se and seq2 is not None:
                    plan.append((k, 1))
                    plan.append((k, 2))
            plans.append(plan)
        attempts = [0] * n
        pending = list(range(n))

        while pending:
            round_fast: list[tuple[int, int, int]] = []  # (qi, mode, k)
            round_slow: list[tuple[int, np.ndarray, int, int]] = []
            next_pending: list[int] = []

            for qi in pending:
                qid, seq, seq2 = queries[qi]
                plan = plans[qi]
                ai = attempts[qi]
                if ai >= len(plan):
                    continue
                k, mode = plan[ai]
                if mode == 0 and len(seq) < opt.min_query_len and not (
                    seq2 is not None and len(seq2) >= opt.min_query_len
                ):
                    # too short: empty result, no retry
                    meta[qi] = (len(seq) + (len(seq2) if seq2 else 0), 0, k)
                    done[qi] = True
                    continue
                if not db.is_sketch:
                    round_fast.append((qi, mode, k))
                else:
                    if mode == 0:
                        km = db.generate_query_kmers(seq, k)
                        if seq2 is not None:
                            km = np.concatenate(
                                [km, db.generate_query_kmers(seq2, k)]
                            )
                        qlen = len(seq) + (len(seq2) if seq2 else 0)
                    elif mode == 1:
                        km = db.generate_query_kmers(seq, k)
                        qlen = len(seq)
                    else:
                        km = db.generate_query_kmers(seq2, k)
                        qlen = len(seq2)
                    if len(km) > opt.kmer_dedup_threshold:
                        km = unique_sorted(km)
                    meta[qi] = (qlen, len(km), k)
                    if len(km) < opt.min_kmers:
                        done[qi] = True
                        continue
                    round_slow.append((qi, km, qlen, k))

            # -------- fast path: one vectorized hash pass per (k, mode),
            # padded matrices flow straight into the counter
            round_batches: list[tuple[list[int], np.ndarray, np.ndarray, np.ndarray]] = []
            round_qis: list[int] = []
            by_km: dict[tuple[int, int], list[int]] = {}
            for qi, mode, k in round_fast:
                by_km.setdefault((k, mode), []).append(qi)
            for (k, mode), qis in by_km.items():
                seq_lists: list[bytes] = []
                paired_rows = []
                for qi in qis:
                    _qid, seq, seq2 = queries[qi]
                    if mode == 0:
                        seq_lists.append(seq)
                        if seq2 is not None:
                            seq_lists.append(seq2)
                            paired_rows.append(True)
                        else:
                            paired_rows.append(False)
                    elif mode == 1:
                        seq_lists.append(seq)
                        paired_rows.append(False)
                    else:
                        seq_lists.append(seq2)
                        paired_rows.append(False)
                H, M, counts = hash_reads_batch(
                    seq_lists, k, canonical=db.info.canonical,
                    max_hash=db.max_hash,
                )
                if any(paired_rows):
                    H, M, counts = _merge_mate_rows(H, M, counts, paired_rows)
                keep_qis: list[int] = []
                keep_rows: list[int] = []
                for r, qi in enumerate(qis):
                    _qid, seq, seq2 = queries[qi]
                    qlen = (
                        len(seq) + (len(seq2) if seq2 is not None else 0)
                        if mode == 0
                        else (len(seq) if mode == 1 else len(seq2))
                    )
                    nk = int(counts[r])
                    if nk > opt.kmer_dedup_threshold:
                        km = unique_sorted(H[r][M[r]])
                        meta[qi] = (qlen, len(km), k)
                        if len(km) < opt.min_kmers:
                            done[qi] = True
                        else:
                            round_slow.append((qi, km, qlen, k))
                        continue
                    meta[qi] = (qlen, nk, k)
                    if nk < opt.min_kmers:
                        done[qi] = True
                        continue
                    keep_qis.append(qi)
                    keep_rows.append(r)
                if keep_rows:
                    round_batches.append(
                        (keep_qis, H[keep_rows], M[keep_rows],
                         counts[keep_rows])
                    )
                    round_qis.extend(keep_qis)

            if round_slow:
                qis = [it[0] for it in round_slow]
                kmax = max(len(it[1]) for it in round_slow)
                Hs = np.zeros((len(round_slow), kmax), dtype=np.uint64)
                Ms = np.zeros((len(round_slow), kmax), dtype=bool)
                cs = np.empty(len(round_slow), dtype=np.int64)
                for r, (_qi, km, _qlen, _k) in enumerate(round_slow):
                    Hs[r, : len(km)] = km
                    Ms[r, : len(km)] = True
                    cs[r] = len(km)
                round_batches.append((qis, Hs, Ms, cs))
                round_qis.extend(qis)

            if round_batches:
                round_out: dict[int, list[Match]] = {}
                for qis, H, M, counts in round_batches:
                    self._count_round(db, qis, H, M, counts, round_out)
                for qi, matches in round_out.items():
                    if out[qi] is None:
                        out[qi] = matches
                for qi in round_qis:
                    if out[qi] or done[qi]:
                        continue
                    attempts[qi] += 1
                    if attempts[qi] < len(plans[qi]):
                        next_pending.append(qi)
            pending = next_pending

        for qi in range(n):
            if meta[qi] is None:
                qid, seq, seq2 = queries[qi]
                meta[qi] = (len(seq) + (len(seq2) if seq2 else 0), 0, ks[0])
        return out, meta

    def _count_round(self, db, qis, H, M, nkmers, round_out) -> None:
        """Count padded batches, threshold, extract."""
        bs = self.opt.batch_size
        for lo in range(0, len(qis), bs):
            hi = min(lo + bs, len(qis))
            for block in db.blocks:
                counts = block.counts(H[lo:hi], M[lo:hi], db.info.num_hashes)
                self._extract_matches(
                    db, block, counts, nkmers[lo:hi], qis[lo:hi], round_out
                )

    def _extract_matches(self, db, block, counts, nkmers, qis, round_out):
        opt = self.opt
        sizes = block.sizes
        # count >= min_kmers and count > n * min_query_cov, as one integer
        # floor a row: the least integer c with float(c) > n * min_query_cov
        # is floor(n * min_query_cov) + 1; the float64 tCov test then runs
        # on those candidates only, not on every (read, target)
        lo = np.floor(np.asarray(nkmers, dtype=np.float64)
                      * opt.min_query_cov) + 1
        lo = np.clip(np.maximum(lo, opt.min_kmers), None, 2**31 - 1)
        rows, cols = np.nonzero(counts >= lo.astype(np.int32)[:, None])
        tcov_ok = (counts[rows, cols].astype(np.float64) / sizes[cols]
                   >= opt.min_target_cov)
        rows, cols = rows[tcov_ok], cols[tcov_ok]
        if len(rows) == 0:
            return
        bmeta = block.meta
        for r, t in zip(rows.tolist(), cols.tolist()):
            qi = qis[r]
            n = int(nkmers[r])
            cnt = int(counts[r, t])
            fpr_v = db.query_fpr(n, cnt)
            if fpr_v > opt.max_fpr:
                continue
            tsize = sizes[t]
            m = Match(
                target=bmeta.names[t],
                chunk_idx=bmeta.indices[t] & 0xFFFF,
                chunks=bmeta.indices[t] >> 16,
                gsize=bmeta.gsizes[t],
                num_kmers=cnt,
                fpr=fpr_v,
                qcov=cnt / n,
                tcov=cnt / tsize,
                jacc=cnt / (n + tsize - cnt),
            )
            round_out.setdefault(qi, []).append(m)

    # ---------------------------------------------------------- multi-db

    @staticmethod
    def _intersect_dbs(per_db: list[list[Match] | None]) -> list[Match] | None:
        """AND-intersection across databases."""
        if any(m is None for m in per_db):
            return None
        first = per_db[0]
        acc: dict[tuple[str, int], Match] = {}
        for m in first:
            acc[(m.target, m.chunk_idx)] = Match(**vars(m))
        for other in per_db[1:]:
            shared = set()
            for m in other:
                key = (m.target, m.chunk_idx)
                if key in acc:
                    m0 = acc[key]
                    if m.num_kmers < m0.num_kmers:
                        m0.qcov = m.qcov
                        m0.tcov = m.tcov
                        m0.jacc = m.jacc
                    shared.add(key)
            acc = {k: v for k, v in acc.items() if k in shared}
            if not acc:
                return None
        return list(acc.values())
