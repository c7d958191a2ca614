"""Streaming search of single-end reads or read pairs, on a torch device or
on the host.

Port of kmcp_tpu/search/stream.py ``StreamSearcher`` (``__init__``,
``usable``, ``run``; :132-637), with the port's own copies of its helpers
``_host_pool`` (:31), ``_unpack_result`` (:65), ``_pack_reads_matrix``
(:104), ``_fmt_ratio_memo`` (:118) and its writers ``_write_native``
(:641) and ``_write_python`` (:699).  The batching, padding, ``lmax``
rounding, candidate budgets, 4x overflow retry, ``lexsort`` order and the
row bytes are the JAX streamer's.  It has three routes:

- on the device (the default): reads ship as ASCII rows, K1' hashes them
  (search/hash_loc.py) and the dense tail (one block, after window
  selection on a sketch DB) or the two-pass screened tail (a multi-block
  ``--block-screen --uniform-sigs`` DB) counts them;
- host hashing on the device (``KMCP_TPU_DEVICE_HASH`` set to anything but
  "1" or "scan", stream.py:325-346, :487-499): the host's C++ hashes a
  batch to Bloom locations (``native.hash_reads_loc``) straight into
  pinned memory, they go up without blocking, and K2' counts them
  (``TorchDeviceDB.search_async``); one-block plain k-mer DBs only.  JAX's
  "scan" is its XLA hash step, which the port does not have: here "scan"
  hashes with K1' as "1" does;
- the host backend (``SearchOptions.backend == "host"``): ``HostDB``
  (search/device.py) hashes and counts each batch with the C++ on one
  worker thread, so the next batch's hash and count overlap this batch's
  writer (the C++ releases the GIL).

Batches are in flight as in the JAX streamer (:617-637): ``_flush``
(``flush_batch``, :348-500) dispatches a batch without waiting for it;
once ``in_flight`` batches (4 on the device, 2 on the host) are pending,
``_drain`` (``drain``, :502-611) takes the oldest: it waits for its result,
re-runs the batch with 4x the budget on a candidate overflow
(synchronously, as there), searches its slow rows, orders and writes its
rows.  Batches drain in order, so the TSV is the same bytes at every
depth.

Single-end reads over the k-mer dedup threshold take the object engine,
as in the JAX streamer (stream.py:565-584), on the same device or
counter; they are counted in ``slow_rows``.  Read pairs hash as one
joined row ``seq1 + N + seq2`` (the N resets the rolling window, so the
row's k-mers are both mates'; stream.py:352-373, util-db-search.go:
800-805).  Rows over the threshold are uniqued where the route can (on the
device, search/dedup.py; in the host hash kernel) and take the object
engine where it cannot (host hashing on the device; paired sketch mates,
which hash as separate rows on the host backend).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from collections import deque
from itertools import islice

import numpy as np
import torch

from ..kmer import native
from .device import HostDB, TorchDeviceDB, screen_off, two_pass_ready
from .engine import QueryResult, SearchEngine
from .tsv import write_results

MIN_BATCH = 16384  # the smallest batch the streamer sends (stream.py:295)
# candidate slots a batch starts with, per read of the batch size
# (stream.py:386-390); a test may set a fraction to force the 4x retry
SLOTS_PER_READ = 2
HOST_SLOTS_PER_READ = 3  # the host backend's (stream.py:386-388)

_HOST_POOL = None


def _host_pool() -> cf.ThreadPoolExecutor:
    """The host backend's one worker thread: batches hash and count on it
    one at a time, never two batches' C++ at once (stream.py:31-40)."""
    global _HOST_POOL
    if _HOST_POOL is None:
        _HOST_POOL = cf.ThreadPoolExecutor(max_workers=1)
    return _HOST_POOL


def host_hash() -> bool:
    """True when the device route hashes reads on the host:
    ``KMCP_TPU_DEVICE_HASH`` is set to anything but "1" or "scan"
    (stream.py:325, :346)."""
    return os.environ.get("KMCP_TPU_DEVICE_HASH", "1") not in ("1", "scan")


def _unpack_result(res, budget, nb, T):
    """A search step's result -> (n_cand, qi, t, cnt, nk).  Device steps
    give (meta int32, aux uint16) host arrays: meta is [n, read_idx...,
    target_idx...] of 1 + 2*budget ints (split ids, the screened tail) or
    [n, flat_idx...] of 1 + budget (flat ids qi*T + t, the dense tail); aux
    is [budget + nb] = counts then per-read k-mer counts.  The host backend
    gives one int64 array [n, flat_idx[budget], counts[budget],
    nkmers[nb]] (stream.py:91-101).  On budget overflow returns (n_cand,
    None, ...): the caller retries with a larger budget."""
    if isinstance(res, np.ndarray):
        n = int(res[0])
        if n > budget:
            return n, None, None, None, None
        idx = res[1 : 1 + n]
        cnt = res[1 + budget : 1 + budget + n]
        nk = res[1 + 2 * budget : 1 + 2 * budget + nb]
        return n, idx // T, idx % T, cnt, nk
    meta, aux = res
    n = int(meta[0])
    if n > budget:
        return n, None, None, None, None
    cnt = aux[:n].astype(np.int64)
    nk = aux[budget : budget + nb].astype(np.int64)
    if meta.shape[0] >= 1 + 2 * budget:
        return n, meta[1 : 1 + n], meta[1 + budget : 1 + budget + n], cnt, nk
    idx = meta[1 : 1 + n]
    return n, idx // T, idx % T, cnt, nk


def _pack_reads_matrix(seqs, lens, lmax, out=None):
    """Zero-padded row-major [B, lmax] uint8 read matrix, into ``out``
    (e.g. pinned memory) when given."""
    return native.pack_rows(seqs, lens, lmax, out)


def _fmt_ratio_memo():
    memo: dict[tuple[int, int], str] = {}

    def fmt(a: int, b: int) -> str:
        key = (a, b)
        s = memo.get(key)
        if s is None:
            s = f"{a / b:.4f}"
            memo[key] = s
        return s

    return fmt


NOT_STREAMED = ("the streamer does not take this search (stream.usable); "
                "run_search sends it to the object engine")


def usable(engine: SearchEngine, paired: bool = False) -> bool:
    """True when the streamer takes this search; every other search runs
    on the object engine.  The JAX streamer's gates (kmcp_tpu/search/
    stream.py:195-280) for ``engine.opt.backend``: the host backend
    streams every sketch DB, multi-block DBs, pairs and non-canonical
    DBs; the device streams a one-block DB (a plain one, or a sketch DB
    single-end, syncmers with s < k, under ``KMCP_TPU_DEVICE_HASH`` "1")
    or a multi-block ``--block-screen --uniform-sigs`` DB with its
    screens on (``screen_off``) under "1", canonical (K1' hashes
    canonically; ROADMAP C) within the uint16 aux layout; with host
    hashing (``host_hash``) one-block plain k-mer DBs only, of either
    strand mode (the host hash honours the flag)."""
    opt = engine.opt
    if len(engine.dbs) != 1:
        return False
    db = engine.dbs[0]
    if opt.low_mem or opt.sort_by != "qcov" or opt.do_not_sort:
        return False
    if paired and opt.try_se:
        return False
    if opt.backend == "host":
        return True
    if opt.kmer_dedup_threshold >= 65535:  # the uint16 aux layout
        return False
    one_block = (len(db.blocks) == 1
                 # the dense tail's int32 flat candidate ids need
                 # B*T <= 2^31 with B >= 256
                 and db.blocks[0].bits.shape[1] * 32 <= 2**31 // 256)
    if host_hash():
        return one_block and not db.is_sketch
    if not db.info.canonical:
        return False
    # window selection and the screened tail need K1' hashing: kmcp_tpu's
    # streamer declines both under "scan" too (stream.py:221, :256)
    k1_hash = os.environ.get("KMCP_TPU_DEVICE_HASH", "1") == "1"
    if db.is_sketch:
        # window selection runs on the dense tail of single-end rows
        # (device.py ``_sketch_locations``): a paired row would select
        # across the mate junction
        if paired or len(db.blocks) != 1 or not k1_hash:
            return False
        if db.info.syncmer and db.info.syncmer_s >= max(db.info.ks):
            return False
    if len(db.blocks) == 1:
        return one_block
    # the screened tail needs the union screens on (stream.py:258)
    return two_pass_ready(db) and not screen_off() and k1_hash


class TorchStreamSearcher:
    """``pass2`` picks the screened tail's pass-2 kernel of a multi-block
    DB (TorchDeviceDB); ``in_flight`` is the number of batches dispatched
    before the oldest is drained (None: the JAX streamer's 4 on the
    device, 2 on the host backend).  ``engine.opt.backend`` "host" streams
    on ``HostDB`` and ignores ``device``."""

    def __init__(self, engine: SearchEngine, device="cuda",
                 pass2: str = "auto", in_flight: int | None = None):
        if not usable(engine):
            raise ValueError(NOT_STREAMED)
        self.engine = engine
        self.opt = engine.opt
        self.db = engine.dbs[0]
        self.host = self.opt.backend == "host"
        if in_flight is None:
            in_flight = 2 if self.host else 4
        if in_flight < 1:
            raise ValueError(f"in_flight must be >= 1, got {in_flight}")
        self.in_flight = in_flight
        # reads hashed on the host and counted by K2' (A15)
        self.host_hash = not self.host and host_hash()
        self.dev = (HostDB(self.db, self.opt) if self.host else
                    TorchDeviceDB(self.db, self.opt, device, pass2))
        self.k = self.db.ks_desc[0]
        self.multi_k = len(self.db.ks_desc) > 1
        self._fpr_tabs: dict[int, dict] = {}
        self._tmeta_tab = None
        self._tname_tab = None
        self.slow_rows = 0  # reads searched by the object engine
        self.retries = 0  # 4x-budget re-runs after a candidate overflow

    def batch_size(self) -> int:
        """Reads a batch: at least MIN_BATCH; on the device a multiple of
        256 with the dense tail's int32 flat ids b*T + t capping it at
        B*T <= 2^31 (the screened tail's split ids do not), as in the JAX
        streamer (stream.py:294-303)."""
        batch_size = max(self.opt.batch_size, MIN_BATCH)
        if self.host:
            return batch_size
        if self.dev.n_blocks == 1:
            batch_size = min(batch_size, (2**31) // self.dev.t_per_block)
        return max(batch_size // 256 * 256, 256)

    def run(self, queries, out, start_idx: int = 0, paired: bool = False,
            progress=None) -> tuple[int, int]:
        """queries: iterator of (id, seq, None), or with ``paired`` of (id,
        seq1, seq2) (seq2 may be empty).  Returns (total, matched).

        Batches are flushed as they fill; once ``in_flight`` are pending
        the oldest is drained (its result waited for, retried, ordered and
        written), in order, so idx0, the totals and ``progress`` advance in
        drain order (stream.py:617-637)."""
        if not usable(self.engine, paired):
            raise ValueError(NOT_STREAMED)
        batch_size = self.batch_size()
        fmt = (_fmt_ratio_memo(), _fmt_ratio_memo(), {})
        total = matched = 0
        pending: deque = deque()

        def drain():
            nonlocal total, matched
            state = pending.popleft()
            matched += self._drain(state, out, fmt)
            total += state["real_b"]
            if progress is not None:
                progress(total)

        idx0 = start_idx
        it = iter(queries)
        while True:
            batch = list(islice(it, batch_size))
            if not batch:
                break
            pending.append(self._flush(batch, batch_size, idx0, paired))
            idx0 += len(batch)
            if len(pending) >= self.in_flight:
                drain()
        while pending:
            drain()
        return total, matched

    def _flush(self, batch, batch_size, idx0, paired=False) -> dict:
        """Dispatch one batch's search without waiting for it
        (``flush_batch``, stream.py:348-500).  With ``paired`` each (id,
        seq1, seq2) hashes as one joined row; the TSV's qLen is len1 +
        len2, and the min-length filter reads max(len1, len2)
        (stream.py:352-373, :461-467).  The state holds what the drain
        reads: ``pending`` (whose ``result()`` is the step's result),
        ``rerun`` (the search at another budget, waited for), ``counts``
        (the host's k-mer counts, or None when they come with the result)
        and ``dedup`` (whether rows over the threshold were uniqued, or
        are slow rows)."""
        B = len(batch)
        if paired:
            seqs = [q[1] + b"N" + q[2] if q[2] else q[1] for q in batch]
            qlen = np.array([len(q[1]) + len(q[2] or b"") for q in batch],
                            dtype=np.int64)
            eff = np.zeros(batch_size, dtype=np.int64)
            eff[:B] = [max(len(q[1]), len(q[2] or b"")) for q in batch]
        else:
            seqs = [q[1] for q in batch]
        # pad to the fixed batch size (empty reads hit only the sentinel)
        seqs = seqs + [b""] * (batch_size - B)
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        if not paired:
            qlen = lens[:B]
            eff = lens
        lmax = max(-(-int(lens.max()) // 32) * 32, self.k + 31)
        state = {"batch": batch, "real_b": B, "idx0": idx0, "qlen": qlen,
                 "eff": eff, "counts": None}
        if self.host:
            self._flush_host(state, seqs, lmax, batch_size, paired)
        elif self.host_hash:
            self._flush_host_hash(state, seqs, lens, lmax)
        else:
            self._flush_device(state, seqs, lens, lmax, paired)
        return state

    def _flush_device(self, state, seqs, lens, lmax, paired):
        """The rows go up from a pinned buffer without blocking, K1' and
        the tail are enqueued, and the result comes back behind an event
        (``TorchDeviceDB.search_reads_async``).  The state keeps the
        pinned buffer and the reads on the card until the drain, for the
        copy and for a retry."""
        dev = self.dev
        B = len(seqs)
        host = torch.empty((B, lmax), dtype=torch.uint8,
                           pin_memory=dev.device.type == "cuda")
        _pack_reads_matrix(seqs, lens, lmax, host.numpy())
        reads = host.to(dev.device, non_blocking=True)
        eff = state["eff"]
        budget = max(1, int(SLOTS_PER_READ * B))
        state.update(
            budget=budget, dedup=paired, host_reads=host, reads=reads,
            pending=dev.search_reads_async(reads, eff, budget, paired),
            rerun=lambda b: dev.search_reads(reads, eff, b, paired))

    def _flush_host_hash(self, state, seqs, lens, lmax):
        """A15: the C++ hashes the batch to Bloom locations straight into
        pinned memory (stream.py:487-499); reads too short or over the
        dedup threshold search with 0 k-mers, the locations go up without
        blocking and K2' counts them (``TorchDeviceDB.search_async``).
        Rows over the threshold are slow rows."""
        dev, opt, info = self.dev, self.opt, self.db.info
        B = len(seqs)
        kmax = lmax - self.k + 1
        host = torch.empty((B, kmax, info.num_hashes), dtype=torch.int32,
                           pin_memory=dev.device.type == "cuda")
        _loc, counts = native.hash_reads_loc(
            seqs, self.k, kmax, dev.total_rows, info.num_hashes,
            canonical=info.canonical, max_hash=self.db.max_hash,
            out=host.numpy())
        too_short = lens < opt.min_query_len
        n_dev = np.where(too_short | (counts > opt.kmer_dedup_threshold), 0,
                         counts)
        loc = host.to(dev.device, non_blocking=True)
        budget = max(1, int(SLOTS_PER_READ * B))
        state.update(
            budget=budget, dedup=False, counts=counts, host_loc=host,
            pending=dev.search_async(loc, n_dev, budget),
            rerun=lambda b: dev.search_async(loc, n_dev, b).result())

    def _flush_host(self, state, seqs, lmax, batch_size, paired):
        """The host backend: ``HostDB.search_reads`` on the worker thread.
        Paired sketch mates hash as separate interleaved rows with no dedup
        (sketch windows must not cross the mate junction; stream.py:
        407-432); other rows over the threshold are uniqued in the hash
        kernel."""
        batch = state["batch"]
        if paired and self.db.is_sketch:
            mates = []
            for q in batch:
                mates += [q[1], q[2] or b""]
            mates += [b""] * (2 * (batch_size - len(batch)))
            kw = {"dedup_threshold": 0, "mates": mates}
        else:
            kw = {"dedup_threshold": self.opt.kmer_dedup_threshold}
        eff = state["eff"]
        search = self.dev.search_reads
        budget = max(1, int(HOST_SLOTS_PER_READ * batch_size))
        state.update(
            budget=budget, dedup=bool(kw["dedup_threshold"]),
            pending=_host_pool().submit(search, seqs, eff, lmax, budget,
                                        **kw),
            rerun=lambda b: _host_pool().submit(search, seqs, eff, lmax, b,
                                                **kw).result())

    def _drain(self, state, out, fmt) -> int:
        """Wait for a batch's result, retry it on a candidate overflow,
        search its slow rows on the object engine, order and write its rows
        (``drain``, stream.py:502-611); returns its matched reads."""
        opt = self.opt
        dev = self.dev
        batch, B, idx0 = state["batch"], state["real_b"], state["idx0"]
        budget = state["budget"]
        nb = state["eff"].shape[0]
        T = dev.t_per_block * dev.n_blocks
        n_cand, qi, t, cnt, nk = _unpack_result(
            state["pending"].result(), budget, nb, T)
        while qi is None:  # candidate overflow: re-run with 4x the budget
            budget *= 4
            self.retries += 1
            n_cand, qi, t, cnt, nk = _unpack_result(
                state["rerun"](budget), budget, nb, T)

        counts = (nk if state["counts"] is None else state["counts"])[:B]
        rows_of = {  # what the writers read of the batch
            "ids": [q[0] for q in batch],
            "counts": counts,
            "qlen": state["qlen"],
            "too_short": state["eff"][:B] < opt.min_query_len,
        }
        # rows over the dedup threshold were uniqued, or are slow rows
        slow_rows = (np.zeros(0, dtype=np.int64) if state["dedup"] else
                     np.nonzero(counts > opt.kmer_dedup_threshold)[0])
        if self.multi_k:
            # unmatched reads retry with the DB's smaller ks
            has_match = np.zeros(B, dtype=bool)
            has_match[qi] = True
            retry = ~has_match & ~rows_of["too_short"] & (
                counts >= opt.min_kmers
            )
            slow_rows = np.union1d(slow_rows, np.nonzero(retry)[0])
        slow_set = set(slow_rows.tolist())
        slow_results: dict[int, QueryResult] = {}
        if slow_set:
            rows = sorted(slow_set)
            res = self.engine.search_batch([batch[r] for r in rows], 0)
            slow_results = dict(zip(rows, res))
            keep = ~np.isin(qi, slow_rows)
            qi, t, cnt = qi[keep], t[keep], cnt[keep]
            self.slow_rows += len(rows)

        # qi asc, qcov desc (cnt desc), tcov desc (size asc), then target:
        # a total order, whatever order the counters emitted
        order = np.lexsort((t, dev.sizes[t], -cnt, qi))
        qi, t, cnt = qi[order], t[order], cnt[order]
        hits = np.bincount(qi, minlength=B).astype(np.int32)
        matched = int((hits > 0).sum()) + sum(
            1 for r in slow_set if slow_results[r].matches
        )
        if opt.keep_top_scores <= 0:
            self._write_native(out, rows_of, qi, t, cnt, hits, slow_set,
                               slow_results, idx0)
        else:
            names = [(opt.name_map or {}).get(n, n) for n in dev.names]
            self._write_python(
                out, rows_of, qi, t, cnt, hits, slow_set, slow_results, idx0,
                *fmt, names,
                [str(int(ix) & 0xFFFF) for ix in dev.indices],
                [str(int(ix) >> 16) for ix in dev.indices],
                [str(int(g)) for g in dev.gsizes], str(self.k),
            )
        return matched

    # ---------------------------------------------------------- writers

    def _target_tabs(self):
        if self._tmeta_tab is None:
            dev = self.dev
            name_map = self.opt.name_map
            names = [
                (name_map.get(n, n) if name_map else n).encode()
                for n in dev.names
            ]
            self._tname_tab = native.make_strtab(names)
            metas = [
                (
                    f"\t{int(ix) & 0xFFFF}\t{int(ix) >> 16}\t{int(g)}\t{self.k}\t"
                ).encode()
                for ix, g in zip(dev.indices, dev.gsizes)
            ]
            self._tmeta_tab = native.make_strtab(metas)
        return self._tname_tab, self._tmeta_tab

    def _fpr_tab(self, nmax: int, pairs: np.ndarray):
        """Flat (nmax+1)^2 string table of %.4e query-FPR values, filled
        lazily for the (n, c) pairs observed in the results."""
        ent = self._fpr_tabs.get(nmax)
        if ent is None:
            ent = {
                "strings": [b""] * ((nmax + 1) * (nmax + 1)),
                "have": set(),
                "tab": None,
            }
            self._fpr_tabs[nmax] = ent
        qf = self.db.query_fpr
        have = ent["have"]
        strings = ent["strings"]
        new = False
        for p in np.unique(pairs).tolist():
            if p in have:
                continue
            have.add(p)
            n, c = divmod(p, nmax + 1)
            strings[p] = f"{qf(n, c):.4e}".encode()
            new = True
        if new or ent["tab"] is None:
            ent["tab"] = native.make_strtab(strings)
        return ent["tab"]

    def _write_native(
        self, out, state, qi, t, cnt, hits, slow_set, slow_results, idx0
    ):
        """One kt_write_rows call per run of fast reads; slow reads'
        pre-formatted rows interleave between runs."""
        B = len(state["ids"])
        flags = np.where(state["too_short"], 2, 0).astype(np.uint8)
        for r in slow_set:
            flags[r] = 1
        qlen = state["qlen"]
        nkmers = state["counts"]
        ku = self.opt.keep_unmatched
        tname_tab, tmeta_tab = self._target_tabs()
        nmax = max(64, -(-int(nkmers.max(initial=1)) // 64) * 64)
        pairs = nkmers[qi].astype(np.int64) * (nmax + 1) + cnt.astype(
            np.int64
        )
        fpr_tab = self._fpr_tab(nmax, pairs)
        qid_tab = native.make_strtab([s.encode() for s in state["ids"]])

        if not slow_set:
            data = native.write_rows(
                qi, t, cnt, qlen, nkmers, hits, flags,
                qid_tab, tname_tab, tmeta_tab,
                self.dev.sizes, fpr_tab, nmax, idx0,
                keep_unmatched=ku, k=self.k,
            )
            out.write(data.decode("utf-8", "surrogateescape"))
            return

        # segment at slow reads
        row_starts = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(hits, out=row_starts[1:])
        bounds = sorted(slow_set)
        prev = 0
        for sr in bounds + [B]:
            if sr > prev:
                r0, r1 = prev, sr
                rows_lo, rows_hi = row_starts[r0], row_starts[r1]
                sub_qid = native.make_strtab(
                    [s.encode() for s in state["ids"][r0:r1]]
                )
                data = native.write_rows(
                    qi[rows_lo:rows_hi] - r0, t[rows_lo:rows_hi],
                    cnt[rows_lo:rows_hi],
                    qlen[r0:r1], nkmers[r0:r1], hits[r0:r1],
                    flags[r0:r1] & np.uint8(2),
                    sub_qid, tname_tab, tmeta_tab,
                    self.dev.sizes, fpr_tab, nmax, idx0 + r0,
                    keep_unmatched=ku, k=self.k,
                )
                out.write(data.decode("utf-8", "surrogateescape"))
            if sr < B:
                qr = slow_results[sr]
                qr.query_idx = idx0 + sr
                write_results(out, [qr], self.opt.keep_unmatched)
            prev = sr + 1

    def _write_python(
        self, out, state, qi, t, cnt, hits, slow_set, slow_results, idx0,
        fmtq, fmtt, fpr_memo, names, chunk_idx_s, chunks_s, gsize_s, k_s,
    ):
        """The row writer of ``keep_top_scores`` (-n), in Python."""
        opt = self.opt
        db = self.db
        sizes = self.dev.sizes
        counts_host = state["counts"]
        B = len(state["ids"])
        w = out.write
        pos = 0
        top_n = opt.keep_top_scores
        for r in range(B):
            qid = state["ids"][r]
            if r in slow_set:
                qr = slow_results[r]
                qr.query_idx = idx0 + r
                write_results(out, [qr], opt.keep_unmatched)
                continue
            h = int(hits[r])
            if h == 0:
                if opt.keep_unmatched:
                    nk = 0 if state["too_short"][r] else int(counts_host[r])
                    w(
                        f"{qid}\t{state['qlen'][r]}\t{nk}\t0\t0\t\t-1\t0"
                        f"\t0\t{k_s}\t0\t0\t0\t0\t{idx0 + r}\n"
                    )
                continue
            n = int(counts_host[r])
            lo, hi_ = pos, pos + h
            pos = hi_
            rows = range(lo, hi_)
            if top_n > 0:
                rows = self._apply_top_n(cnt, lo, hi_, n, top_n)
            h_out = str(len(rows))
            prefix = f"{qid}\t{state['qlen'][r]}\t{n}\t"
            suffix = f"\t{idx0 + r}\n"
            for i in rows:
                ti = int(t[i])
                c = int(cnt[i])
                fk = (n, c)
                fs = fpr_memo.get(fk)
                if fs is None:
                    fs = f"{db.query_fpr(n, c):.4e}"
                    fpr_memo[fk] = fs
                size = int(sizes[ti])
                w(
                    prefix + fs + "\t" + h_out + "\t" + names[ti] + "\t"
                    + chunk_idx_s[ti] + "\t" + chunks_s[ti] + "\t"
                    + gsize_s[ti] + "\t" + k_s + "\t" + str(c) + "\t"
                    + fmtq(c, n) + "\t" + fmtt(c, size) + "\t"
                    + f"{c / (n + size - c):.4f}" + suffix
                )

    @staticmethod
    def _apply_top_n(cnt, lo, hi, n, top_n):
        """keep-top-scores truncation on the sorted slice: the reference's
        loop."""
        count = 0
        p = 1024.0
        i = lo
        for i in range(lo, hi):
            s = int(cnt[i]) / n
            if s < p:
                count += 1
                if count > top_n:
                    break
                p = s
        return range(lo, i + 1)
