"""Streaming search of single-end reads or read pairs on a torch device,
over a one-block DB or a multi-block ``--block-screen --uniform-sigs`` DB.

Port of kmcp_tpu/search/stream.py ``StreamSearcher`` (``__init__``,
``usable``, ``run``; :132-637) for its non-sketch device path (the dense
tail for one block, the two-pass screened tail for several),
with the port's own copies of its helpers ``_unpack_result`` (:65, the
``(meta, aux)`` layouts only), ``_pack_reads_matrix`` (:104),
``_fmt_ratio_memo`` (:118) and its writers ``_write_native`` (:641) and
``_write_python`` (:699).  The batching, padding, ``lmax`` rounding,
2-slots-per-read candidate budget, 4x overflow retry, ``lexsort`` order and
the row bytes are the JAX streamer's.  Reads ship as ASCII rows.

Single-end reads over the k-mer dedup threshold take the object-engine
route, as in the JAX streamer (stream.py:565-584), here with the numpy
counter; they are counted in ``slow_rows``.  Read pairs hash as one joined
row ``seq1 + N + seq2`` (the N resets the rolling window, so the row's
k-mers are both mates'; stream.py:352-373, util-db-search.go:800-805), and
rows over the threshold are uniqued on the device instead
(search/dedup.py), so no pair takes the object engine for that.
"""

from __future__ import annotations

import sys
from itertools import islice

import numpy as np
import torch

from ..kmer import native
from .device import MULTI_BLOCK_NEEDS, TorchDeviceDB, two_pass_ready
from .engine import QueryResult, SearchEngine
from .tsv import write_results


def _unpack_result(res, budget, nb, T):
    """A search step's (meta int32, aux uint16) host arrays -> (n_cand, qi,
    t, cnt, nk).  meta is [n, read_idx..., target_idx...] of 1 + 2*budget
    ints (split ids, the screened tail) or [n, flat_idx...] of 1 + budget
    (flat ids qi*T + t, the dense tail); aux is [budget + nb] = counts then
    per-read k-mer counts.  On budget overflow returns (n_cand, None, ...):
    the caller retries with a larger budget."""
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


def _pack_reads_matrix(seqs, lens, lmax):
    """Zero-padded row-major [B, lmax] uint8 read matrix."""
    return native.pack_rows(seqs, lens, lmax)


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


def unsupported(engine: SearchEngine, paired: bool = False) -> str | None:
    """Why the port cannot stream this search (naming the ROADMAP item that
    will add it), or None when it can."""
    opt = engine.opt
    if len(engine.dbs) != 1:
        return "searching several DBs at once needs the object engine (ROADMAP A8)"
    db = engine.dbs[0]
    if paired and opt.try_se:
        return ("paired --try-se needs the object engine's retry plan "
                "(ROADMAP A8)")
    if len(db.blocks) != 1 and not two_pass_ready(db):
        return MULTI_BLOCK_NEEDS
    if db.is_sketch:
        return "sketch DBs need device sketch selection (ROADMAP A7)"
    if not db.info.canonical:
        return ("non-canonical DBs: the device hash is canonical only "
                "(ROADMAP C)")
    if opt.low_mem:
        return "--low-mem row seek is an object-engine mode (ROADMAP A8)"
    if opt.sort_by != "qcov" or opt.do_not_sort:
        return ("sort orders other than qcov need the object engine "
                "(ROADMAP A8)")
    if opt.kmer_dedup_threshold >= 65535:
        return "kmer_dedup_threshold >= 65535 overflows the uint16 result"
    if len(db.blocks) == 1 and db.blocks[0].bits.shape[1] * 32 > 2**31 // 256:
        return "more than 2^23 targets overflow the int32 flat candidate ids"
    return None


class TorchStreamSearcher:
    """``pass2`` picks the screened tail's pass-2 kernel of a multi-block
    DB (TorchDeviceDB)."""

    def __init__(self, engine: SearchEngine, device="cuda",
                 pass2: str = "auto"):
        reason = unsupported(engine)
        if reason:
            raise NotImplementedError(reason)
        self.engine = engine
        self.opt = engine.opt
        self.db = engine.dbs[0]
        self.dev = TorchDeviceDB(self.db, self.opt, device, pass2)
        self.k = self.db.ks_desc[0]
        self.multi_k = len(self.db.ks_desc) > 1
        self._fpr_tabs: dict[int, dict] = {}
        self._tmeta_tab = None
        self._tname_tab = None
        self.slow_rows = 0  # reads searched by the object engine
        self.retries = 0  # 4x-budget re-runs after a candidate overflow

    @classmethod
    def usable(cls, engine: SearchEngine, paired: bool = False) -> bool:
        return unsupported(engine, paired) is None

    def run(self, queries, out, start_idx: int = 0, paired: bool = False,
            progress=None) -> tuple[int, int]:
        """queries: iterator of (id, seq, None), or with ``paired`` of (id,
        seq1, seq2) (seq2 may be empty).  Returns (total, matched)."""
        reason = unsupported(self.engine, paired)
        if reason:
            raise NotImplementedError(reason)
        dev = self.dev
        # the dense tail's int32 flat ids b*T + t cap the batch at
        # B*T <= 2^31 (the screened tail's split ids do not); batches stay
        # multiples of 256 reads, as in the JAX streamer
        batch_size = max(self.opt.batch_size, 16384)
        if dev.n_blocks == 1:
            batch_size = min(batch_size, (2**31) // dev.t_per_block)
        batch_size = max(batch_size // 256 * 256, 256)
        fmt = (_fmt_ratio_memo(), _fmt_ratio_memo(), {})
        total = matched = 0
        idx0 = start_idx
        it = iter(queries)
        while True:
            batch = list(islice(it, batch_size))
            if not batch:
                break
            m = self._search_batch(batch, batch_size, out, idx0, fmt, paired)
            total += len(batch)
            matched += m
            idx0 += len(batch)
            if progress is not None:
                progress(total)
        if self.slow_rows:
            print(
                f"[search] {self.slow_rows} reads over the k-mer dedup "
                "threshold were searched by the numpy object engine",
                file=sys.stderr,
            )
        return total, matched

    def _search_batch(self, batch, batch_size, out, idx0, fmt,
                      paired=False) -> int:
        """Search, order and write one batch; returns its matched reads.
        With ``paired`` each (id, seq1, seq2) hashes as one joined row; the
        TSV's qLen is len1 + len2, and the min-length filter reads
        max(len1, len2) (stream.py:352-373, :461-467)."""
        opt = self.opt
        dev = self.dev
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
        budget = 2 * batch_size
        lmax = max(-(-int(lens.max()) // 32) * 32, self.k + 31)
        reads = torch.from_numpy(_pack_reads_matrix(seqs, lens, lmax)).to(
            dev.device
        )
        T = dev.t_per_block
        n_cand, qi, t, cnt, nk = _unpack_result(
            dev.search_reads(reads, eff, budget, paired), budget, batch_size,
            T
        )
        while qi is None:  # candidate overflow: re-run with 4x the budget
            budget *= 4
            self.retries += 1
            n_cand, qi, t, cnt, nk = _unpack_result(
                dev.search_reads(reads, eff, budget, paired), budget,
                batch_size, T
            )

        counts = nk[:B]
        state = {
            "ids": [q[0] for q in batch],
            "counts": counts,
            "qlen": qlen,
            "too_short": eff[:B] < opt.min_query_len,
        }
        # paired rows over the dedup threshold were uniqued on the device
        slow_rows = (np.zeros(0, dtype=np.int64) if paired else
                     np.nonzero(counts > opt.kmer_dedup_threshold)[0])
        if self.multi_k:
            # unmatched reads retry with the DB's smaller ks
            has_match = np.zeros(B, dtype=bool)
            has_match[qi] = True
            retry = ~has_match & ~state["too_short"] & (
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

        # qi asc, qcov desc (cnt desc), tcov desc (size asc), then target
        order = np.lexsort((t, dev.sizes[t], -cnt, qi))
        qi, t, cnt = qi[order], t[order], cnt[order]
        hits = np.bincount(qi, minlength=B).astype(np.int32)
        matched = int((hits > 0).sum()) + sum(
            1 for r in slow_set if slow_results[r].matches
        )
        if opt.keep_top_scores <= 0:
            self._write_native(out, state, qi, t, cnt, hits, slow_set,
                               slow_results, idx0)
        else:
            names = [(opt.name_map or {}).get(n, n) for n in dev.names]
            self._write_python(
                out, state, qi, t, cnt, hits, slow_set, slow_results, idx0,
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
