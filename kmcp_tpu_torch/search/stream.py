"""Streaming single-end search on a torch device, over a one-block DB or a
multi-block ``--block-screen --uniform-sigs`` DB.

Port of kmcp_tpu/search/stream.py ``StreamSearcher`` (``__init__``,
``usable``, ``run``; :132-637) for its single-end, non-sketch device path
(the dense tail for one block, the two-pass screened tail for several).
The batching, padding, ``lmax`` rounding, 2-slots-per-read
candidate budget, 4x overflow retry, ``lexsort`` order and the writers are
the JAX streamer's; the writers, ``_unpack_result`` and
``_pack_reads_matrix`` are imported from it unchanged.  Reads ship as
ASCII rows.

Reads over the k-mer dedup threshold take the object-engine route, as in
the JAX streamer (stream.py:565-584), here with the numpy counter; they are
counted in ``slow_rows``.
"""

from __future__ import annotations

import sys
from itertools import islice

import numpy as np
import torch

from kmcp_tpu.kmer import native
from kmcp_tpu.search.device_screened import two_pass_ready
from kmcp_tpu.search.engine import QueryResult, SearchEngine
from kmcp_tpu.search.stream import (
    StreamSearcher,
    _fmt_ratio_memo,
    _pack_reads_matrix,
    _unpack_result,
)

from .device import MULTI_BLOCK_NEEDS, TorchDeviceDB


def unsupported(engine: SearchEngine, paired: bool = False) -> str | None:
    """Why the port cannot stream this search (naming the ROADMAP item that
    will add it), or None when it can."""
    opt = engine.opt
    if len(engine.dbs) != 1:
        return "searching several DBs at once needs the object engine (ROADMAP A8)"
    db = engine.dbs[0]
    if paired:
        return "paired reads need paired streaming (ROADMAP A6)"
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
    if native.get_lib() is None:
        return "the native library (TSV writer) is unavailable"
    return None


class TorchStreamSearcher(StreamSearcher):
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
        self._fpr_tabs: dict[int, tuple] = {}
        self._tmeta_tab = None
        self._tname_tab = None
        self.slow_rows = 0  # reads searched by the object engine
        self.retries = 0  # 4x-budget re-runs after a candidate overflow

    @classmethod
    def usable(cls, engine: SearchEngine, paired: bool = False) -> bool:
        return unsupported(engine, paired) is None

    def run(self, queries, out, start_idx: int = 0, paired: bool = False,
            progress=None) -> tuple[int, int]:
        """queries: iterator of (id, seq, None).  Returns (total, matched)."""
        if paired:
            raise NotImplementedError(
                "paired reads need paired streaming (ROADMAP A6)"
            )
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
            m = self._search_batch(batch, batch_size, out, idx0, fmt)
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

    def _search_batch(self, batch, batch_size, out, idx0, fmt) -> int:
        """Search, order and write one batch; returns its matched reads."""
        opt = self.opt
        dev = self.dev
        B = len(batch)
        # pad to the fixed batch size (empty reads hit only the sentinel)
        seqs = [q[1] for q in batch] + [b""] * (batch_size - B)
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        budget = 2 * batch_size
        lmax = max(-(-int(lens.max()) // 32) * 32, self.k + 31)
        reads = torch.from_numpy(_pack_reads_matrix(seqs, lens, lmax)).to(
            dev.device
        )
        T = dev.t_per_block
        n_cand, qi, t, cnt, nk = _unpack_result(
            dev.search_reads(reads, lens, budget), budget, batch_size, T
        )
        while qi is None:  # candidate overflow: re-run with 4x the budget
            budget *= 4
            self.retries += 1
            n_cand, qi, t, cnt, nk = _unpack_result(
                dev.search_reads(reads, lens, budget), budget, batch_size, T
            )

        counts = nk[:B]
        lens = lens[:B]
        state = {
            "ids": [q[0] for q in batch],
            "counts": counts,
            "qlen": lens,
            "too_short": lens < opt.min_query_len,
        }
        slow_rows = np.nonzero(counts > opt.kmer_dedup_threshold)[0]
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
