"""Bounded-memory profiling: disk-spilled row-group chunks.

The port's copy of kmcp_tpu/profile/spill.py.  KMCP's profiler
re-streams its input TSV once per stage precisely so billion-row inputs
run in bounded memory (cmd/profile.go:68 — "Input files are parsed for
multiple times, therefore STDIN is not supported").  The columnar
FastProfiler instead holds ~40 B/row of arrays — fine to ~100M reads,
fatal beyond.  This module restores the reference's memory behavior
without giving up the vectorized stage math: the parse spills
group-aligned chunks of the column arrays (plus their per-chunk GT
factorization) to disk, and ``FastProfiler.run_spilled`` replays every
stage per chunk, merging only bounded aggregates (per-frag-slot
accumulators, per-target sums, the stage-2 pair dict and per-target
qcov histograms for the score percentile).

Correctness hinges on two alignment facts:
- groups (query ids) never span a chunk (the parser fuses boundary
  groups into the earlier chunk), so every per-group quantity is
  chunk-local;
- GT (group, target) ids factorize per chunk in the same
  group-major/target-ascending order as FlatInput._factorize, so the
  per-chunk stage helpers see exactly the slices of the global arrays
  they would have seen in memory.

Output equality with the in-memory engine is asserted by
tests/test_torch_profile.py (against kmcp_tpu's engines), including
the score column (exact percentile from per-target value counts with
numpy's _lerp replicated bit-for-bit).
"""

from __future__ import annotations

import os
import sys

import numpy as np


class _ChunkView:
    """FlatInput-shaped view of one chunk: local group/GT id spaces,
    global target ids and frag slots (what the stage helpers use)."""

    __slots__ = (
        "n_groups", "n_targets", "n_gt", "n_frag_slots",
        "group", "target", "frag", "qlen", "qcov",
        "gt_of_row", "gt_group", "gt_target",
        "gt_first_qcov", "gt_first_frag", "gt_first_tf", "row_tf",
    )


class FlatChunkStore:
    """Global metadata + on-disk chunks; `views()` yields _ChunkViews
    one at a time (each load is a plain read — no mmap, so RSS stays
    bounded by one chunk)."""

    def __init__(self, spill_dir: str):
        self.spill_dir = spill_dir
        self.chunk_paths: list[str] = []
        self.target_names: list[str] = []
        self.idx_num = None  # np.int32 [n_targets]
        self.gsize = None  # np.int64 [n_targets]
        self.n_groups = 0
        self.total_queries = 0

    # ------------------------------------------------------------ finalize
    def finalize(self):
        self.n_targets = len(self.target_names)
        self.idx_num = np.asarray(self.idx_num, dtype=np.int32)
        self.gsize = np.asarray(self.gsize, dtype=np.int64)
        self.frag_off = np.zeros(self.n_targets + 1, dtype=np.int64)
        np.cumsum(self.idx_num, out=self.frag_off[1:])
        self.n_frag_slots = int(self.frag_off[-1])
        self.slot_target = np.repeat(
            np.arange(self.n_targets), self.idx_num
        )

    def views(self):
        for path in self.chunk_paths:
            with np.load(path) as z:
                v = _ChunkView()
                v.n_targets = self.n_targets
                v.n_frag_slots = self.n_frag_slots
                v.group = z["group"]
                v.target = z["target"]
                v.frag = z["frag"]
                v.qlen = z["qlen"]
                v.qcov = z["qcov"]
                v.gt_of_row = z["gt_of_row"]
                v.gt_group = z["gt_group"]
                v.gt_target = z["gt_target"]
                v.gt_first_qcov = z["gt_first_qcov"]
                v.gt_first_frag = z["gt_first_frag"]
            v.n_groups = int(v.gt_group[-1]) + 1 if len(v.gt_group) else 0
            v.n_gt = len(v.gt_group)
            v.row_tf = self.frag_off[v.target] + v.frag
            v.gt_first_tf = (
                self.frag_off[v.gt_target] + v.gt_first_frag
            )
            yield v

    def cleanup(self):
        import shutil

        shutil.rmtree(self.spill_dir, ignore_errors=True)


def _write_chunk(store: FlatChunkStore, group, target, frag, qlen, qcov):
    """Factorize one group-aligned chunk and spill it.  The GT order
    matches FlatInput._factorize: (group, target) lexicographic."""
    if len(group) == 0:
        return
    # local group ids (0-based within the chunk)
    g0 = int(group[0])
    group_l = (group - g0).astype(np.int32)
    key = (group_l.astype(np.int64) << 32) | target.astype(np.int64)
    uniq, first, inverse = np.unique(
        key, return_index=True, return_inverse=True
    )
    path = os.path.join(
        store.spill_dir, f"chunk{len(store.chunk_paths):05d}.npz"
    )
    np.savez(
        path,
        group=group_l,
        target=target.astype(np.int32),
        frag=frag.astype(np.int32),
        qlen=qlen.astype(np.int64),
        qcov=qcov.astype(np.float64),
        gt_of_row=inverse.astype(np.int32),
        gt_group=(uniq >> 32).astype(np.int32),
        gt_target=(uniq & 0xFFFFFFFF).astype(np.int32),
        gt_first_qcov=qcov[first].astype(np.float64),
        gt_first_frag=frag[first].astype(np.int32),
    )
    store.chunk_paths.append(path)


def spill_from_files(
    files: list[str], max_fpr: float, min_qcov: float, spill_dir: str,
    chunk_bytes: int = 256 << 20,
) -> FlatChunkStore:
    """Parse search TSVs into a FlatChunkStore (native columnar
    parser).  Mirrors fast.flat_from_files'
    block/fuse logic, but a block whose first group continues the
    previous block's last group hands those rows BACK to the previous
    chunk before it is spilled, keeping chunks group-aligned."""
    from ..kmer import native
    from ..seqio.fastx import xopen

    store = FlatChunkStore(spill_dir)
    name2id: dict[str, int] = {}
    idx_num: list[int] = []
    gsize: list[int] = []
    g_off = 0
    total_queries = 0
    pending = None  # previous block's arrays, awaiting fuse resolution

    for path in files:
        prev_tail_qid = None
        with xopen(path, "rb") as f:
            carry = b""
            eof = False
            while not eof:
                data = f.read(chunk_bytes)
                buf = carry + data
                if data:
                    nl = buf.rfind(b"\n")
                    if nl < 0:
                        carry = buf
                        continue
                    carry = buf[nl + 1 :]
                    buf = buf[: nl + 1]
                else:
                    carry = b""
                    eof = True
                try:
                    d = native.parse_search_tsv(buf, max_fpr, min_qcov)
                except ValueError:
                    raise SystemExit("invalid kmcp search result format")
                ng = len(d["grp_off"])
                local2global = np.empty(len(d["tgt_names"]), dtype=np.int32)
                for li, nm in enumerate(d["tgt_names"]):
                    s = nm.decode()
                    gi = name2id.get(s)
                    if gi is None:
                        gi = len(store.target_names)
                        name2id[s] = gi
                        store.target_names.append(s)
                        idx_num.append(int(d["tgt_idx_num"][li]))
                        gsize.append(int(d["tgt_gsize"][li]))
                    local2global[li] = gi
                fuse = 0
                if ng and prev_tail_qid is not None:
                    o = int(d["grp_off"][0])
                    first_qid = buf[o : o + int(d["grp_len"][0])]
                    if first_qid == prev_tail_qid:
                        fuse = 1
                blk = (
                    d["group"] + (g_off - fuse),
                    local2global[d["target"]],
                    d["frag"],
                    d["qlen"],
                    d["qcov"],
                )
                if pending is not None:
                    if fuse:
                        # rows of the continued group move back into the
                        # pending chunk; the rest starts the next one
                        cont = blk[0] == (g_off - 1)
                        pending = tuple(
                            np.concatenate([p, b[cont]])
                            for p, b in zip(pending, blk)
                        )
                        blk = tuple(b[~cont] for b in blk)
                    if len(blk[0]) > 0 or not fuse:
                        _write_chunk(store, *pending)
                        pending = blk
                    # else: this whole parse block continued the pending
                    # chunk's last group (a group spanning 3+ blocks) —
                    # keep accumulating so the group never splits across
                    # chunks (the invariant every stage relies on)
                else:
                    pending = blk
                if ng:
                    o = int(d["grp_off"][ng - 1])
                    prev_tail_qid = buf[o : o + int(d["grp_len"][ng - 1])]
                g_off += ng - fuse
                total_queries += d["total_queries"]
    if pending is not None:
        _write_chunk(store, *pending)
    store.n_groups = g_off
    store.total_queries = total_queries
    store.idx_num = idx_num
    store.gsize = gsize
    store.finalize()
    return store


def _np_lerp(a: float, b: float, t: float) -> float:
    """numpy's percentile interpolation (_lerp), replicated so the
    histogram-based score equals np.percentile bit-for-bit."""
    diff = b - a
    r = a + diff * t
    if t >= 0.5:
        r = b - diff * (1 - t)
    return r


def _percentile90(values: np.ndarray, counts: np.ndarray) -> float:
    """90th percentile (linear interpolation) of a multiset given as
    sorted distinct values + counts — equals np.percentile(expanded, 90)."""
    n = int(counts.sum())
    if n == 0:
        return 0.0
    pos = 0.9 * (n - 1)
    lo = int(np.floor(pos))
    t = pos - lo
    cum = np.cumsum(counts)
    i = int(np.searchsorted(cum, lo + 1, side="left"))
    a = float(values[i])
    if t == 0.0:
        return a
    j = i if cum[i] > lo + 1 else i + 1
    b = float(values[j])
    return _np_lerp(a, b, t)


def run_spilled(prof, store: FlatChunkStore):
    """FastProfiler.run over a FlatChunkStore: identical math, chunked
    passes, bounded aggregates.  See the module docstring."""
    from .fast import species_ids

    opt, p = prof.opt, prof.p
    prof.total_queries = store.total_queries
    if prof.level_species:
        prof._species = species_ids(store, prof.taxdb, prof.taxid_map)
    else:
        prof._species = np.full(store.n_targets, -1, dtype=np.int64)

    nfs = store.n_frag_slots
    nt = store.n_targets

    # ---------------- stage 1
    all_t = np.ones(nt, dtype=bool)
    match = np.zeros(nfs)
    uniq = np.zeros(nfs)
    uniq_hic = np.zeros(nfs)
    n_reads = 0
    for view in store.views():
        st1 = prof._stage_state(view, all_t)
        n_reads += int((st1.n_t > 0).sum())
        m, _, u, uh, _, _ = prof._accumulate_stage1(view, st1)
        match += m
        uniq += u
        uniq_hic += uh
    prof.n_reads = float(n_reads)
    prof1 = {}
    off = store.frag_off
    for t in range(nt):
        lo, hi = off[t], off[t + 1]
        if hi == lo or match[lo:hi].sum() == 0:
            continue
        su = uniq[lo:hi].sum()
        if su < 1:
            continue
        sh = uniq_hic[lo:hi].sum()
        if sh < 1:
            continue
        frags = int((match[lo:hi] > 0).sum())
        if frags / (hi - lo) < p["min_frags_prop"]:
            continue
        prof1[t] = (float(match[lo:hi].sum()), float(su))
    if not prof1:
        print("[profile] no target found, please adjust parameters",
              file=sys.stderr)
        return []

    # ---------------- stage 2
    allowed = np.zeros(nt, dtype=bool)
    allowed[list(prof1.keys())] = True
    amb: dict[tuple[int, int], float] = {}
    if not opt.no_amb_corr:
        for view in store.views():
            st = prof._stage_state(view, allowed)
            prof._count_amb(view, st, amb)

    # ---------------- stage 3
    sum_match1 = np.zeros(nt)
    sum_uniq1 = np.zeros(nt)
    for t, v in prof1.items():
        sum_match1[t] = v[0]
        sum_uniq1[t] = v[1]
    match = np.zeros(nfs)
    qlen_arr = np.zeros(nfs)
    uniq = np.zeros(nfs)
    uniq_hic = np.zeros(nfs)
    for view in store.views():
        st_allowed = prof._stage_state(view, allowed)
        gt_deleted = prof._megapath_deletions(
            view, st_allowed, amb, sum_match1, sum_uniq1
        )
        st3 = prof._stage_state(view, allowed, gt_deleted)
        prop3 = np.zeros(view.n_gt)
        prop3[st3.gt_idx] = 1.0 / np.maximum(
            st3.n_t[view.gt_group[st3.gt_idx]], 1
        )
        m, q, u, uh, _, _ = prof._accumulate(view, st3, prop3, "stage3")
        match += m
        qlen_arr += q
        uniq += u
        uniq_hic += uh
    prof2 = prof._sum_targets(
        store, match, qlen_arr, uniq, uniq_hic, check=True
    )

    # ---------------- stage 4: EM
    coverages = np.zeros(nt)
    for t, tg in prof2.items():
        coverages[t] = tg.coverage
    whitelist = np.zeros(nt, dtype=bool)
    whitelist[list(prof2.keys())] = True
    targets = []
    dom_prev = 0.0
    for it in range(opt.max_iters + 1):
        match = np.zeros(nfs)
        qlen_arr = np.zeros(nfs)
        uniq = np.zeros(nfs)
        uniq_hic = np.zeros(nfs)
        n_assigned = 0
        # per-target score histograms: {target: {qcov: count}} over the
        # unique (and same-species ambiguous) GTs of this iteration
        score_vals: dict[int, dict[float, int]] = {}
        for view in store.views():
            st4 = prof._stage_state(view, whitelist)
            gt_idx4 = st4.gt_idx
            cov_gt = coverages[view.gt_target[gt_idx4]]
            covsum = np.zeros(view.n_groups)
            np.add.at(covsum, view.gt_group[gt_idx4], cov_gt)
            propv = np.zeros(view.n_gt)
            grp4 = view.gt_group[gt_idx4]
            is_amb = st4.n_t[grp4] > 1
            denom = covsum[grp4]
            pr = np.where(
                is_amb & (denom > 0),
                cov_gt / np.where(denom > 0, denom, 1),
                1.0,
            )
            propv[gt_idx4] = pr
            n_assigned += int((st4.n_t > 0).sum())
            m, q, u, uh, unique_gt, amb_ss = prof._accumulate(
                view, st4, propv, "em"
            )
            match += m
            qlen_arr += q
            uniq += u
            uniq_hic += uh
            sel = (
                unique_gt if amb_ss is None or len(amb_ss) == 0
                else np.concatenate([unique_gt, amb_ss])
            )
            if len(sel):
                tv = view.gt_target[sel].astype(np.int64)
                vv = view.gt_first_qcov[sel]
                for tt, val in zip(tv.tolist(), vv.tolist()):
                    d = score_vals.setdefault(int(tt), {})
                    d[val] = d.get(val, 0) + 1
        prof.n_assigned = float(n_assigned)
        prof3 = prof._sum_targets(
            store, match, qlen_arr, uniq, uniq_hic, check=(it == 0)
        )
        for tt, d in score_vals.items():
            tg = prof3.get(tt)
            if tg is not None:
                vals = np.array(sorted(d.keys()), dtype=np.float64)
                cnts = np.array([d[v] for v in vals], dtype=np.int64)
                tg.score = _percentile90(vals, cnts) * 100
        targets = list(prof3.values())
        coverages = np.zeros(nt)
        whitelist = np.zeros(nt, dtype=bool)
        for t, tg in prof3.items():
            coverages[t] = tg.coverage
            whitelist[t] = True
        scov = sum(t.coverage for t in targets)
        for tg in targets:
            tg.percentage = tg.coverage / scov * 100 if scov > 0 else 0.0
        targets.sort(key=lambda t: -t.coverage)
        if it > 0 and targets:
            if abs(targets[0].percentage - dom_prev) < opt.abund_pct_threshold:
                break
        if not targets:
            break
        dom_prev = targets[0].percentage

    # final sort + low-pct filter + taxonomy: the exact code the
    # in-memory engine runs (fast.FastProfiler._finalize_targets)
    return prof._finalize_targets(targets)
