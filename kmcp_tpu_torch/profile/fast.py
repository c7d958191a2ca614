"""Vectorized profiler engine: the four stages + EM as NumPy segment
operations over a flattened match table.

The port's copy of kmcp_tpu/profile/fast.py.  Semantics match
profile/core.py (which replicates KMCP's cmd/profile.go stage by stage);
this engine drops the per-read Python loops so profiling scales to
CAMI-sized inputs.  The sums stay float64 NumPy segment sums in a fixed
order, so the printed digits are kmcp_tpu's.  All match
pre-filter configurations are covered: the streaming keep-perfect /
keep-main / keep-top-qcovs pScore machine (profile.go:878-919) only ever
STOPS a group's match stream, so per group the survivors are a prefix of
the allowed rows — computed here as a vectorized segmented cut
(``_prefix_cut``).  Preset mode 0 (pathogen detection, keep_main=True)
therefore runs vectorized too.

Key representation: rows are flattened arrays sorted in stream order;
(read-group, target) pairs ("GT" records) are factorized once.  The first
row of each GT in stream order is its best match (search output is
qcov-descending), matching the reference's "count once" logic.  The
species-LCA test reduces to "all targets share one species-rank ancestor",
precomputed per target.
"""

from __future__ import annotations

import sys

import numpy as np

from .core import (
    ProfileOptions,
    Target,
    mean_stdev,
    resolve_params,
)
from .taxonomy import Taxonomy


class FlatInput:
    """Column arrays of the native columnar parser's output (built by
    ``from_arrays``; kmcp_tpu's view of a per-row ParsedInput is not
    copied: the port's fast engine always parses natively)."""

    @classmethod
    def from_arrays(
        cls, group, target, frag, qlen, qcov, idx_num, gsize,
        target_names, n_groups, total_queries,
    ) -> "FlatInput":
        self = cls()
        self.n_groups = int(n_groups)
        self.n_targets = len(target_names)
        self.target_names = target_names
        self.total_queries = int(total_queries)
        self.group = np.ascontiguousarray(group, dtype=np.int64)
        self.target = np.ascontiguousarray(target, dtype=np.int32)
        self.frag = np.ascontiguousarray(frag, dtype=np.int32)
        self.qlen = np.ascontiguousarray(qlen, dtype=np.int64)
        self.qcov = np.ascontiguousarray(qcov, dtype=np.float64)
        self.idx_num = np.ascontiguousarray(idx_num, dtype=np.int32)
        self.gsize = np.ascontiguousarray(gsize, dtype=np.int64)
        self._factorize()
        return self

    def _factorize(self):
        # factorize (group, target)
        key = self.group * np.int64(self.n_targets) + self.target
        uniq, first, inverse, counts = np.unique(
            key, return_index=True, return_inverse=True, return_counts=True
        )
        self.gt_of_row = inverse
        self.gt_group = (uniq // self.n_targets).astype(np.int64)
        self.gt_target = (uniq % self.n_targets).astype(np.int32)
        self.gt_msize = counts.astype(np.int64)  # full (unfiltered) msize
        self.gt_first_row = first
        self.gt_first_qcov = self.qcov[first]
        self.gt_first_frag = self.frag[first]
        self.n_gt = len(uniq)

        # per-target flat chunk offsets
        self.frag_off = np.zeros(self.n_targets + 1, dtype=np.int64)
        np.cumsum(self.idx_num, out=self.frag_off[1:])
        self.n_frag_slots = int(self.frag_off[-1])
        self.slot_target = np.repeat(
            np.arange(self.n_targets), self.idx_num
        )
        self.row_tf = self.frag_off[self.target] + self.frag
        self.gt_first_tf = self.frag_off[self.gt_target] + self.gt_first_frag


def flat_from_files(
    files: list[str], max_fpr: float, min_qcov: float,
    keep_queries: bool = False, chunk_bytes: int = 512 << 20,
) -> FlatInput:
    """Columnar native parse of search TSVs straight into a FlatInput
    (no per-row Python objects).  Target ids are re-interned across files; groups never
    span a file boundary (matching core.parse_search_tsv).  Files read
    in ``chunk_bytes`` blocks so the transient raw buffer stays bounded
    (a group spanning a block boundary is fused back into one).  With
    ``keep_queries``, per-group query ids stay addressable as (buffer,
    offset, len) for lazy decoding (binning) — buffers are then retained.
    """
    from ..kmer import native
    from ..seqio.fastx import xopen

    name2id: dict[str, int] = {}
    names: list[str] = []
    idx_num: list[int] = []
    gsize: list[int] = []
    groups = []
    targets = []
    frags = []
    qlens = []
    qcovs = []
    qsrc = []  # (buf, grp_off, grp_len, first_group) per block
    g_off = 0
    total_queries = 0
    for path in files:
        prev_tail_qid = None  # last group's query id in the prior block
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
                        gi = len(names)
                        name2id[s] = gi
                        names.append(s)
                        idx_num.append(int(d["tgt_idx_num"][li]))
                        gsize.append(int(d["tgt_gsize"][li]))
                    local2global[li] = gi
                fuse = 0
                if ng and prev_tail_qid is not None:
                    o = int(d["grp_off"][0])
                    first_qid = buf[o : o + int(d["grp_len"][0])]
                    if first_qid == prev_tail_qid:
                        fuse = 1  # block starts mid-group: same group id
                groups.append(d["group"] + (g_off - fuse))
                targets.append(local2global[d["target"]])
                frags.append(d["frag"])
                qlens.append(d["qlen"])
                qcovs.append(d["qcov"])
                if keep_queries and ng > fuse:
                    qsrc.append((
                        buf, d["grp_off"][fuse:], d["grp_len"][fuse:],
                        g_off,
                    ))
                if ng:
                    o = int(d["grp_off"][ng - 1])
                    prev_tail_qid = buf[o : o + int(d["grp_len"][ng - 1])]
                g_off += ng - fuse
                total_queries += d["total_queries"]
    flat = FlatInput.from_arrays(
        np.concatenate(groups) if groups else np.empty(0, np.int64),
        np.concatenate(targets) if targets else np.empty(0, np.int32),
        np.concatenate(frags) if frags else np.empty(0, np.int32),
        np.concatenate(qlens) if qlens else np.empty(0, np.int64),
        np.concatenate(qcovs) if qcovs else np.empty(0, np.float64),
        np.asarray(idx_num, dtype=np.int32),
        np.asarray(gsize, dtype=np.int64),
        names, g_off, total_queries,
    )
    if keep_queries:
        flat.query_src = qsrc
    return flat


def _flat_group_query(flat: FlatInput, g: int) -> str:
    """Decode group g's query id from the retained file buffers."""
    for buf, offs, lens, first in reversed(flat.query_src):
        if g >= first:
            o = int(offs[g - first])
            return buf[o : o + int(lens[g - first])].decode()
    raise IndexError(g)


def species_ids(
    flat: FlatInput, taxdb: Taxonomy, taxid_map: dict[str, int]
) -> np.ndarray:
    """species-rank ancestor per target (-1 when none): the group-level
    LCA-at-or-below-species test becomes 'all ids equal and != -1'."""
    out = np.full(flat.n_targets, -1, dtype=np.int64)
    for t, name in enumerate(flat.target_names):
        taxid = taxid_map.get(name)
        if taxid is None:
            raise SystemExit(
                f"unknown taxid for {name}, please check taxid mapping file(s)"
            )
        cur = taxdb.taxid(taxid)
        hops = 0
        while cur and hops < 64:
            if taxdb.rank.get(cur, "") == "species":
                out[t] = cur
                break
            p = taxdb.parent.get(cur)
            if p is None or p == cur:
                break
            cur = p
            hops += 1
    return out


class _StageState:
    """Per-stage view of the match table after the allowed-target mask and
    the streaming pre-filters: surviving rows plus recomputed GT/group
    aggregates (a GT's match count can shrink when a prefix cut drops its
    lower-qcov chunk rows)."""

    __slots__ = (
        "row_sel", "row_gt", "row_inv", "msize", "gt_idx", "n_t", "same_sp",
    )


class FastProfiler:
    """Vectorized equivalent of core.Profiler (all pre-filter configs)."""

    def __init__(self, opt: ProfileOptions, taxdb=None, taxid_map=None):
        self.opt = opt
        self.p = resolve_params(opt)
        self.taxdb = taxdb
        self.taxid_map = taxid_map or {}
        self.level_species = opt.level == "species"
        if self.level_species and not self.taxid_map:
            raise SystemExit("--taxid-map needed for --level species")
        self.n_reads = 0.0
        self.n_assigned = 0.0
        self.total_queries = 0
        self._pref = (
            bool(opt.keep_perfect_matches),
            bool(self.p["keep_main"]),
            float(self.p["max_gap"]),
            int(opt.keep_top_qcovs or 0),
        )
        self._has_pref = (
            self._pref[0] or self._pref[1] or self._pref[3] > 0
        )

    @staticmethod
    def usable(opt: ProfileOptions) -> bool:
        return True

    # ---------------------------------------------------------------- core

    def _prefix_cut(self, flat: FlatInput, rmask: np.ndarray) -> np.ndarray:
        """Refine a row mask with the reference's streaming pScore
        pre-filters (profile.go:878-919).  Within a group every filter
        permanently stops the stream (``process = false``), so survivors
        are a prefix of the allowed rows; the cut position is the earliest
        row triggering any stop condition, and the triggering row itself
        is dropped."""
        keep_full, keep_main, max_gap, top_n = self._pref
        sel = np.flatnonzero(rmask)
        if len(sel) == 0:
            return rmask
        g = flat.group[sel]
        first = np.empty(len(sel), dtype=bool)
        first[0] = True
        np.not_equal(g[1:], g[:-1], out=first[1:])
        starts = np.flatnonzero(first)
        seg_id = np.cumsum(first) - 1
        seg_len = np.diff(np.append(starts, len(sel)))
        pos = np.arange(len(sel)) - np.repeat(starts, seg_len)
        qc = flat.qcov[sel]
        prev = np.empty_like(qc)
        prev[1:] = qc[:-1]
        prev[first] = 1024.0  # pScore start value (never matches == 1)
        cut = np.zeros(len(sel), dtype=bool)
        if keep_full:
            # stop at the first non-perfect match after a perfect one
            cut |= (~first) & (prev == 1.0) & (qc < 1.0)
        elif keep_main:
            # pScore <= 1 always holds after the first append
            cut |= (~first) & (prev - qc > max_gap)
        if top_n > 0:
            # n_score counts strict qcov decreases (incl. the first row,
            # where pScore==1024); stop when it would exceed top_n
            newv = first | (qc < prev)
            cum = np.cumsum(newv)
            rank = cum - np.repeat(cum[starts] - 1, seg_len)
            cut |= rank > top_n
        if not cut.any():
            return rmask
        first_cut = np.full(len(starts), np.iinfo(np.int64).max, np.int64)
        np.minimum.at(first_cut, seg_id[cut], pos[cut])
        keep = pos < first_cut[seg_id]
        out = np.zeros_like(rmask)
        out[sel[keep]] = True
        return out

    def _stage_state(
        self,
        flat: FlatInput,
        allowed: np.ndarray,
        gt_deleted: np.ndarray | None = None,
    ) -> _StageState:
        """Allowed-mask + pre-filters -> surviving rows and aggregates.
        ``gt_deleted`` removes whole GTs AFTER the prefix cut (the
        MegaPath deletions happen on the already-filtered matches,
        profile.go:1341-1387)."""
        rmask = allowed[flat.target]
        if self._has_pref:
            rmask = self._prefix_cut(flat, rmask)
        if gt_deleted is not None and gt_deleted.any():
            rmask = rmask & ~gt_deleted[flat.gt_of_row]
        st = _StageState()
        st.row_sel = np.flatnonzero(rmask)
        st.row_gt = flat.gt_of_row[st.row_sel]
        st.msize = np.bincount(st.row_gt, minlength=flat.n_gt)
        st.gt_idx = np.flatnonzero(st.msize > 0)
        groups = flat.gt_group[st.gt_idx]
        st.n_t = np.bincount(groups, minlength=flat.n_groups)
        if self.level_species:
            sp = self._species[flat.gt_target[st.gt_idx]]
            smin = np.full(flat.n_groups, np.iinfo(np.int64).max, np.int64)
            smax = np.full(flat.n_groups, -1, np.int64)
            np.minimum.at(smin, groups, sp)
            np.maximum.at(smax, groups, sp)
            st.same_sp = (smin == smax) & (smax != -1)
        else:
            st.same_sp = np.zeros(flat.n_groups, dtype=bool)
        with np.errstate(divide="ignore"):
            st.row_inv = 1.0 / st.msize[st.row_gt]
        return st

    def _accumulate(
        self,
        flat: FlatInput,
        st: _StageState,
        gt_prop: np.ndarray,
        mode: str,
    ):
        """Shared scatter-add core for stage 3 and the EM loop.

        Weighting (profile.go stage 3 vs EM):
          stage3: match += 1/msize; qlen += qlen*prop/msize;
                  same-species uniq += 1/msize
          em:     match += prop/msize; qlen += qlen*prop/msize;
                  same-species uniq += prop/msize
        Unique reads always: match += 1/msize, qlen += qlen/msize,
        uniq += 1 (prop == 1 for them).  ``msize`` is the stage's
        per-GT surviving-row count (pre-filters can shrink it).
        """
        p = self.p
        hic_qcov = p["hic_qcov"]
        nfs = flat.n_frag_slots
        match = np.zeros(nfs)
        qlen_arr = np.zeros(nfs)
        uniq = np.zeros(nfs)
        uniq_hic = np.zeros(nfs)

        gt_idx = st.gt_idx
        groups_of_gt = flat.gt_group[gt_idx]
        ambiguous = st.n_t[groups_of_gt] > 1
        unique_gt = gt_idx[~ambiguous]
        amb_gt = gt_idx[ambiguous]

        # ---- unique reads: full weight (the GT's first/best row always
        # survives a prefix cut, so gt_first_* stay valid)
        tf_u = flat.gt_first_tf[unique_gt]
        np.add.at(uniq, tf_u, 1.0)
        hic_mask = flat.gt_first_qcov[unique_gt] >= hic_qcov
        np.add.at(uniq_hic, tf_u[hic_mask], 1.0)

        # ---- ambiguous reads counted as unique (same species)
        if self.level_species:
            ss = st.same_sp[flat.gt_group[amb_gt]]
            amb_ss = amb_gt[ss]
            if mode == "stage3":
                w = 1.0 / st.msize[amb_ss]
            else:
                w = gt_prop[amb_ss] / st.msize[amb_ss]
            np.add.at(uniq, flat.gt_first_tf[amb_ss], w)
            hm = flat.gt_first_qcov[amb_ss] >= hic_qcov
            np.add.at(uniq_hic, flat.gt_first_tf[amb_ss][hm], w[hm])
        else:
            amb_ss = amb_gt[:0]

        # ---- per-row match/qlen accumulation over surviving rows
        row_sel = st.row_sel
        w_prop = gt_prop[st.row_gt] * st.row_inv
        if mode == "stage3":
            np.add.at(match, flat.row_tf[row_sel], st.row_inv)
        else:
            np.add.at(match, flat.row_tf[row_sel], w_prop)
        np.add.at(
            qlen_arr, flat.row_tf[row_sel], flat.qlen[row_sel] * w_prop
        )
        return match, qlen_arr, uniq, uniq_hic, unique_gt, amb_ss

    def _sum_targets(
        self, flat, match, qlen_arr, uniq, uniq_hic, check: bool,
        uniq_qcov_vals=None,
    ):
        """Per-target reductions + filters; returns dict target->Target."""
        p = self.p
        out = {}
        off = flat.frag_off
        tsum = np.bincount(
            flat.slot_target, weights=match, minlength=flat.n_targets
        )
        active = np.flatnonzero(tsum > 0)
        for t in active:
            lo, hi = off[t], off[t + 1]
            tg = Target(
                flat.target_names[t], int(flat.gsize[t]), int(hi - lo)
            )
            tg.match = match[lo:hi].tolist()
            tg.uniq = uniq[lo:hi].tolist()
            tg.uniq_hic = uniq_hic[lo:hi].tolist()
            if qlen_arr is not None:
                tg.qlen = qlen_arr[lo:hi].tolist()
            tg.sum_uniq = float(uniq[lo:hi].sum())
            if check and tg.sum_uniq < p["min_ureads"]:
                continue
            tg.sum_uniq_hic = float(uniq_hic[lo:hi].sum())
            if check and tg.sum_uniq_hic < p["min_hic_ureads"]:
                continue
            if check and tg.sum_uniq_hic < p["hic_prop"] * tg.sum_uniq:
                continue
            frags = sum(1 for c in tg.match if c >= p["min_reads"])
            tg.sum_match = float(match[lo:hi].sum())
            tg.frags_prop = frags / len(tg.match)
            if check and tg.frags_prop < p["min_frags_prop"]:
                continue
            if qlen_arr is not None:
                tg.qlens = sum(tg.qlen)
                n = len(tg.qlen)
                if tg.qlens > 0:
                    tg.rel_depth = [c / tg.qlens * n for c in tg.qlen]
                _, tg.rel_depth_std = mean_stdev(tg.rel_depth)
                if check and tg.rel_depth_std > p["max_depth_stdev"]:
                    continue
                self._coverage(tg)
            out[int(t)] = tg
        return out

    def _coverage(self, t: Target):
        na = self.opt.norm_abund
        if na == "mean":
            t.coverage = t.qlens / t.genome_size
        elif na == "min":
            vals = [c for c in t.qlen if c != 0]
            t.coverage = (min(vals) if vals else 0) * len(t.qlen) / t.genome_size
        else:
            vals = [c for c in t.qlen if c != 0]
            t.coverage = (max(vals) if vals else 0) * len(t.qlen) / t.genome_size

    # --------------------------------------------------------------- run

    def run(self, flat: FlatInput) -> list[Target]:
        opt, p = self.opt, self.p
        self.total_queries = flat.total_queries
        self.n_reads = float(flat.n_groups)
        if self.level_species:
            self._species = species_ids(flat, self.taxdb, self.taxid_map)
        else:
            self._species = np.full(flat.n_targets, -1, dtype=np.int64)

        # ---------------- stage 1
        all_t = np.ones(flat.n_targets, dtype=bool)
        st1 = self._stage_state(flat, all_t)
        self.n_reads = float((st1.n_t > 0).sum())
        # stage-1 uniq condition: n_targets==1 or same-species (strain
        # level: only n==1); weight always 1
        match, _, uniq, uniq_hic, _, _ = self._accumulate_stage1(flat, st1)
        prof1 = {}
        off = flat.frag_off
        for t in range(flat.n_targets):
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

        # ---------------- stage 2: pairwise ambiguity counts
        allowed = np.zeros(flat.n_targets, dtype=bool)
        allowed[list(prof1.keys())] = True
        amb: dict[tuple[int, int], float] = {}
        st_allowed = self._stage_state(flat, allowed)
        if not opt.no_amb_corr:
            self._count_amb(flat, st_allowed, amb)

        # ---------------- stage 3: disambiguate + recount
        # dense per-target arrays (zeros are unreachable: stage-3 groups
        # only contain prof1 survivors)
        sum_match1 = np.zeros(flat.n_targets)
        sum_uniq1 = np.zeros(flat.n_targets)
        for t, v in prof1.items():
            sum_match1[t] = v[0]
            sum_uniq1[t] = v[1]
        gt_deleted = self._megapath_deletions(
            flat, st_allowed, amb, sum_match1, sum_uniq1
        )
        st3 = self._stage_state(flat, allowed, gt_deleted)
        prop3 = np.zeros(flat.n_gt)
        prop3[st3.gt_idx] = 1.0 / np.maximum(
            st3.n_t[flat.gt_group[st3.gt_idx]], 1
        )
        match, qlen_arr, uniq, uniq_hic, _, _ = self._accumulate(
            flat, st3, prop3, mode="stage3"
        )
        prof2 = self._sum_targets(
            flat, match, qlen_arr, uniq, uniq_hic, check=True
        )

        # ---------------- stage 4: EM
        coverages = np.zeros(flat.n_targets)
        for t, tg in prof2.items():
            coverages[t] = tg.coverage
        whitelist = np.zeros(flat.n_targets, dtype=bool)
        whitelist[list(prof2.keys())] = True
        targets: list[Target] = []
        dom_prev = 0.0
        for it in range(opt.max_iters + 1):
            st4 = self._stage_state(flat, whitelist)
            gt_idx4 = st4.gt_idx
            # E-step proportions: coverage shares within each read
            cov_gt = coverages[flat.gt_target[gt_idx4]]
            covsum = np.zeros(flat.n_groups)
            np.add.at(covsum, flat.gt_group[gt_idx4], cov_gt)
            prop = np.zeros(flat.n_gt)
            grp4 = flat.gt_group[gt_idx4]
            is_amb = st4.n_t[grp4] > 1
            denom = covsum[grp4]
            pr = np.where(
                is_amb & (denom > 0), cov_gt / np.where(denom > 0, denom, 1),
                1.0,
            )
            prop[gt_idx4] = pr
            self.n_assigned = float((st4.n_t > 0).sum())
            match, qlen_arr, uniq, uniq_hic, unique_gt, amb_ss = (
                self._accumulate(flat, st4, prop, mode="em")
            )
            prof3 = self._sum_targets(
                flat, match, qlen_arr, uniq, uniq_hic, check=(it == 0)
            )
            # scores: 90th percentile of unique-match qcov
            self._add_scores(flat, prof3, unique_gt, amb_ss)
            targets = list(prof3.values())
            coverages = np.zeros(flat.n_targets)
            whitelist = np.zeros(flat.n_targets, dtype=bool)
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

        return self._finalize_targets(targets)

    def _finalize_targets(self, targets):
        """Final sort + low-pct tail filter + name map / taxonomy —
        shared with the spilled chunk runner (profile/spill.py) so the
        two engines cannot silently diverge here."""
        opt = self.opt
        if opt.mode == 0:
            targets.sort(
                key=lambda t: (-(t.score * t.frags_prop), -t.score,
                               -t.frags_prop, -t.sum_match)
            )
        else:
            targets.sort(key=lambda t: (-t.coverage, -t.frags_prop))
        if opt.filter_low_pct > 0 and len(targets) > 1:
            acc = 0.0
            n = 0
            for t in reversed(targets):
                acc += t.percentage
                if acc > opt.filter_low_pct:
                    break
                n += 1
            if n > 0:
                targets = targets[: len(targets) - n]
                sc = sum(t.coverage for t in targets)
                for t in targets:
                    t.percentage = t.coverage / sc * 100
        for t in targets:
            if opt.name_map:
                t.refname = opt.name_map.get(t.name, "")
            if self.taxid_map and self.taxdb:
                taxid = self.taxid_map.get(t.name)
                if taxid is not None:
                    from .core import Profiler

                    Profiler._add_taxonomy(self, t, taxid)
        return targets

    # ------------------------------------------------- binning (reuse core)

    def _taxid_of(self, name: str) -> int:
        t = self.taxid_map.get(name)
        if t is None:
            raise SystemExit(f"unknown taxid for {name}")
        return t

    def binning(self, flat: FlatInput, targets):
        return self._binning_flat(flat, targets)

    def _binning_flat(self, flat: FlatInput, targets):
        """Columnar per-read LCA assignment (profile.go:2619-2778): keep
        profiled targets, single-target groups take that target's taxid,
        multi-target groups take the LCA; query ids decode lazily."""
        name_to_tid = {n: i for i, n in enumerate(flat.target_names)}
        whitelist = np.zeros(flat.n_targets, dtype=bool)
        for t in targets:
            tid = name_to_tid.get(t.name)
            if tid is not None:
                whitelist[tid] = True
        t_tax = np.array(
            [self._taxid_of(n) for n in flat.target_names], dtype=np.int64
        )
        st = self._stage_state(flat, whitelist)
        keep = st.gt_idx
        if len(keep) == 0:
            return
        groups = flat.gt_group[keep]  # sorted (gt order is group-major)
        tgts = flat.gt_target[keep]
        starts = np.flatnonzero(
            np.concatenate(([True], groups[1:] != groups[:-1]))
        )
        ends = np.concatenate((starts[1:], [len(groups)]))
        lca = self.taxdb.lca_many
        for s, e in zip(starts, ends):
            g = int(groups[s])
            q = _flat_group_query(flat, g)
            if e - s == 1:
                yield q, int(t_tax[tgts[s]])
            else:
                yield q, lca([int(t_tax[t]) for t in tgts[s:e]])

    # ------------------------------------------------------------ helpers

    def _accumulate_stage1(self, flat, st: _StageState):
        """Stage-1 variant: unique weight 1 (even for same-species
        ambiguous reads, profile.go:851-861); match += 1/msize per row."""
        p = self.p
        hic_qcov = p["hic_qcov"]
        nfs = flat.n_frag_slots
        match = np.zeros(nfs)
        uniq = np.zeros(nfs)
        uniq_hic = np.zeros(nfs)
        grp = flat.gt_group[st.gt_idx]
        count_uniq = (st.n_t[grp] == 1) | st.same_sp[grp]
        sel = st.gt_idx[count_uniq]
        tf = flat.gt_first_tf[sel]
        np.add.at(uniq, tf, 1.0)
        hm = flat.gt_first_qcov[sel] >= hic_qcov
        np.add.at(uniq_hic, tf[hm], 1.0)
        np.add.at(match, flat.row_tf[st.row_sel], st.row_inv)
        return match, None, uniq, uniq_hic, sel, None

    def _count_amb(self, flat, st_allowed: _StageState, amb: dict):
        """Stage-2 pairwise co-occurrence counts over ambiguous reads
        (profile.go:1118-1279), merged into ``amb`` (shared with the
        spilled chunk runner, which calls this per chunk)."""
        gt_idx2 = st_allowed.gt_idx
        ambig = st_allowed.n_t[flat.gt_group[gt_idx2]] > 1
        gsel = gt_idx2[ambig]
        order = np.lexsort((flat.gt_target[gsel], flat.gt_group[gsel]))
        gsel = gsel[order]
        gids = flat.gt_group[gsel]
        tids = flat.gt_target[gsel].astype(np.int64)
        starts = np.flatnonzero(
            np.concatenate(([True], gids[1:] != gids[:-1]))
        )
        ends = np.concatenate((starts[1:], [len(gids)]))
        sizes = ends - starts
        # 2-target groups (the vast majority): targets ascend within
        # a group (the lexsort above), so the pair key is already
        # (min, max) — count all pairs with one np.unique
        two = starts[sizes == 2]
        if len(two):
            C = int(flat.n_targets)
            ks, cnts = np.unique(
                tids[two] * C + tids[two + 1], return_counts=True
            )
            for k, c in zip(ks.tolist(), cnts.tolist()):
                key = (k // C, k % C)
                amb[key] = amb.get(key, 0.0) + c
        for s, e in zip(starts[sizes > 2], ends[sizes > 2]):
            seg = tids[s:e]
            for i in range(len(seg) - 1):
                for j in range(i + 1, len(seg)):
                    k = (int(seg[i]), int(seg[j]))
                    amb[k] = amb.get(k, 0.0) + 1

    def _megapath_deletions(self, flat, st: _StageState, amb, sum_match,
                            sum_uniq):
        """Per-group pairwise deletions (profile.go:1341-1387); loops only
        over ambiguous groups of the stage's surviving GTs."""
        opt = self.opt
        one_minus = 1 - opt.min_dreads_prop
        mm = opt.max_mismatch_err
        deleted = np.zeros(flat.n_gt, dtype=bool)
        if opt.no_amb_corr:
            return deleted
        idx = st.gt_idx
        groups = flat.gt_group[idx]
        sel = idx[st.n_t[groups] > 1]
        # order GTs within group by first qcov desc (reference sorts by
        # the best match's qcov, profile.go:1351-1353)
        order = np.lexsort(
            (-flat.gt_first_qcov[sel], flat.gt_group[sel])
        )
        sel = sel[order]
        gids = flat.gt_group[sel]
        starts = np.flatnonzero(
            np.concatenate(([True], gids[1:] != gids[:-1]))
        )
        ends = np.concatenate((starts[1:], [len(gids)]))
        sizes = ends - starts
        # vectorized fast path for 2-target groups (the overwhelming
        # majority of ambiguous reads): one i=0,j=1 comparison each,
        # exactly the reference's loop order (cond1 -> dead[j], elif
        # cond2 -> dead[i])
        two = starts[sizes == 2]
        if len(two):
            a = sel[two]
            b = sel[two + 1]
            ha = flat.gt_target[a].astype(np.int64)
            hb = flat.gt_target[b].astype(np.int64)
            lo = np.minimum(ha, hb)
            hi = np.maximum(ha, hb)
            shared = np.fromiter(
                (amb.get((int(x), int(y)), 0.0) for x, y in zip(lo, hi)),
                np.float64, len(lo),
            )
            del_b = (sum_match[ha] * one_minus >= shared) & (
                sum_uniq[hb] < sum_uniq[ha] * mm
            )
            del_a = ~del_b & (sum_match[hb] * one_minus >= shared) & (
                sum_uniq[ha] < sum_uniq[hb] * mm
            )
            deleted[b[del_b]] = True
            deleted[a[del_a]] = True
        for s, e in zip(starts[sizes > 2], ends[sizes > 2]):
            seg = sel[s:e]
            tlist = flat.gt_target[seg]
            n = len(seg)
            dead = [False] * n
            for i in range(n - 1):
                if dead[i]:
                    continue
                for j in range(i + 1, n):
                    if dead[j]:
                        continue
                    hi, hj = int(tlist[i]), int(tlist[j])
                    k = (hi, hj) if hi < hj else (hj, hi)
                    shared = amb.get(k, 0.0)
                    if (
                        sum_match[hi] * one_minus >= shared
                        and sum_uniq[hj] < sum_uniq[hi] * mm
                    ):
                        dead[j] = True
                    elif (
                        sum_match[hj] * one_minus >= shared
                        and sum_uniq[hi] < sum_uniq[hj] * mm
                    ):
                        dead[i] = True
            for i, gt in enumerate(seg):
                if dead[i]:
                    deleted[gt] = True
        return deleted

    def _add_scores(self, flat, prof3, unique_gt, amb_ss):
        """90th percentile of unique-match qcov per target."""
        if amb_ss is None or len(amb_ss) == 0:
            sel = unique_gt
        else:
            sel = np.concatenate([unique_gt, amb_ss])
        if len(sel) == 0:
            return
        t = flat.gt_target[sel]
        v = flat.gt_first_qcov[sel]
        order = np.argsort(t, kind="stable")
        t, v = t[order], v[order]
        bounds = np.flatnonzero(np.diff(t)) + 1
        for tt, vals in zip(
            t[np.concatenate([[0], bounds])] if len(t) else [],
            np.split(v, bounds),
        ):
            tg = prof3.get(int(tt))
            if tg is not None:
                tg.score = float(np.percentile(vals, 90)) * 100
