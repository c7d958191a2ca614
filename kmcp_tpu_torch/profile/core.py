"""Four-stage taxonomic profiler with EM abundance estimation.

The port's copy of kmcp_tpu/profile/core.py, the reference-faithful
engine (``KMCP_TPU_PROFILE_ENGINE=reference`` and ``--debug``), kept in
NumPy and Python floats on the host so its output is kmcp_tpu's byte for
byte.  It re-implements KMCP's ``kmcp profile`` (cmd/profile.go:183-2590,
util-profile.go) stage by stage:

1. Count matches / unique matches per target chunk; drop targets without a
   unique + high-confidence-unique read or with low chunk fraction
   (profile.go:761-1115).
2. Count pairwise co-occurrence of surviving targets over ambiguous reads
   (profile.go:1118-1279, two-stage MegaPath algorithm).
3. Re-stream: drop the weaker target of ambiguous pairs when
   ``SumMatch_i*(1-minDReadsProp) >= shared`` and
   ``SumUniq_j < SumUniq_i*maxMismatchErr`` (profile.go:1357-1387);
   recount with equal redistribution; apply full filters (min uniq reads,
   hic reads + proportion, chunk fraction with ``-r`` reads, chunk depth
   stdev) and initialize coverage — the first M-step (profile.go:1282-1904).
4. EM: E-step assigns each ambiguous read to targets proportionally to
   current coverage, M-step recomputes coverage/percentage; stop when the
   dominant target's percentage changes < threshold (profile.go:1977-2570).

The input is parsed once into grouped per-read match lists and re-iterated
per stage (the reference re-reads the TSV from disk each pass; we keep the
compact parsed form in memory — identical semantics, ~50 bytes/row).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field

import numpy as np

from ..seqio.fastx import xopen
from .taxonomy import Taxonomy


@dataclass
class ProfileOptions:
    mode: int = 3
    max_fpr: float = 0.01
    min_qcov: float = 0.55
    keep_top_qcovs: int = 0
    keep_perfect_matches: bool = False
    # mode-preset parameters (None = use preset)
    min_chunks_reads: int | None = None
    min_chunks_fraction: float | None = None
    max_chunks_depth_stdev: float | None = None
    min_uniq_reads: int | None = None
    min_hic_ureads: int | None = None
    min_hic_ureads_qcov: float | None = None
    min_hic_ureads_prop: float | None = None
    keep_main_matches: bool | None = None
    max_qcov_gap: float | None = None
    #
    min_dreads_prop: float = 0.05
    max_mismatch_err: float = 0.05
    filter_low_pct: float = 0.0
    level: str = "species"  # species | strain
    norm_abund: str = "mean"  # mean | min | max
    max_iters: int = 10
    abund_pct_threshold: float = 0.01
    no_amb_corr: bool = False
    name_map: dict[str, str] = field(default_factory=dict)


# preset table (profile.go:241-313); mode 3 uses the flag defaults
# (profile.go:3172-3181)
PRESETS = {
    0: dict(min_reads=1, min_frags_prop=0.2, max_depth_stdev=10,
            min_ureads=1, min_hic_ureads=1, hic_qcov=0.7, hic_prop=0.01,
            keep_main=True, max_gap=0.4),
    1: dict(min_reads=5, min_frags_prop=0.6, max_depth_stdev=2,
            min_ureads=2, min_hic_ureads=1, hic_qcov=0.7, hic_prop=0.1,
            keep_main=False, max_gap=0.4),
    2: dict(min_reads=10, min_frags_prop=0.7, max_depth_stdev=2,
            min_ureads=5, min_hic_ureads=2, hic_qcov=0.7, hic_prop=0.2,
            keep_main=False, max_gap=0.4),
    3: dict(min_reads=50, min_frags_prop=0.8, max_depth_stdev=2,
            min_ureads=20, min_hic_ureads=5, hic_qcov=0.75, hic_prop=0.1,
            keep_main=False, max_gap=0.4),
    4: dict(min_reads=100, min_frags_prop=1, max_depth_stdev=2,
            min_ureads=50, min_hic_ureads=10, hic_qcov=0.8, hic_prop=0.1,
            keep_main=False, max_gap=0.4),
    5: dict(min_reads=100, min_frags_prop=1, max_depth_stdev=1.5,
            min_ureads=50, min_hic_ureads=10, hic_qcov=0.8, hic_prop=0.15,
            keep_main=False, max_gap=0.4),
}


def resolve_params(opt: ProfileOptions) -> dict:
    p = dict(PRESETS[opt.mode])
    overrides = [
        ("min_reads", opt.min_chunks_reads),
        ("min_frags_prop", opt.min_chunks_fraction),
        ("max_depth_stdev", opt.max_chunks_depth_stdev),
        ("min_ureads", opt.min_uniq_reads),
        ("min_hic_ureads", opt.min_hic_ureads),
        ("hic_qcov", opt.min_hic_ureads_qcov),
        ("hic_prop", opt.min_hic_ureads_prop),
        ("keep_main", opt.keep_main_matches),
        ("max_gap", opt.max_qcov_gap),
    ]
    for key, val in overrides:
        if val is not None:
            p[key] = val
    # -U bumps -u (profile.go:369-371)
    if p["min_hic_ureads"] > p["min_ureads"]:
        p["min_ureads"] = p["min_hic_ureads"]
    return p


# ---------------------------------------------------------------------------
# parsed representation


@dataclass
class MatchRow:
    target: int  # interned target id
    frag_idx: int
    idx_num: int
    gsize: int
    qlen: int
    qcov: float


class ParsedInput:
    """One search-result file parsed into per-read groups."""

    def __init__(self):
        self.groups: list[list[MatchRow]] = []
        self.queries: list[str] = []  # query id per group (for binning)
        self.target_names: list[str] = []
        self.total_queries = 0  # from '# input queries:' stat lines


def parse_search_tsv(files: list[str], max_fpr: float, min_qcov: float) -> ParsedInput:
    """Parse + row-filter (qCov >= min, FPR <= max; util-profile.go:94-182),
    grouping consecutive rows of the same query."""
    out = ParsedInput()
    intern: dict[str, int] = {}
    names = out.target_names
    for path in files:
        prev_query = None
        cur: list[MatchRow] = []
        with xopen(path, "rt") as f:
            for line in f:
                if not line or line[0] == "#":
                    if line.startswith("# input queries:"):
                        out.total_queries += int(line.split(":")[1])
                    continue
                items = line.rstrip("\n").split("\t")
                if len(items) < 13:
                    raise SystemExit("invalid kmcp search result format")
                qcov = float(items[11])
                if qcov < min_qcov:
                    continue
                fpr = float(items[3])
                if fpr > max_fpr:
                    continue
                query = items[0]
                tname = items[5]
                tid = intern.get(tname)
                if tid is None:
                    tid = len(names)
                    intern[tname] = tid
                    names.append(tname)
                row = MatchRow(
                    target=tid,
                    frag_idx=int(items[6]),
                    idx_num=int(items[7]),
                    gsize=int(items[8]),
                    qlen=int(items[1]),
                    qcov=qcov,
                )
                if query != prev_query and prev_query is not None:
                    if cur:
                        out.groups.append(cur)
                        out.queries.append(prev_query)
                    cur = []
                cur.append(row)
                prev_query = query
        if cur:
            out.groups.append(cur)
            out.queries.append(prev_query)
    return out


def apply_prefilters(
    rows: list[MatchRow],
    keep_full: bool,
    keep_main: bool,
    max_gap: float,
    top_n: int,
    allowed: set[int] | None = None,
) -> list[MatchRow]:
    """Per-query match pre-filters, replicating the exact streaming pScore
    logic (profile.go:878-919).  ``allowed`` drops rows of unwanted targets
    BEFORE the filters, as stages 2+ do (profile.go:1163-1166)."""
    out: list[MatchRow] = []
    p_score = 1024.0
    n_score = 0
    process = True
    for m in rows:
        if allowed is not None and m.target not in allowed:
            continue
        if out:  # not the first processed match
            if keep_full:
                if not process:
                    continue
                if p_score == 1 and m.qcov < 1:
                    process = False
                    continue
            elif keep_main and p_score <= 1:
                if not process:
                    continue
                if p_score - m.qcov > max_gap:
                    process = False
                    continue
        if top_n > 0:
            if not process:
                continue
            if m.qcov < p_score:
                n_score += 1
                if n_score > top_n:
                    process = False
                    continue
        out.append(m)
        p_score = m.qcov
    return out


def group_by_target(rows: list[MatchRow]) -> dict[int, list[MatchRow]]:
    g: dict[int, list[MatchRow]] = {}
    for m in rows:
        g.setdefault(m.target, []).append(m)
    return g


# ---------------------------------------------------------------------------


class Target:
    __slots__ = (
        "name", "genome_size", "match", "qlen", "uniq", "uniq_hic",
        "sum_match", "sum_uniq", "sum_uniq_hic", "frags_prop", "coverage",
        "qlens", "rel_depth", "rel_depth_std", "qcov_uniq", "qcov_all",
        "percentage", "score", "taxid", "rank", "taxname", "lineage_names",
        "lineage_taxids", "complete_lineage_taxids", "refname",
    )

    def __init__(self, name: str, gsize: int, idx_num: int):
        self.name = name
        self.genome_size = gsize
        self.match = [0.0] * idx_num
        self.qlen = [0.0] * idx_num
        self.uniq = [0.0] * idx_num
        self.uniq_hic = [0.0] * idx_num
        self.sum_match = 0.0
        self.sum_uniq = 0.0
        self.sum_uniq_hic = 0.0
        self.frags_prop = 0.0
        self.coverage = 0.0
        self.qlens = 0.0
        self.rel_depth = [0.0] * idx_num
        self.rel_depth_std = 0.0
        self.qcov_uniq: list[float] = []
        self.qcov_all: list[float] = []
        self.percentage = 0.0
        self.score = 0.0
        self.taxid = 0
        self.rank = ""
        self.taxname = ""
        self.lineage_names: list[str] = []
        self.lineage_taxids: list[str] = []
        self.complete_lineage_taxids: list[int] = []
        self.refname = ""


def mean_stdev(values) -> tuple[float, float]:
    """Population standard deviation (util.go:381-404)."""
    n = len(values)
    if n == 0:
        return 0.0, 0.0
    if n == 1:
        return values[0], 0.0
    mean = sum(values) / n
    var = sum((v - mean) ** 2 for v in values)
    return mean, math.sqrt(var / n)


def percentile90(values: list[float]) -> float:
    """90th percentile of qCov values (stats.Quantiler.Percentile(90))."""
    if not values:
        return 0.0
    a = np.asarray(values, dtype=np.float64)
    return float(np.percentile(a, 90))


def gofmt(x: float) -> str:
    """Go fmt's %v for float64 (strconv.FormatFloat 'g' -1): shortest
    round-trip representation, integers without trailing '.0'."""
    s = repr(float(x))
    if s.endswith(".0"):
        s = s[:-2]
    return s


def gofmt_vec(values) -> str:
    """Go fmt's %v for []float64: '[a b c]'."""
    return "[" + " ".join(gofmt(v) for v in values) + "]"


class Profiler:
    def __init__(
        self,
        opt: ProfileOptions,
        taxdb: Taxonomy | None = None,
        taxid_map: dict[str, int] | None = None,
        debug_out=None,
    ):
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
        self.debug_out = debug_out

    # ------------------------------------------------------------- helpers

    def _dbg_name(self, t: Target) -> str:
        """'name (taxname)' when a taxdump is loaded, else 'name'
        (profile.go:1024-1035 etc.)."""
        if self.taxdb is not None:
            return f"{t.name} ({self.taxdb.name(self.taxid_map.get(t.name, 0))})"
        return t.name

    def _dbg_failed(self, tag: str, t: Target, reason: str, value: str):
        """One rejection-trace line, format of profile.go:1024-1095 /
        1750-1857 / 2377-2477."""
        self.debug_out.write(
            f"{tag}: {self._dbg_name(t)}, 90th percentile: "
            f"{percentile90(t.qcov_all):.2f}, {reason}: {value}\n"
        )

    def _taxid_of(self, name: str) -> int:
        t = self.taxid_map.get(name)
        if t is None:
            raise SystemExit(
                f"unknown taxid for {name}, please check taxid mapping file(s)"
            )
        return t

    def _same_species(self, parsed: ParsedInput, target_ids) -> bool:
        taxids = [
            self._taxid_of(parsed.target_names[t]) for t in target_ids
        ]
        lca = self.taxdb.lca_many(taxids)
        return self.taxdb.at_or_below_rank(lca, "species")

    def _prefilter(self, rows, allowed=None):
        o = self.opt
        return apply_prefilters(
            rows,
            o.keep_perfect_matches,
            self.p["keep_main"],
            self.p["max_gap"],
            o.keep_top_qcovs,
            allowed,
        )

    # ------------------------------------------------------------- stage 1

    def stage1(self, parsed: ParsedInput) -> dict[int, Target]:
        opt, p = self.opt, self.p
        profile: dict[int, Target] = {}
        hic_qcov = p["hic_qcov"]
        for rows in parsed.groups:
            rows = self._prefilter(rows)
            if not rows:
                continue
            self.n_reads += 1
            matches = group_by_target(rows)
            same_species = False
            if self.level_species and len(matches) > 1:
                same_species = self._same_species(parsed, matches.keys())
            uniq = len(matches) == 1 or same_species
            for tid, ms in matches.items():
                t = profile.get(tid)
                if t is None:
                    m0 = ms[0]
                    t = Target(
                        parsed.target_names[tid], m0.gsize, m0.idx_num
                    )
                    profile[tid] = t
                inv = 1.0 / len(ms)
                m0 = ms[0]
                if uniq:
                    t.uniq[m0.frag_idx] += 1
                    if m0.qcov >= hic_qcov:
                        t.uniq_hic[m0.frag_idx] += 1
                t.qcov_all.append(m0.qcov)
                for m in ms:
                    t.match[m.frag_idx] += inv

        # sum up + filter (profile.go:1013-1099)
        dbg = self.debug_out
        if dbg is not None:
            dbg.write("#------------------ round 1 ------------------\n")
        drop = []
        for tid, t in profile.items():
            t.sum_uniq = sum(t.uniq)
            if t.sum_uniq < 1:
                drop.append(tid)
                if dbg is not None:
                    self._dbg_failed(
                        "failed1", t, "no enough unique match",
                        f"{t.sum_uniq:.0f}",
                    )
                continue
            t.sum_uniq_hic = sum(t.uniq_hic)
            if t.sum_uniq_hic < 1:
                drop.append(tid)
                if dbg is not None:
                    self._dbg_failed(
                        "failed1", t,
                        "no enough high-confidence unique match",
                        f"{t.sum_uniq_hic:.0f}",
                    )
                continue
            frags = sum(1 for c in t.match if c > 0)
            t.sum_match = sum(t.match)
            t.frags_prop = frags / len(t.match)
            if t.frags_prop < p["min_frags_prop"]:
                drop.append(tid)
                if dbg is not None:
                    self._dbg_failed(
                        "failed1", t, "low chunks fraction",
                        f"{t.frags_prop:.1f} {gofmt_vec(t.match)}",
                    )
        for tid in drop:
            del profile[tid]
        return profile

    # ------------------------------------------------------------- stage 2

    def stage2(self, parsed: ParsedInput, profile: dict[int, Target]):
        """Pairwise co-occurrence counts over ambiguous reads
        (profile.go:1127-1271).  Keyed by sorted (tidA, tidB)."""
        amb: dict[tuple[int, int], float] = {}
        if self.opt.no_amb_corr:
            return amb
        allowed = set(profile.keys())
        for rows in parsed.groups:
            rows = self._prefilter(rows, allowed)
            if not rows:
                continue
            tids = sorted({m.target for m in rows})
            if len(tids) < 2:
                continue
            for i in range(len(tids) - 1):
                for j in range(i + 1, len(tids)):
                    key = (tids[i], tids[j])
                    amb[key] = amb.get(key, 0.0) + 1
        return amb

    # ------------------------------------------------------------- stage 3

    def stage3(self, parsed, profile, amb) -> dict[int, Target]:
        opt, p = self.opt, self.p
        profile2: dict[int, Target] = {}
        allowed = set(profile.keys())
        hic_qcov = p["hic_qcov"]
        one_minus_dprop = 1 - opt.min_dreads_prop
        max_mm = opt.max_mismatch_err

        for rows in parsed.groups:
            rows = self._prefilter(rows, allowed)
            if not rows:
                continue
            matches = group_by_target(rows)
            if len(matches) > 1 and not opt.no_amb_corr:
                # MegaPath disambiguation: order by best qcov desc
                hss = sorted(
                    matches.keys(), key=lambda h: -matches[h][0].qcov
                )
                deleted = [False] * len(hss)
                for i in range(len(hss) - 1):
                    if deleted[i]:
                        continue
                    for j in range(i + 1, len(hss)):
                        if deleted[j]:
                            continue
                        hi, hj = hss[i], hss[j]
                        key = (hi, hj) if hi < hj else (hj, hi)
                        shared = amb.get(key, 0.0)
                        ti, tj = profile[hi], profile[hj]
                        if (
                            ti.sum_match * one_minus_dprop >= shared
                            and tj.sum_uniq < ti.sum_uniq * max_mm
                        ):
                            deleted[j] = True
                        elif (
                            tj.sum_match * one_minus_dprop >= shared
                            and ti.sum_uniq < tj.sum_uniq * max_mm
                        ):
                            deleted[i] = True
                for i, h in enumerate(hss):
                    if deleted[i]:
                        del matches[h]

            if not matches:
                continue
            ambiguous = len(matches) > 1
            if ambiguous:
                same_species = False
                if self.level_species:
                    same_species = self._same_species(parsed, matches.keys())
                prop = 1.0 / len(matches)
            for tid, ms in matches.items():
                t = profile2.get(tid)
                if t is None:
                    m0 = ms[0]
                    t = Target(parsed.target_names[tid], m0.gsize, m0.idx_num)
                    profile2[tid] = t
                inv = 1.0 / len(ms)
                m0 = ms[0]
                if ambiguous:
                    if self.level_species and same_species:
                        t.uniq[m0.frag_idx] += inv
                        if m0.qcov >= hic_qcov:
                            t.uniq_hic[m0.frag_idx] += inv
                    t.qcov_all.append(m0.qcov)
                    for m in ms:
                        t.qlen[m.frag_idx] += m.qlen * prop * inv
                        t.match[m.frag_idx] += inv
                else:
                    t.uniq[m0.frag_idx] += 1
                    if m0.qcov >= hic_qcov:
                        t.uniq_hic[m0.frag_idx] += 1
                    t.qcov_all.append(m0.qcov)
                    for m in ms:
                        t.qlen[m.frag_idx] += m.qlen * inv
                        t.match[m.frag_idx] += inv

        # sum up + full filters + coverage init (profile.go:1743-1892)
        if self.debug_out is not None:
            self.debug_out.write(
                "\n\n#------------------ round 2 ------------------\n"
            )
        drop = []
        for tid, t in profile2.items():
            if not self._sum_and_filter(t, check=True, tag="failed2"):
                drop.append(tid)
                continue
            self._coverage(t)
        for tid in drop:
            del profile2[tid]
        return profile2

    def _sum_and_filter(self, t: Target, check: bool, tag: str = "") -> bool:
        """Shared round-2/3 sum-up with full filters; with ``tag`` and an
        open debug stream, rejections emit the reference's trace lines
        (profile.go:1743-1857 round 2, :2372-2477 round 3)."""
        p = self.p
        dbg = self.debug_out if (tag and self.debug_out is not None) else None
        t.sum_uniq = sum(t.uniq)
        if check and t.sum_uniq < p["min_ureads"]:
            if dbg is not None:
                self._dbg_failed(
                    tag, t, "no enough unique match", f"{t.sum_uniq:.0f}"
                )
            return False
        t.sum_uniq_hic = sum(t.uniq_hic)
        if check and t.sum_uniq_hic < p["min_hic_ureads"]:
            if dbg is not None:
                self._dbg_failed(
                    tag, t, "no enough high-confidence unique match",
                    f"{t.sum_uniq_hic:.0f}",
                )
            return False
        if check and t.sum_uniq_hic < p["hic_prop"] * t.sum_uniq:
            if dbg is not None:
                self._dbg_failed(
                    tag, t,
                    "no enough high-confidence unique match proportion",
                    f"{t.sum_uniq_hic / t.sum_uniq:.4f} "
                    f"({t.sum_uniq_hic:.0f}/{t.sum_uniq:.0f})",
                )
            return False
        frags = sum(1 for c in t.match if c >= p["min_reads"])
        t.sum_match = sum(t.match)
        t.frags_prop = frags / len(t.match)
        if check and t.frags_prop < p["min_frags_prop"]:
            if dbg is not None:
                self._dbg_failed(
                    tag, t, "low chunks fraction",
                    f"{t.frags_prop:.1f} {gofmt_vec(t.match)}",
                )
            return False
        t.qlens = sum(t.qlen)
        n = len(t.qlen)
        if t.qlens > 0:
            t.rel_depth = [c / t.qlens * n for c in t.qlen]
        _, t.rel_depth_std = mean_stdev(t.rel_depth)
        if check and t.rel_depth_std > p["max_depth_stdev"]:
            if dbg is not None:
                self._dbg_failed(
                    tag, t, "high FragsDepthStdev",
                    f"{t.rel_depth_std:f}",
                )
            return False
        return True

    def _coverage(self, t: Target):
        na = self.opt.norm_abund
        if na == "mean":
            t.coverage = t.qlens / t.genome_size
        elif na == "min":
            vals = [c for c in t.qlen if c != 0]
            t.coverage = (min(vals) if vals else 0) * len(t.qlen) / t.genome_size
        else:  # max
            vals = [c for c in t.qlen if c != 0]
            t.coverage = (max(vals) if vals else 0) * len(t.qlen) / t.genome_size

    # ------------------------------------------------------------- stage 4

    def stage4(self, parsed, profile2) -> list[Target]:
        """EM loop (profile.go:1977-2570)."""
        opt, p = self.opt, self.p
        hic_qcov = p["hic_qcov"]
        coverages = {tid: t.coverage for tid, t in profile2.items()}
        whitelist = set(profile2.keys())
        targets: list[Target] = []
        dom_pct_pre = 0.0
        mapping_taxids = bool(self.taxid_map)
        self.total_queries = parsed.total_queries

        for it in range(opt.max_iters + 1):
            profile3: dict[int, Target] = {}
            self.n_assigned = 0.0
            for rows in parsed.groups:
                rows = self._prefilter(rows, whitelist)
                if not rows:
                    continue
                matches = group_by_target(rows)
                ambiguous = len(matches) > 1
                self.n_assigned += 1
                if ambiguous:
                    sum_cov = sum(coverages[h] for h in matches)
                    same_species = False
                    if mapping_taxids and self.level_species:
                        same_species = self._same_species(
                            parsed, matches.keys()
                        )
                for tid, ms in matches.items():
                    t = profile3.get(tid)
                    if t is None:
                        m0 = ms[0]
                        t = Target(
                            parsed.target_names[tid], m0.gsize, m0.idx_num
                        )
                        profile3[tid] = t
                    inv = 1.0 / len(ms)
                    m0 = ms[0]
                    if ambiguous:
                        prop = (
                            coverages[tid] / sum_cov if sum_cov > 0 else 0.0
                        )
                        if self.level_species and same_species:
                            t.uniq[m0.frag_idx] += prop * inv
                            if m0.qcov >= hic_qcov:
                                t.uniq_hic[m0.frag_idx] += prop * inv
                            t.qcov_uniq.append(m0.qcov)
                        t.qcov_all.append(m0.qcov)
                        for m in ms:
                            t.qlen[m.frag_idx] += m.qlen * prop * inv
                            t.match[m.frag_idx] += prop * inv
                    else:
                        t.uniq[m0.frag_idx] += 1
                        if m0.qcov >= hic_qcov:
                            t.uniq_hic[m0.frag_idx] += 1
                        t.qcov_uniq.append(m0.qcov)
                        t.qcov_all.append(m0.qcov)
                        for m in ms:
                            t.qlen[m.frag_idx] += m.qlen * inv
                            t.match[m.frag_idx] += inv

            # sum up: filters only at initialization (iter 0)
            if self.debug_out is not None:
                self.debug_out.write(
                    "\n\n#------------------ round 3: "
                    + ("initialization step" if it == 0
                       else f"iteration #{it}")
                    + " ------------------\n"
                )
            targets = []
            whitelist = set()
            check = it == 0
            for tid, t in profile3.items():
                if not self._sum_and_filter(t, check=check, tag="failed3"):
                    continue
                self._coverage(t)
                t.score = percentile90(t.qcov_uniq) * 100
                targets.append(t)
                coverages[tid] = t.coverage
                whitelist.add(tid)

            sum_cov = sum(t.coverage for t in targets)
            for t in targets:
                t.percentage = (
                    t.coverage / sum_cov * 100 if sum_cov > 0 else 0.0
                )
            targets.sort(key=lambda t: -t.coverage)

            if self.debug_out is not None:
                # per-iteration abundance dump (profile.go:2531-2543)
                self.debug_out.write("Abundance:\n")
                for t in targets:
                    if self.taxdb is not None:
                        nm = self.taxdb.name(self.taxid_map.get(t.name, 0))
                        self.debug_out.write(
                            f"{nm:>50}\t{gofmt(t.percentage)}\n"
                        )
                    else:
                        self.debug_out.write(
                            f"{t.name}\t{gofmt(t.percentage)}\n"
                        )

            if it > 0 and targets:
                if abs(targets[0].percentage - dom_pct_pre) < opt.abund_pct_threshold:
                    if self.debug_out is not None:
                        self.debug_out.write(
                            "stop iterating after abundances being "
                            "converged\n"
                        )
                    break
            if not targets:
                break
            dom_pct_pre = targets[0].percentage

        return targets

    # ------------------------------------------------------------ binning

    def binning(self, parsed: ParsedInput, targets: list[Target]):
        """Per-read LCA assignment over profiled targets
        (profile.go:2619-2778).  Yields (query_id, taxid)."""
        name_to_tid = {n: i for i, n in enumerate(parsed.target_names)}
        whitelist = {
            name_to_tid[t.name] for t in targets if t.name in name_to_tid
        }
        for rows, query in zip(parsed.groups, parsed.queries):
            rows = self._prefilter(rows, whitelist)
            if not rows:
                continue
            matches = group_by_target(rows)
            if len(matches) > 1:
                taxids = [
                    self._taxid_of(parsed.target_names[h]) for h in matches
                ]
                yield query, self.taxdb.lca_many(taxids)
            else:
                (tid,) = matches.keys()
                yield query, self._taxid_of(parsed.target_names[tid])

    # ------------------------------------------------------------ run all

    def run(self, parsed: ParsedInput) -> list[Target]:
        profile1 = self.stage1(parsed)
        if not profile1:
            print("[profile] no target found, please adjust parameters",
                  file=sys.stderr)
            return []
        amb = self.stage2(parsed, profile1)
        profile2 = self.stage3(parsed, profile1, amb)
        targets = self.stage4(parsed, profile2)

        # final sort (profile.go:2788-2814)
        if self.opt.mode == 0:
            targets.sort(
                key=lambda t: (
                    -(t.score * t.frags_prop), -t.score, -t.frags_prop,
                    -t.sum_match,
                )
            )
        else:
            targets.sort(key=lambda t: (-t.coverage, -t.frags_prop))

        # filter-low-pct (profile.go:2816-2853)
        if self.opt.filter_low_pct > 0 and len(targets) > 1:
            acc = 0.0
            n = 0
            for t in reversed(targets):
                acc += t.percentage
                if acc > self.opt.filter_low_pct:
                    break
                n += 1
            if n > 0:
                targets = targets[: len(targets) - n]
                total_cov = sum(t.coverage for t in targets)
                for t in targets:
                    t.percentage = t.coverage / total_cov * 100

        # attach taxonomy + names
        for t in targets:
            if self.opt.name_map:
                t.refname = self.opt.name_map.get(t.name, "")
            if self.taxid_map and self.taxdb:
                taxid = self.taxid_map.get(t.name)
                if taxid is not None:
                    self._add_taxonomy(t, taxid)
        return targets

    def _add_taxonomy(self, t: Target, taxid: int):
        db = self.taxdb
        t.taxid = db.taxid(taxid)
        t.rank = db.rank_of(taxid)
        t.taxname = db.name(taxid)
        lineage = db.lineage_taxids(taxid)
        t.complete_lineage_taxids = lineage
        t.lineage_taxids = [str(x) for x in lineage]
        t.lineage_names = [db.names.get(x, "") for x in lineage]
