"""15-column search result TSV, byte-compatible with the reference.

The port's copy of kmcp_tpu/search/tsv.py.  Columns: query qLen qKmers
FPR hits target chunkIdx chunks tLen kSize mKmers qCov tCov jacc queryIdx.
Floats: qCov/tCov/jacc printed with %.4f, FPR with %.4e; three
machine-readable '#' stat lines are appended at the end.
"""

from __future__ import annotations

from typing import Iterable, TextIO

from .engine import QueryResult

HEADER = (
    "#query\tqLen\tqKmers\tFPR\thits\ttarget\tchunkIdx\tchunks\ttLen\t"
    "kSize\tmKmers\tqCov\ttCov\tjacc\tqueryIdx\n"
)


def format_fpr(x: float) -> str:
    """Go strconv.FormatFloat(x, 'e', 4, 64): the same digits."""
    return f"{x:.4e}"


def write_results(
    fh: TextIO,
    results: Iterable[QueryResult],
    keep_unmatched: bool = False,
) -> tuple[int, int]:
    """Stream result rows; returns (total, matched) query counts."""
    total = matched = 0
    w = fh.write
    for res in results:
        total += 1
        if not res.matches:
            if keep_unmatched:
                w(
                    f"{res.query_id}\t{res.query_len}\t{res.num_kmers}\t0\t0"
                    f"\t\t-1\t0\t0\t{res.k}\t0\t0\t0\t0\t{res.query_idx}\n"
                )
            continue
        matched += 1
        hits = len(res.matches)
        prefix = f"{res.query_id}\t{res.query_len}\t{res.num_kmers}\t"
        suffix = f"\t{res.query_idx}\n"
        for m in res.matches:
            w(
                prefix
                + format_fpr(m.fpr)
                + f"\t{hits}\t{m.target}\t{m.chunk_idx}\t{m.chunks}\t"
                f"{m.gsize}\t{res.k}\t{m.num_kmers}\t"
                f"{m.qcov:.4f}\t{m.tcov:.4f}\t{m.jacc:.4f}" + suffix
            )
    return total, matched


def write_stats(fh: TextIO, total: int, matched: int) -> None:
    pct = (matched / total * 100) if total else 0.0
    fh.write(f"# input queries: {total}\n")
    fh.write(f"# matched queries: {matched}\n")
    fh.write(f"# matched percentage: {pct:.4f}%\n")
