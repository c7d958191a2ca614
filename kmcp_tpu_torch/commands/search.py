"""``search`` on a torch device: single-end reads or read pairs streamed
against a one-block DB or a multi-block ``--block-screen --uniform-sigs``
DB.

Port of kmcp_tpu/commands/search.py:74 ``run_search`` for the streaming
path, and of its ``iter_queries`` (:20) for reads and pairs.  Searches the
slice does not cover raise ``NotImplementedError`` naming the ROADMAP item
that will add them; nothing falls back to another engine.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

from ..index.format import find_db_dirs
from ..search.engine import SearchEngine, SearchOptions
from ..search.stream import TorchStreamSearcher, unsupported
from ..search.tsv import HEADER, write_stats
from ..seqio.fastx import read_fastx, xopen


def iter_queries(files: list[str], read1: str | None = None,
                 read2: str | None = None):
    """Yield (id, seq1, seq2) pairs from ``read1`` and ``read2`` zipped
    (``files`` are then ignored, as in kmcp_tpu/commands/search.py:30-45),
    else (id, seq, None) single-end queries from ``read1`` or ``read2`` (one
    of ``-1`` / ``-2`` alone), then ``files``, in order."""
    if read1 and read2:
        it1, it2 = read_fastx(read1), read_fastx(read2)
        for r1, r2 in zip(it1, it2):
            yield r1.id, r1.seq, r2.seq
        leftover = next(it1, None) or next(it2, None)
        if leftover is not None:
            print(
                "[search] WARNING: -1/-2 files have unequal record counts; "
                f"extra records from '{leftover.id}' on were ignored",
                file=sys.stderr,
            )
        return
    first = read1 or read2
    for file in ([first] if first else []) + list(files):
        for rec in read_fastx(file):
            yield rec.id, rec.seq, None


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def run_search(
    db_dir: str,
    files: list[str] | None = None,
    read1: str | None = None,
    read2: str | None = None,
    out_file: str = "-",
    opt: SearchOptions | None = None,
    whole_file: bool = False,
    no_header_row: bool = False,
    device="cuda",
    verbose: bool = True,
    stats: dict | None = None,
    pass2: str = "auto",
) -> tuple[int, int]:
    """Search reads, or the pairs of ``read1`` and ``read2``, against
    ``db_dir`` on ``device``; returns (total, matched).  ``pass2`` picks
    the screened pass-2 kernel of a multi-block DB ("pair", "gemm" or
    "auto").  ``stats``, when given, receives the
    streamer's ``slow_rows`` and ``retries``, the DB's Bloom ``rows``, row
    ``words`` and ``n_blocks``, the pass-2 kernel that ran (``pass2``,
    None for one block), the union screen's ``union_rows`` and the active
    (read, block) ``pairs`` of pass 2 (both 0 for one block)."""
    paired = bool(read1 and read2)
    # the query-FPR cache's size follows the mode (fpr.py)
    opt = dataclasses.replace(opt or SearchOptions(), paired_fpr_buf=paired)
    if whole_file:
        raise NotImplementedError(
            "whole-file queries (-g) need the object-engine counter "
            "(ROADMAP A8)"
        )
    dev = resolve_device(device)
    db_dirs = find_db_dirs(db_dir)
    if not db_dirs:
        raise SystemExit(f"kmcp-tpu-torch search: invalid database: {db_dir}")
    engine = SearchEngine(db_dirs, opt)
    reason = unsupported(engine, paired)
    if reason:
        raise NotImplementedError(reason)
    if opt.load_default_name_map and not opt.name_map:
        nm_path = os.path.join(db_dirs[0], "name_mapping.tsv")
        if os.path.isfile(nm_path):
            with open(nm_path) as f:
                opt.name_map = dict(
                    line.rstrip("\n").split("\t", 1)
                    for line in f if line.strip()
                )
    if verbose:
        print(
            "[search] main parameters:\n"
            f"  database: {db_dir}\n"
            f"  device: {dev}, min-query-len: {opt.min_query_len}, "
            f"min-kmers: {opt.min_kmers}, query-cov: {opt.min_query_cov}, "
            f"target-cov: {opt.min_target_cov}, max-fpr: {opt.max_fpr}",
            file=sys.stderr,
        )
    t0 = time.time()
    streamer = TorchStreamSearcher(engine, dev, pass2)
    out = sys.stdout if out_file == "-" else xopen(out_file, "wt")
    try:
        if not no_header_row:
            out.write(HEADER)
        total, matched = streamer.run(
            iter_queries(files or [], read1, read2), out, paired=paired,
        )
        write_stats(out, total, matched)
    finally:
        if out is not sys.stdout:
            out.close()
    if verbose:
        el = time.time() - t0
        print(
            f"[search] processed {total} queries at "
            f"{total / el if el > 0 else 0:.1f} queries/s on {dev}; "
            f"{matched / total * 100 if total else 0.0:.4f}% matched",
            file=sys.stderr,
        )
    if stats is not None:
        ddb = streamer.dev
        stats.update(slow_rows=streamer.slow_rows, retries=streamer.retries,
                     rows=ddb.total_rows, words=ddb.w, n_blocks=ddb.n_blocks,
                     pass2=ddb.pass2,
                     union_rows=ddb.screen["num_bits"] if ddb.screen else 0,
                     pairs=ddb.tail_stats["pairs"] if ddb.screen else 0)
    return total, matched
