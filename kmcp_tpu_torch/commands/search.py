"""``search`` on a torch device or on the host: reads, read pairs or whole
files (``-g``) against one or more DBs.

Port of kmcp_tpu/commands/search.py (``iter_queries`` :20, ``run_search``
:74).  A search the streamer takes (search/stream.py ``usable``: single-end
reads or pairs against one DB, as the JAX streamer decides) streams on the
device; every other one (``-g``, several DBs, ``--low-mem``, other sort
orders, paired ``--try-se``, paired or multi-block sketch DBs, multi-block
DBs without union screens, non-canonical DBs) runs the object engine's
batch loop (:180-208), whose blocks count on the same device.  With the
host backend (``--backend host``) the streamer runs ``HostDB`` and the
object engine the C++ counter, with row seek under ``--low-mem``; no torch
device is opened.  With ``verbose`` the progress lines on stderr are
kmcp_tpu's, word for word; only the main-parameters block differs, naming
the device and the route.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from itertools import islice

import torch

from ..index.format import find_db_dirs
from ..search.engine import SearchEngine, SearchOptions
from ..search.stream import TorchStreamSearcher, usable
from ..search.tsv import HEADER, write_results, write_stats
from ..seqio.fastx import read_fastx, xopen
from ..utils import trace


def _file_query_id(path: str) -> str:
    """``-G``: the file's base name without .gz and its last extension."""
    rid = os.path.basename(path)
    if rid.endswith(".gz"):
        rid = rid[:-3]
    root = rid.rsplit(".", 1)
    return root[0] if len(root) == 2 else rid


def iter_queries(files: list[str], read1: str | None = None,
                 read2: str | None = None, whole_file: bool = False,
                 use_filename: bool = False, query_id: str = "",
                 k_max: int = 21):
    """Yield (id, seq1, seq2) pairs from ``read1`` and ``read2`` zipped
    (``files`` are then ignored), else (id, seq, None) queries from
    ``read1`` or ``read2`` (one of ``-1`` / ``-2`` alone), then ``files``,
    in order.  With ``whole_file`` (``-g``) each file is one query, its
    records joined by ``k_max - 1`` N's, named by ``use_filename`` (the
    file name), else ``query_id``, else its first record's id."""
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
        if not whole_file:
            for rec in read_fastx(file):
                yield rec.id, rec.seq, None
            continue
        seqs, rid = [], None
        for rec in read_fastx(file):
            if rid is None:
                rid = (_file_query_id(file) if use_filename
                       else query_id or rec.id)
            seqs.append(rec.seq)
        if seqs:
            yield rid, (b"N" * (k_max - 1)).join(seqs), None


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def run_engine(engine: SearchEngine, queries, out,
               batch_queries: int = 8192, progress=None) -> tuple[int, int]:
    """The object engine's batch loop: search ``queries`` in batches of
    ``batch_queries`` and write their rows; returns (total, matched).
    ``progress``, when given, is called with the queries done after each
    batch is written."""
    total = matched = 0
    it = iter(queries)
    while batch := list(islice(it, batch_queries)):
        t, m = write_results(out, engine.search_batch(batch, total),
                             engine.opt.keep_unmatched)
        total += t
        matched += m
        if progress is not None:
            progress(total)
    return total, matched


def _mqpm(done: int, t0: float) -> float | None:
    """Million queries a minute since ``t0``, None before the clock
    moves."""
    el = time.time() - t0
    return done / 1e6 / (el / 60) if el > 0 else None


def _stream_progress(done: int, t0: float) -> None:
    """kmcp_tpu's line for each drained batch (commands/search.py:147-155,
    the reference's every-8192-queries log)."""
    rate = _mqpm(done, t0)
    if rate is not None:
        print(f"[search] {done} queries done at {rate:.3f} M queries/min",
              file=sys.stderr)


def _engine_progress(done: int, t0: float) -> None:
    """kmcp_tpu's line for each object-engine batch, overwritten in place
    by the next (a carriage return first; :191-199)."""
    print(f"\rprocessed queries: {done}, speed: {_mqpm(done, t0) or 0:.3f} "
          "million queries per minute", end="", file=sys.stderr)


def _launches() -> dict:
    """Each kernel wrapper's launches so far."""
    from ..parallel.dryrun import kernel_wrappers

    return {n: k.launches for n, k in kernel_wrappers().items()}


STAGES = ("pull", "pack", "dispatch", "wait", "retry", "slow", "order",
          "emit")


def _trace_line(summary: dict, total: int, wall_s: float) -> str:
    """The closing line of a traced search: the streamer's stages in
    microseconds a query, the collector's share of the wall and the bytes
    each way a query, and the share of queries the dedup uniqued."""
    spans, c = summary["spans"], summary["counters"]
    q = max(total, 1)
    us = " ".join(
        f"{st} {spans.get('stream.' + st, {}).get('total_s', 0) * 1e6 / q:.3f}"
        for st in STAGES)
    gc_s = spans.get("gc", {}).get("total_s", 0.0)
    return (f"[search] trace: us/query {us}; gc "
            f"{100 * gc_s / max(wall_s, 1e-9):.2f}% of {wall_s:.3f} s wall; "
            f"h2d {c['h2d_bytes'] / q:.1f} B/query, d2h "
            f"{c['d2h_bytes'] / q:.1f} B/query; dedup "
            f"{c['dedup_reads'] / q:.3f} of queries")


def run_search(
    db_dir: str,
    files: list[str] | None = None,
    read1: str | None = None,
    read2: str | None = None,
    out_file: str = "-",
    opt: SearchOptions | None = None,
    whole_file: bool = False,
    use_filename: bool = False,
    query_id: str = "",
    no_header_row: bool = False,
    device="cuda",
    verbose: bool = True,
    stats: dict | None = None,
    pass2: str = "auto",
    batch_queries: int = 8192,
    in_flight: int | None = None,
) -> tuple[int, int]:
    """Search reads, the pairs of ``read1`` and ``read2``, or with
    ``whole_file`` whole files, against ``db_dir`` on ``device``; returns
    (total, matched).  ``opt.backend``: "numpy" searches on ``device``,
    "host" on the host's C++ and never opens a torch device.  ``pass2``
    picks the screened pass-2 kernel of a multi-block DB ("pair", "gemm" or
    "auto"); ``in_flight`` is the streamer's depth, the batches it keeps
    dispatched before it drains the oldest (None: the JAX streamer's 4 on
    the device, 2 on the host; no command-line flag sets it, as in
    kmcp_tpu).  ``stats``, when given, receives ``route``: "stream" or
    "engine", and ``backend``; for "stream" also ``hash`` ("device" or
    "host": where the reads were hashed), the streamer's ``slow_rows``,
    ``retries`` and ``in_flight``, the DB's Bloom ``rows``, row ``words``
    and ``n_blocks``, the pass-2 kernel that ran (``pass2``, None for one
    block and on the host), the union screen's ``union_rows`` and the
    active (read, block) ``pairs`` of pass 2 (0 where there is none), read
    once the run is over.  While tracing is on (``trace.enable()``, or
    ``KMCP_TPU_TRACE=1``, which traces this search alone) ``stats`` also
    receives ``trace``: ``trace.summary()`` with the streamer's retries and
    slow rows and the kernels' launches in the run beside its counters;
    with ``verbose`` a closing ``[search] trace:`` line gives the stages'
    microseconds a query, the collector's share of the wall, the bytes
    each way a query and the share of queries the dedup uniqued."""
    paired = bool(read1 and read2)
    # the query-FPR cache's size follows the mode (fpr.py)
    opt = dataclasses.replace(opt or SearchOptions(), paired_fpr_buf=paired)
    dev = None if opt.backend == "host" else resolve_device(device)
    db_dirs = find_db_dirs(db_dir)
    if not db_dirs:
        raise SystemExit(f"kmcp-tpu-torch search: invalid database: {db_dir}")
    engine = SearchEngine(db_dirs, opt, dev)
    if opt.load_default_name_map and not opt.name_map:
        nm_path = os.path.join(db_dirs[0], "name_mapping.tsv")
        if os.path.isfile(nm_path):
            with open(nm_path) as f:
                opt.name_map = dict(
                    line.rstrip("\n").split("\t", 1)
                    for line in f if line.strip()
                )
    route = ("stream" if not whole_file and usable(engine, paired)
             else "engine")
    where = "backend: host" if dev is None else f"device: {dev}"
    if verbose:
        print(
            "[search] main parameters:\n"
            f"  database: {db_dir}\n"
            f"  {where}, route: {route}, paired: {paired}, "
            f"whole-file: {whole_file}\n"
            f"  min-query-len: {opt.min_query_len}, "
            f"min-kmers: {opt.min_kmers}, query-cov: {opt.min_query_cov}, "
            f"target-cov: {opt.min_target_cov}, max-fpr: {opt.max_fpr}\n"
            f"  sort-by: {opt.sort_by}, "
            f"keep-top-scores: {opt.keep_top_scores}, "
            f"keep-unmatched: {opt.keep_unmatched}, try-se: {opt.try_se}",
            file=sys.stderr,
        )
    own_trace = trace.env_on() and not trace.TRACER.on
    if own_trace:
        trace.enable()
    launches0 = _launches() if trace.TRACER.on else {}
    t0 = time.time()
    streamer = (TorchStreamSearcher(engine, dev, pass2, in_flight)
                if route == "stream" else None)
    queries = iter_queries(files or [], read1, read2, whole_file,
                           use_filename, query_id, max(engine.dbs[0].info.ks))
    out = sys.stdout if out_file == "-" else xopen(out_file, "wt")
    try:
        if not no_header_row:
            out.write(HEADER)
        # stderr as kmcp_tpu's run_search writes it (commands/search.py:
        # 140-216), with its t0 and units
        if streamer is not None:
            total, matched = streamer.run(
                queries, out, paired=paired,
                progress=(lambda n: _stream_progress(n, t0)) if verbose
                else None)
        else:
            total, matched = run_engine(
                engine, queries, out, batch_queries,
                (lambda n: _engine_progress(n, t0)) if verbose else None)
        if verbose:
            pct = matched / total * 100 if total else 0.0
            if streamer is not None:
                print(f"[search] processed {total} queries at "
                      f"{_mqpm(total, t0) or 0:.3f} M queries/min "
                      f"(streaming); {pct:.4f}% matched", file=sys.stderr)
            else:
                print(f"\n[search] {pct:.4f}% ({matched}/{total}) queries "
                      "matched", file=sys.stderr)
        write_stats(out, total, matched)
    finally:
        if out is not sys.stdout:
            out.close()
        if own_trace:
            trace.disable()
    if trace.TRACER.on or own_trace:
        summary = trace.summary()
        summary["counters"]["launches"] = {
            n: c - launches0.get(n, 0) for n, c in _launches().items()}
        if streamer is not None:
            ddb = streamer.dev
            summary["counters"].update(
                retries=streamer.retries, slow_rows=streamer.slow_rows,
                pairs=(int(ddb.tail_stats["pairs"])
                       if not streamer.host and ddb.screen else 0))
        if verbose:
            print(_trace_line(summary, total, time.time() - t0),
                  file=sys.stderr)
        if stats is not None:
            stats["trace"] = summary
    if stats is not None:
        stats.update(route=route, backend=opt.backend)
        if streamer is not None:
            ddb = streamer.dev
            if streamer.host:
                pu = ddb.packed_union
                scr = {"pass2": None, "union_rows": pu[1] if pu else 0,
                       "pairs": 0}
            else:
                scr = {"pass2": ddb.pass2,
                       "union_rows": (ddb.screen["num_bits"] if ddb.screen
                                      else 0),
                       "pairs": (int(ddb.tail_stats["pairs"]) if ddb.screen
                                 else 0)}
            stats.update(
                hash="device" if not (streamer.host or streamer.host_hash)
                else "host",
                slow_rows=streamer.slow_rows, retries=streamer.retries,
                rows=ddb.total_rows, words=ddb.w, n_blocks=ddb.n_blocks,
                in_flight=streamer.in_flight, **scr)
    return total, matched
