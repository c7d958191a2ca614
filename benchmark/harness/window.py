"""One run of one cell: the DB from the cache, the program's set-up and
warm-up, the read pool from the seed, the measured window, and after it
the comparison with the plain reference.

The window drives ``TorchStreamSearcher.run``, the route ``run_search``
takes, at its default depth, fed by the program's ``iter_queries`` over
the pool's FASTQ: one sample, read once, never cycled, so queryIdx ``i``
is the pool's query ``i``.  The program reads a whole FASTQ file at its
first record (``seqio/fastx.read_fastx``); that first pull is the sample's
load and closes the set-up, and the file is removed once it is read.  The
window opens at the second query, closes at the first batch boundary past
``seconds`` (or where the pool ends, which its size is chosen to prevent),
the batches in flight then drain, and its wall runs to the end of the
drain.

A configuration that sets ``block_screen`` means the two-pass screened
search, and its run fails with no result unless that route served the
window (``route_check``): the DB has its union screens on, every batch
took the screened tail and none the dense tail, no query went to the
object engine, and on the card pass 1 (K2' over the union table) and
pass 2 (K5' or K6') launched.  Nothing falls back quietly.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kmcp_tpu_torch.commands.search import iter_queries
from kmcp_tpu_torch.kmer import native
from kmcp_tpu_torch.parallel.dryrun import kernel_wrappers
from kmcp_tpu_torch.search import device as device_mod
from kmcp_tpu_torch.search.engine import SearchEngine, SearchOptions
from kmcp_tpu_torch.search.stream import TorchStreamSearcher, usable

from . import compare
from .dbcache import ensure_db
from .genomes import genome_codes
from .hoststat import HostStat
from .manifest import Cell, load_metric
from .trace import MARK_END, MARK_START, Profiler, Spans, breakdown, \
    patched, read_trace
from .traffic import make_pool, pool_size, write_fastq

WARMUP_BATCHES = 5  # the depth of 4 batches in flight, and one more


@dataclass
class Record:
    """What a traced run hands the per-layer metrics' readers."""

    torch: object
    queries: int = 0  # completed in the window
    window_s: float = 0.0  # its wall, on the host's clock
    batch_ms: list = field(default_factory=list)  # each batch's latency
    spans: Spans = field(default_factory=Spans)
    kernels: dict = field(default_factory=dict)  # name -> KernelLog
    trace: object = None  # trace.DeviceTrace, or None


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def closed_loop(first, rest, batch, deadline, starts, ended, spans=None):
    """The sample's queries, ``first`` (pulled before the window) and then
    those of ``rest``, in whole batches until ``deadline`` (perf_counter
    seconds) has passed or the sample ends (then ``ended`` gets True); each
    batch's first pull time goes to ``starts``, taken before the pull.
    With ``spans``, each batch's pulls (the FASTQ parse) are a "parse"
    interval."""
    it = itertools.chain([first], rest)
    n = 0
    while True:
        if n % batch == 0:
            now = time.perf_counter()
            if now >= deadline:
                return
            starts.append(now)
        q = next(it, None)
        if q is None:
            ended.append(True)
            if n % batch == 0:
                starts.pop()
            elif spans is not None:
                spans.intervals["parse"].append((starts[-1],
                                                 time.perf_counter()))
            return
        if spans is not None and (n + 1) % batch == 0:
            spans.intervals["parse"].append((starts[-1],
                                             time.perf_counter()))
        yield q
        n += 1


@contextlib.contextmanager
def host_spans(streamer, spans: Spans):
    """Spans around the streamer's calls into its layers: "flush" (pack and
    dispatch), "drain" (wait, order, write), "wait" (the device result)
    and "writer" (the native TSV writer)."""
    handle = device_mod.SearchHandle
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(native, "write_rows", spans.wrap(
            "writer", native.write_rows)))
        stack.enter_context(patched(handle, "result", spans.wrap(
            "wait", handle.result)))
        stack.enter_context(patched(streamer, "_flush", spans.wrap(
            "flush", streamer._flush)))
        stack.enter_context(patched(streamer, "_drain", spans.wrap(
            "drain", streamer._drain)))
        yield


def route_check(route: dict, on_card: bool) -> list[str]:
    """What kept the window off the screened route: nothing when every
    batch took the screened tail, the dense tail none, no query went to
    the object engine and, on the card, pass 1 and pass 2 launched."""
    bad = []
    if route["screened_tail"] < route["batches"]:
        bad.append(f"{route['screened_tail']} screened tails for "
                   f"{route['batches']} batches")
    if route["dense_tail"]:
        bad.append(f"{route['dense_tail']} dense tails")
    if route["slow_rows"]:
        bad.append(f"{route['slow_rows']} queries on the object engine")
    if on_card and route["pass1_launches"] < route["batches"]:
        bad.append(f"{route['pass1_launches']} pass-1 launches")
    if on_card and not route["pass2_launches"]:
        bad.append("no pass-2 launch")
    return bad


def p90(values: list) -> float:
    """The 90th percentile, linearly interpolated between ranks."""
    return float(np.percentile(values, 90))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float) -> dict:
    """One run; returns the result line's dict (``checks`` last).  ``t0``
    is the process's start on perf_counter."""
    db_dir, built = ensure_db(cell.config, cell.cache_dir)
    log(f"DB {db_dir} ({'built now' if built else 'from the cache'})")
    record = Record(torch)
    metrics = {m["name"]: load_metric(m["name"], cell.root)
               for m in cell.per_layer} if trace else {}
    tmp = tempfile.mkdtemp(prefix="bench-")
    try:
        with contextlib.ExitStack() as stack:
            for mod in metrics.values():
                if hasattr(mod, "instrument"):
                    stack.enter_context(mod.instrument(record))
            out = _measure(cell, torch.device(device), db_dir, tmp, seed,
                           seconds, record if trace else None, t0)
        if trace:
            out["metrics"] = {}
            for m in cell.per_layer:
                v = metrics[m["name"]].read(record)
                if v is not None:
                    out["metrics"][m["name"]] = {"value": v,
                                                 "unit": m["unit"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _measure(cell: Cell, dev, db_dir: str, tmp: str, seed: int,
             seconds: float, record: Record | None, t0: float) -> dict:
    """Set-up, warm-up, the window and the check; ``record`` is None
    unless the run is traced."""
    cfg, tr = cell.config, cell.traffic
    paired = bool(tr["paired"])
    trace = record is not None
    steps = [("start", time.perf_counter())]
    opt = SearchOptions(paired_fpr_buf=paired, **cfg["search"])
    engine = SearchEngine([db_dir], opt, dev)
    screened = bool(cfg.get("block_screen"))
    if screened and (device_mod.screen_off()
                     or not device_mod.two_pass_ready(engine.dbs[0])):
        raise RuntimeError(f"route check: {cell.name} sets block_screen, "
                           "but its DB has no union screens in use, so "
                           "the screened tail cannot serve it")
    if not usable(engine, paired):
        raise RuntimeError(f"the streamer does not take {cell.name}")
    steps.append(("DB open", time.perf_counter()))
    # the program's calls that say which route a batch took, and the
    # union table's packing in the set-up
    calls = Spans()
    with patched(device_mod, "build_packed_union", calls.wrap(
            "union_pack", device_mod.build_packed_union)):
        streamer = TorchStreamSearcher(engine, dev)
    k = max(engine.dbs[0].info.ks)
    batch = streamer.batch_size()
    steps.append(("device DB", time.perf_counter()))

    # the read pool: the benchmark's input, not the program's set-up
    codes = genome_codes(cfg)
    pool = make_pool(tr, cfg, codes, seed, pool_size(tr, seconds))
    # the warm-up takes the pool's last queries, which the window does
    # not reach
    warm_paths = write_fastq(pool, tmp, "warm",
                             pool.size - batch * WARMUP_BATCHES)
    paths = write_fastq(pool, tmp)
    host = HostStat()
    steps.append(("read pool (not set-up)", time.perf_counter()))
    pool_s = steps[-1][1] - steps[-2][1]

    def reads(ps):  # iter_queries' files, read1, read2
        return ([], *ps) if paired else (ps, None, None)

    # warm-up: the window's shapes, through the same object
    streamer.run(iter_queries(*reads(warm_paths), False, False, "", k),
                 compare.Sink(keep=False), paired=paired)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    for path in warm_paths:
        os.remove(path)
    steps.append(("warm-up", time.perf_counter()))
    # the sample's load: the program reads each whole file at its first
    # record, which closes the set-up; the files then go
    rest = iter_queries(*reads(paths), False, False, "", k)
    first = next(rest)
    for path in paths:
        os.remove(path)
    steps.append(("sample load", time.perf_counter()))
    log("set-up: before the program's set-up "
        f"{steps[0][1] - t0:.3f} s (imports, DB cache), "
        + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                    for a, b in zip(steps, steps[1:])))
    for kern in kernel_wrappers().values():
        kern.launches = 0
        for v in getattr(kern, "by_variant", {}):
            kern.by_variant[v] = 0
    retries0, slow0 = streamer.retries, streamer.slow_rows
    # the device DB's pair counter runs from its build: the window's
    # pairs are the difference
    pairs0 = int(getattr(streamer.dev, "tail_stats", {}).get("pairs", 0))

    sink = compare.Sink()
    starts: list[float] = []
    done: list[float] = []
    ended: list[bool] = []
    with contextlib.ExitStack() as stack:
        prof = None
        if trace:
            stack.enter_context(host_spans(streamer, record.spans))
        if screened:
            for tail in ("count_tail_async", "screened_tail_async"):
                stack.enter_context(patched(device_mod, tail, calls.wrap(
                    tail, getattr(device_mod, tail))))
        # every run on the card is traced: the device's busy time is an
        # end-to-end metric; the profiler's start is not the program's
        # set-up
        p_enter = time.perf_counter()
        if dev.type == "cuda":
            prof = stack.enter_context(Profiler(torch,
                                                tempfile.gettempdir()))
            p_mark = prof.mark(MARK_START)
        prof_s = time.perf_counter() - p_enter
        host.start()
        deadline = time.perf_counter() + seconds
        queries = closed_loop(first, rest, batch, deadline, starts, ended,
                              record.spans if trace else None)
        total, matched = streamer.run(
            queries, sink, paired=paired,
            progress=lambda n: done.append(time.perf_counter()))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        host.stop()
        if prof is not None:
            prof.mark(MARK_END)
    dtrace = read_trace(prof.read(), p_mark) if prof is not None else None
    window_s = t_end - starts[0]
    setup_s = starts[0] - t0 - pool_s - prof_s
    lat_ms = [(b - a) * 1e3 for a, b in zip(starts, done)]
    if len(done) != len(starts) or total > len(starts) * batch:
        raise RuntimeError(f"{total} queries in {len(starts)} batches of "
                           f"{batch}, {len(done)} drained")
    if ended:
        log(f"the pool of {pool.size} queries ended before the deadline: "
            "the window is one pass over it")
    if trace:
        record.queries, record.window_s = total, window_s
        record.batch_ms, record.trace = lat_ms, dtrace
    launches = {n: kern.launches for n, kern in kernel_wrappers().items()}
    variants = {f"{n}/{v}": c for n, kern in kernel_wrappers().items()
                for v, c in getattr(kern, "by_variant", {}).items() if c}
    ddb = streamer.dev
    union_pack_s = (calls.total("union_pack")
                    if "union_pack" in calls.intervals else None)
    route = {}
    if screened:
        route = {"batches": len(starts),
                 "screened_tail": len(calls.intervals["screened_tail_async"]),
                 "dense_tail": len(calls.intervals["count_tail_async"]),
                 "slow_rows": streamer.slow_rows - slow0,
                 "pass1_launches": launches["count_mask"],
                 "pass2_launches": (launches["pair_count"]
                                    + launches["group_count"]),
                 "active_pairs": int(getattr(ddb, "tail_stats",
                                             {}).get("pairs", 0) - pairs0)}
    log(f"window {window_s:.4f} s: {total} of {pool.size} queries "
        f"({matched} matched) in {len(starts)} batches of {batch}, "
        f"{sink.chars} TSV characters; batch latency median "
        f"{statistics.median(lat_ms):.2f} ms, p90 {p90(lat_ms):.2f} ms "
        f"({len(lat_ms)} batches); set-up {setup_s:.4f} s, pool "
        f"{pool_s:.4f} s (not set-up)")
    log(host.line())
    log(f"counters: route stream, depth {streamer.in_flight}, retries "
        f"{streamer.retries - retries0}, slow rows "
        f"{streamer.slow_rows - slow0}, DB {ddb.n_blocks} block(s) x "
        f"{ddb.total_rows // ddb.n_blocks} rows x {ddb.w} words, pass 2 "
        f"{ddb.pass2}; launches {launches}, by variant {variants}")
    if union_pack_s is not None:
        log(f"set-up: the union table packed in {union_pack_s:.3f} s")
    if screened:
        bad = route_check(route, dev.type == "cuda")
        log(f"route: {route}")
        if bad:
            raise RuntimeError("route check: the screened tail did not "
                               f"serve the window of {cell.name}: "
                               + "; ".join(bad))
    out = {"correct": False, "attempted": total, "failed": 0,
           "metrics": {}, "device": {}}
    if dev.type == "cuda":
        out["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    if dtrace is not None:
        out["device"].update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
        log(f"device: busy {dtrace.busy_s:.6f} s of {dtrace.window_s:.4f} "
            f"s traced, {dtrace.busy_s * 1e9 / max(total, 1):.4f} ns a "
            f"query; host: {total / window_s:.1f} queries/s")
    if not trace:
        # a metric with nothing to read (no card, so no trace) is left out
        e2e = {"setup_s": setup_s}
        if dtrace is not None and total:
            e2e["device_ns_per_query"] = dtrace.busy_s * 1e9 / total
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end if m["name"] in e2e}
    elif dtrace is not None:
        out["breakdown"] = breakdown(dtrace, record.spans)

    # the program's state goes before the reference runs on the device
    del streamer, engine, ddb, rest
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check(cell, codes, pool, sink, total, seed, dev)
    out["correct"] = passed(out["checks"])
    return out


def passed(checks: dict) -> bool:
    """Every number within its limit: at most the limit, or for
    ``queries_compared`` at least it."""
    return all(c["value"] >= c["limit"] if n == "queries_compared"
               else c["value"] <= c["limit"] for n, c in checks.items())


def check(cell: Cell, codes, pool, sink, total: int, seed: int,
          dev) -> dict:
    """Compare a sample of the window's queries with the plain
    reference."""
    from .reference import Reference

    p_ref = time.perf_counter()
    wanted = compare.draw_sample(seed, total)
    got, disorder = compare.rows_by_query(sink, wanted)
    queries = compare.sample_queries(pool, wanted)
    ref = Reference(cell.config, codes, dev)
    want = ref.rows(queries)
    bad, examples = compare.mismatches(got, want, queries)
    n_rows = sum(len(r) for r in want)
    log(f"reference: {len(queries)} sampled queries, {n_rows} rows, "
        f"{time.perf_counter() - p_ref:.2f} s")
    for ex in examples:
        log(f"differs: {ex}")
    return {"rows_out_of_order": {"value": disorder, "limit": 0},
            "queries_compared": {"value": len(queries),
                                 "limit": min(compare.SAMPLE, total)},
            "queries_differ": {"value": bad,
                               "limit": compare.MISMATCH_LIMIT}}
