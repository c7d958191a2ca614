"""The readers of the program's own spans and counters on hand-made
records: clipping to the window, idle time no span covers, device time by
the innermost range that launched it (joined by ``correlation`` ids), the
clock check, and the one installation a record gets."""

import os

import pytest
import torch

from conftest import BENCH
from harness import program as prog_mod
from harness.manifest import load_metric
from harness.program import (Program, analyse, between, clock_offsets_us,
                             device_by_range, innermost, instrument)
from harness.trace import MARK_END, MARK_START, DeviceTrace, Profiler
from harness.window import Record
from kmcp_tpu_torch.utils import trace
from kmcp_tpu_torch.utils.trace import Span

S = 1_000_000_000  # perf_counter ns a second


def ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# chrome-trace us; the start mark at 1,000 us is perf second 10.0
EVENTS = [
    ev(MARK_START, "user_annotation", 1000.0, 1.0),
    ev(MARK_END, "user_annotation", 3000.0, 1.0),
    ev("stream.dispatch", "user_annotation", 1100.0, 100.0),
    ev("tail.compact", "user_annotation", 1150.0, 30.0),
    ev("tail.dedup", "user_annotation", 1400.0, 50.0),
    ev("cudaLaunchKernel", "cuda_runtime", 1120.0, 2.0, corr=1),
    ev("cudaLaunchKernel", "cuda_runtime", 1160.0, 2.0, corr=2),
    ev("cuLaunchKernel", "cuda_driver", 1410.0, 2.0, corr=3),
    ev("cudaLaunchKernel", "cuda_runtime", 1500.0, 2.0, corr=4),
    ev("cudaLaunchKernel", "cuda_runtime", 1160.0, 2.0, tid=2, corr=5),
    ev("k_dispatch", "kernel", 1130.0, 10.0, tid=7, corr=1),
    ev("k_compact", "kernel", 1170.0, 20.0, tid=7, corr=2),
    ev("k_dedup", "kernel", 1420.0, 40.0, tid=7, corr=3),
    ev("Memcpy DtoH", "gpu_memcpy", 1510.0, 5.0, tid=7, corr=4),
    ev("k_other_thread", "kernel", 1600.0, 3.0, tid=7, corr=5),
    ev("k_unlaunched", "kernel", 1700.0, 7.0, tid=7, corr=99),
    ev("k_before", "kernel", 900.0, 50.0, tid=7, corr=1),  # before the mark
]


def span(name, a, b, i=0, parent=-1, gen=None):
    return Span(name, int(a * S), int(b * S), i, parent, 0, gen)


def record(spans=(), events=EVENTS, counters=None, gaps=()):
    r = Record(torch)
    r.queries, r.window_s = 100, 1.0
    r.spans.intervals["parse"].append((10.0, 10.05))
    r.trace = DeviceTrace(0.001, 2.0, {}, list(gaps))
    r.program = Program(list(spans), counters or {}, events, 10.0)
    return r


def metric(name):
    return load_metric(name, os.path.dirname(BENCH))


def test_host_spans_are_clipped_to_the_window():
    r = record([span("stream.pull", 9.5, 10.2), span("stream.pull", 10.5,
                                                     10.6),
                span("stream.pull", 10.9, 11.5),
                span("stream.emit", 10.0, 10.01),
                span("gc", 10.2, 10.25, gen=0),
                span("gc", 11.2, 11.3, gen=2)])
    # 0.2 + 0.1 + 0.1 s in the window [10, 11] over 100 queries
    assert metric("pull_us_per_q").read(r) == pytest.approx(4000.0)
    assert metric("emit_us_per_q").read(r) == pytest.approx(100.0)
    assert metric("order_us_per_q").read(r) == 0.0
    assert metric("gc_share").read(r) == pytest.approx(5.0)


def test_idle_share_no_span_covers():
    # gaps 10.0-10.2 and 10.5-11.0 against spans 10.1-10.3, 10.6-10.7
    # and a nested 10.62-10.65: 0.1 + 0.4 of 0.7 s uncovered
    r = record([span("stream.pull", 10.1, 10.3),
                span("stream.drain", 10.6, 10.7),
                span("stream.emit", 10.62, 10.65)],
               gaps=[(10.0, 10.2), (10.5, 11.0)])
    assert metric("idle_unattributed_share").read(r) == \
        pytest.approx(100 * 0.5 / 0.7)
    assert metric("idle_unattributed_share").read(record()) is None


def test_loop_time_between_top_spans():
    spans = [span("stream.pull", 9.9, 10.1, 0),
             span("stream.flush", 10.15, 10.3, 1),
             span("stream.pack", 10.16, 10.2, 2, parent=1),
             span("stream.drain", 10.6, 10.7, 3),
             span("gc", 10.8, 10.85, 4, gen=0),
             span("stream.pull", 10.9, 11.4, 5)]
    assert between(spans, (10.0, 11.0)) == pytest.approx(
        {"stream.pull": 0.05, "stream.flush": 0.3, "stream.drain": 0.2})


def test_innermost_range_by_launch():
    ranges = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 70, "d"),
              (200, 300, "e")]
    got = innermost(ranges, [(5, "k1"), (25, "k2"), (40, "k3"), (65, "k4"),
                             (80, "k5"), (150, "k6"), (250, "k7")])
    assert got == {"k1": "a", "k2": "c", "k3": "b", "k4": "d", "k5": "a",
                   "k6": None, "k7": "e"}


def test_device_time_by_correlation():
    """Each kernel and copy goes to the innermost range on its launch's
    thread: the compaction's kernel not to the dispatch that holds
    tail.compact, a launch on a thread with no range to none, a kernel
    whose launch the trace lacks to "?", and nothing before the mark."""
    dev = device_by_range(EVENTS)
    assert dev == pytest.approx({"stream.dispatch": 10e-6,
                                 "tail.compact": 20e-6,
                                 "tail.dedup": 40e-6, None: 8e-6,
                                 "?": 7e-6})
    r = record()
    assert metric("compact_ns_per_query").read(r) == pytest.approx(200.0)
    assert metric("dedup_ns_per_query").read(r) == pytest.approx(400.0)
    no_dedup = [e for e in EVENTS if e["name"] != "tail.dedup"]
    assert metric("dedup_ns_per_query").read(record(events=no_dedup)) is None
    assert device_by_range(EVENTS[2:]) is None  # no marks


def test_d2h_bytes_per_query_and_nothing_to_read():
    r = record(counters={"d2h_bytes": 52_000})
    assert metric("d2h_bytes_per_q").read(r) == 520.0
    empty = Record(torch)
    for name in ("pull_us_per_q", "gc_share", "idle_unattributed_share",
                 "compact_ns_per_query", "d2h_bytes_per_q"):
        assert metric(name).read(empty) is None  # never installed
        assert metric(name).read(record(events=None)) is None  # no card


def test_dispatch_spans_against_their_ranges():
    r = record([span("stream.dispatch", 10.0001, 10.0002)])
    # mapped: 1000 + 100 us; the range starts at 1100
    assert clock_offsets_us(r.program) == pytest.approx([0.0], abs=1e-6)
    r.program.spans.append(span("stream.dispatch", 10.2, 10.3, 1))
    assert clock_offsets_us(r.program) is None  # two spans, one range
    assert analyse(r) is analyse(r)  # reduced once


def test_installed_once_returns_what_the_profiler_returns(monkeypatch):
    events = list(EVENTS)
    monkeypatch.setattr(Profiler, "read", lambda self: events)
    read, mark = Profiler.read, Profiler.mark
    prof = Profiler.__new__(Profiler)
    prof.torch = torch
    r = Record(torch)
    first = instrument(r)
    second = instrument(r)
    with first, second:
        with trace.span("before"):
            pass
        p0 = Profiler.mark(prof, MARK_START)
        assert trace.TRACER.on and r.program.p_start == p0
        with trace.span("stream.pull", 0):
            pass
        Profiler.mark(prof, MARK_END)
        assert not trace.TRACER.on
        assert Profiler.read(prof) is events
    assert r.program.events is events
    assert [s.name for s in r.program.spans if s.name != "gc"] == [
        "stream.pull"]
    assert (Profiler.read, Profiler.mark) == (read, mark)
    assert not trace.TRACER.on


def test_a_program_without_a_tracer_reads_nothing(monkeypatch):
    monkeypatch.setattr(prog_mod, "_tracer", lambda: None)
    r = Record(torch)
    with instrument(r):
        pass
    assert r.program is None
    assert metric("pull_us_per_q").read(r) is None
