"""What a ``--trace 1`` run records: host spans around calls into the
program's layers, a ``torch.profiler`` trace of the device over the window,
and the reduction of both to busy time, idle gaps and the device's top
operations.

Host spans are taken on ``time.perf_counter`` by the benchmark's own
wrappers; the profiler's clock is mapped onto it by two annotations, one at
each end of the window.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK_START, MARK_END = "bench.window.start", "bench.window.end"
# what the host was doing, the innermost first: a gap is named by the
# first of these whose spans cover most of it
SPAN_ORDER = ("writer", "wait", "parse", "flush", "drain")


class Spans:
    """Host intervals by name, on perf_counter seconds."""

    def __init__(self):
        self.intervals: dict[str, list] = defaultdict(list)

    def total(self, name: str) -> float:
        return sum(b - a for a, b in self.intervals.get(name, ()))

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            a = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.intervals[name].append((a, time.perf_counter()))
        return timed


@contextlib.contextmanager
def patched(obj, attr: str, value):
    saved = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, saved)


@dataclass
class DeviceTrace:
    """The device over the traced window: ``busy_s``, ``window_s``, the
    operations' seconds by name, and the idle gaps [(start, end)] in
    perf_counter seconds."""

    busy_s: float
    window_s: float
    ops: dict = field(default_factory=dict)
    gaps: list = field(default_factory=list)


def read_trace(events: list, p0: float) -> DeviceTrace | None:
    """Reduce a chrome trace's events to the window between the two marks:
    None when it holds no device event there.  ``p0`` is the perf_counter
    second of the start mark, which maps the gaps onto the host spans."""
    marks = {}
    for e in events:
        if e.get("name") in (MARK_START, MARK_END) and e.get("ph") == "X" \
                and e.get("cat") != "gpu_user_annotation":
            marks[e["name"]] = float(e["ts"])
    if len(marks) != 2:
        return None
    t0, t1 = marks[MARK_START], marks[MARK_END]
    spans, ops = [], defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), t0)
        b = min(float(e["ts"]) + float(e["dur"]), t1)
        if b <= a:
            continue
        spans.append((a, b))
        ops[e["name"]] += (b - a) / 1e6
    if not spans:
        return None
    busy, end, gaps = 0.0, t0, []
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if end < t1:
        gaps.append((end, t1))
    to_perf = (lambda us: p0 + (us - t0) / 1e6)
    return DeviceTrace(busy / 1e6, (t1 - t0) / 1e6, dict(ops),
                       [(to_perf(a), to_perf(b)) for a, b in gaps])


def name_gap(gap: tuple, spans: Spans) -> str:
    """What the host was doing in an idle gap: the first of SPAN_ORDER
    whose spans cover half of it or more, else "host loop"."""
    a, b = gap
    for name in SPAN_ORDER:
        cover = sum(max(0.0, min(b, y) - max(a, x))
                    for x, y in spans.intervals.get(name, ()))
        if cover >= (b - a) / 2:
            return name
    return "host loop"


def breakdown(dev: DeviceTrace, spans: Spans) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by what the host was doing."""
    ops = sorted(dev.ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(dev.gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[name_gap(g, spans), g[1] - g[0]] for g in gaps]}


class Profiler:
    """torch.profiler over the window, CPU and CUDA activity; the chrome
    trace goes to ``out_dir`` and is read back and deleted."""

    def __init__(self, torch, out_dir: str):
        self.torch = torch
        self.path = os.path.join(out_dir, "window.trace.json")
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def mark(self, name: str) -> float:
        """An annotation in the trace; returns the perf_counter second it
        was made at."""
        now = time.perf_counter()
        with self.torch.profiler.record_function(name):
            pass
        return now

    def read(self) -> list:
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                return json.load(f).get("traceEvents", [])
        finally:
            os.remove(self.path)
