"""The program's own spans and counters in a traced run, for the per-layer
metrics that read them.

The program (``kmcp_tpu_torch/utils/trace.py``) times its stages on
``time.perf_counter_ns``, the clock the harness maps the device trace onto
through its start mark, and enters a ``torch.profiler.record_function``
range for each, so the profiler's trace holds the same ranges with each
kernel's launch inside the range that issued it.  ``instrument`` is every
such metric's, and is entered once per record however many metrics ask:
it wraps ``harness.trace.Profiler``'s ``mark`` (tracing on at the window's
start mark, after a range of its own that keeps the mark on time, and off
at its end mark) and ``read`` (the trace's events kept on
the record), each wrapper returning what the method returns.  A checkout
whose program has no tracer records nothing, and every reader then
returns None.

The readers clip the program's spans to the window as ``record`` holds
it, from its first "parse" interval's start for ``record.window_s``, and
attribute each kernel, copy and memset to the innermost program range on
its launching thread that holds its launch, joined by the trace's
``correlation`` ids.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
from collections import defaultdict
from dataclasses import dataclass, field

from .trace import DEVICE_CATS, MARK_END, MARK_START, Profiler, patched

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TRACE_ON = "program.trace.on"
RANGE_CAT = "user_annotation"
LOOP = ("stream.pull", "stream.flush", "stream.drain")
STAGES = ("stream.pull", "stream.pack", "stream.dispatch", "stream.wait",
          "stream.retry", "stream.slow", "stream.order", "stream.emit")


@dataclass
class Program:
    """What one traced window recorded: the tracer's closed spans (perf
    ns) and counters, the profiler's events, and the start mark's perf
    second."""

    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    events: list | None = None
    p_start: float | None = None
    found: dict | None = None  # ``analyse``'s, computed once


def _tracer():
    try:
        from kmcp_tpu_torch.utils import trace
    except ImportError:  # a program without a tracer
        return None
    return trace


def instrument(record):
    """The one installation a record gets, whichever metric asks first."""
    if hasattr(record, "program"):
        return contextlib.nullcontext()
    trace = _tracer()
    record.program = Program() if trace is not None else None
    if trace is None:
        return contextlib.nullcontext()
    return _installed(record.program, trace)


@contextlib.contextmanager
def _installed(prog: Program, trace):
    mark, read = Profiler.mark, Profiler.read

    def marked(prof, name):
        if name == MARK_START:
            trace.enable()
            # a profiler's first range opens late (~0.1 ms on a CPU): this
            # one, before the start mark, keeps the mark's on time
            with prof.torch.profiler.record_function(TRACE_ON):
                pass
        out = mark(prof, name)
        if name == MARK_START:
            prog.p_start = out
        elif name == MARK_END:
            trace.disable()
        return out

    def reading(prof):
        events = read(prof)
        prog.events = events
        prog.spans = trace.TRACER.closed()
        prog.counters = trace.summary()["counters"]
        return events

    try:
        with patched(Profiler, "mark", marked), \
                patched(Profiler, "read", reading):
            yield
    finally:
        trace.disable()


def program(record) -> Program | None:
    """The record's program trace, None where there is nothing to read:
    no tracer, no device trace or no window."""
    prog = getattr(record, "program", None)
    if (prog is None or prog.events is None or record.trace is None
            or not record.spans.intervals.get("parse")
            or record.queries <= 0):
        return None
    return prog


def window(record) -> tuple[float, float]:
    """The window on perf_counter seconds: its first pull, for
    ``window_s``."""
    w0 = record.spans.intervals["parse"][0][0]
    return w0, w0 + record.window_s


def clipped_s(spans, w: tuple[float, float], names) -> float:
    """Seconds of the spans named in ``names`` inside the window ``w``."""
    a, b = w
    return sum(max(0.0, min(b, s.end / 1e9) - max(a, s.start / 1e9))
               for s in spans if s.name in names)


def host_us_per_q(record, name: str) -> float | None:
    """Microseconds a query the program spent in spans ``name`` inside
    the window."""
    prog = program(record)
    if prog is None:
        return None
    return clipped_s(prog.spans, window(record), (name,)) / \
        record.queries * 1e6


def union(intervals: list) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def uncovered_s(gaps: list, spans) -> float:
    """Seconds of ``gaps`` (perf seconds) that no span covers."""
    cover = union([(s.start / 1e9, s.end / 1e9) for s in spans])
    total = 0.0
    for a, b in gaps:
        hit = sum(max(0.0, min(b, y) - max(a, x)) for x, y in cover
                  if x < b and y > a)
        total += (b - a) - hit
    return total


def innermost(ranges: list, launches: list) -> dict:
    """ranges [(ts, end, name)] and launches [(ts, key)] of one thread ->
    {key: name of the innermost range holding the launch, or None}.
    Ranges of one thread nest, so a stack sweep finds it."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(launches):
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def device_by_range(events: list) -> dict | None:
    """Device seconds between the two marks by the innermost program range
    that launched them (None: no program range; "?": no launch found), or
    None without the marks."""
    marks = {e["name"]: float(e["ts"]) for e in events
             if e.get("name") in (MARK_START, MARK_END)
             and e.get("ph") == "X" and e.get("cat") == RANGE_CAT}
    if len(marks) != 2:
        return None
    t0, t1 = marks[MARK_START], marks[MARK_END]
    launch, ranges = {}, defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
        elif cat == RANGE_CAT and e["name"] not in (*marks, TRACE_ON):
            ts = float(e["ts"])
            ranges[e.get("tid")].append((ts, ts + float(e["dur"]),
                                         e["name"]))
    secs, by_thread = [], defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), t0)
        b = min(float(e["ts"]) + float(e["dur"]), t1)
        if b <= a:
            continue
        at = launch.get(e.get("args", {}).get("correlation"))
        secs.append(((b - a) / 1e6, at))
        if at is not None:
            by_thread[at[0]].append((at[1], at))
    names = {}
    for tid, ls in by_thread.items():
        names.update(innermost(ranges.get(tid, []), ls))
    out = defaultdict(float)
    for s, at in secs:
        out["?" if at is None else names.get(at)] += s
    return dict(out)


def clock_offsets_us(prog: Program, name: str = "stream.dispatch"
                     ) -> list | None:
    """|range ts - span start mapped through the start mark| in us for
    each span ``name``, matched in order; None when the counts differ."""
    t0 = next((float(e["ts"]) for e in prog.events
               if e.get("name") == MARK_START and e.get("ph") == "X"
               and e.get("cat") == RANGE_CAT), None)
    if t0 is None or prog.p_start is None:
        return None
    got = sorted(float(e["ts"]) for e in prog.events
                 if e.get("name") == name and e.get("ph") == "X"
                 and e.get("cat") == RANGE_CAT)
    want = sorted(t0 + (s.start / 1e9 - prog.p_start) * 1e6
                  for s in prog.spans if s.name == name)
    if len(got) != len(want) or not got:
        return None
    return [abs(g - w) for g, w in zip(got, want)]


def analyse(record) -> dict | None:
    """The program's trace reduced once per record, and logged."""
    prog = program(record)
    if prog is None:
        return None
    if prog.found is not None:
        return prog.found
    w = window(record)
    dev = device_by_range(prog.events) or {}
    ours = sum(s for n, s in dev.items() if n not in (None, "?"))
    gaps = record.trace.gaps
    idle = sum(b - a for a, b in gaps)
    offsets = clock_offsets_us(prog)
    prog.found = found = {
        "device_s": dev, "idle_s": idle,
        "idle_uncovered_s": uncovered_s(gaps, prog.spans),
        "loop_s": clipped_s(prog.spans, w, LOOP),
    }
    q = record.queries
    stages = {n: clipped_s(prog.spans, w, (n,)) / q * 1e6 for n in STAGES}
    top = ", ".join(f"{n} {s * 1e3:.3f}" for n, s in sorted(
        dev.items(), key=lambda kv: -kv[1]) if n is not None)
    log(f"program: pull+flush+drain "
        f"{100 * found['loop_s'] / record.window_s:.2f}% of the window's "
        f"{record.window_s:.4f} s; between them, s, after "
        + ", ".join(f"{n} {v:.4f}" for n, v in between(prog.spans, w).items())
        + "; us a query "
        + ", ".join(f"{n} {v:.4f}" for n, v in stages.items())
        + f" (sum {sum(stages.values()):.4f}, wall "
        f"{record.window_s / q * 1e6:.4f})")
    log(f"program: device time under program ranges "
        f"{100 * ours / max(sum(dev.values()), 1e-12):.2f}% of "
        f"{sum(dev.values()):.6f} s (busy {record.trace.busy_s:.6f} s); "
        f"by range, ms: {top}; outside any range "
        f"{dev.get(None, 0.0) * 1e3:.3f} ms")
    if offsets:
        log(f"program: stream.dispatch span vs range ts, {len(offsets)} "
            f"spans: median {statistics.median(offsets):.2f} us, max "
            f"{max(offsets):.2f} us")
    else:
        log("program: stream.dispatch spans and ranges do not pair up")
    if gaps:
        a, b = max(gaps, key=lambda g: g[1] - g[0])
        last = max((s.end / 1e9 for s in prog.spans), default=w[0])
        inside = uncovered_s([(max(x, w[0]), min(y, w[1])) for x, y in gaps
                              if min(y, w[1]) > max(x, w[0])], prog.spans)
        log(f"program: idle {idle:.4f} s, uncovered by program spans "
            f"{found['idle_uncovered_s']:.4f} s ({inside:.4f} s inside the "
            f"window); longest gap {b - a:.4f} s at {a - w[0]:.4f}-"
            f"{b - w[0]:.4f} s of the window (ends {w[1] - w[0]:.4f} s; "
            f"last program span ends {last - w[0]:.4f} s), uncovered "
            f"{uncovered_s([(a, b)], prog.spans):.4f} s")
    log(f"program: counters {prog.counters}")
    return found


def between(spans, w: tuple[float, float]) -> dict:
    """Seconds inside the window between one top-level span of the
    streamer's loop and the next, by the name of the first."""
    top = sorted((s for s in spans if s.parent == -1 and s.name in LOOP),
                 key=lambda s: s.start)
    out = dict.fromkeys(LOOP, 0.0)
    for x, y in zip(top, top[1:]):
        a, b = max(x.end / 1e9, w[0]), min(y.start / 1e9, w[1])
        out[x.name] += max(0.0, b - a)
    return out


def device_ns_per_query(record, name: str) -> float | None:
    """Device nanoseconds a query under the innermost range ``name``;
    None where no such range launched anything."""
    found = analyse(record)
    if found is None or name not in found["device_s"]:
        return None
    return found["device_s"][name] * 1e9 / record.queries


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)
