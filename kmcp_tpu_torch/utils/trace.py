"""Spans and counters inside the search path, off by default.

The streamer (search/stream.py) and the device tails (search/device.py,
device_step.py, screen.py) open named spans around their stages::

    from ..utils import trace

    with trace.span("stream.flush", idx0):  # a batch's id: its idx0
        with trace.span("stream.pack"):     # the batch of its parent
            ...
    if trace.TRACER.on:
        trace.count("h2d_bytes", host.numel() * host.element_size())

Tracing is turned on by ``trace.enable()``, or for ``search`` by
``KMCP_TPU_TRACE=1`` (``env_on``).  While it is off, ``span`` returns one
shared no-op context and ``count`` tests one attribute: no clock is read,
nothing is allocated, no ``record_function`` is entered and no ``gc``
callback is installed.

While it is on, each span keeps its name, its start and end on
``time.perf_counter_ns`` (the clock the benchmark maps the device trace
onto), its parent span and its batch, and enters
``torch.profiler.record_function(name)``, so that a running profiler's
trace holds the same ranges with each kernel's launch inside the range
that issued it.  ``enable`` also hooks Python's garbage collector: each
collection is a ``gc`` span with its generation, its parent the span it
interrupted.  ``summary()`` gives per span name the count, the total and
the self time (less the time of its child spans), and the counters;
``reset()`` clears both.
"""

from __future__ import annotations

import gc
import itertools
import os
import threading
import time
from dataclasses import dataclass

import torch

clock = time.perf_counter_ns
GENERATIONS = 3
COUNTERS = ("batches", "queries", "tsv_rows", "h2d_bytes", "d2h_bytes",
            "compact_launches", "dedup_launches", "dedup_reads",
            "dedup_dropped")


def env_on() -> bool:
    """True when ``KMCP_TPU_TRACE`` asks ``search`` to trace ("1")."""
    return os.environ.get("KMCP_TPU_TRACE", "") == "1"


def nbytes(*tensors) -> int:
    """The bytes of tensors, from their shapes and dtypes: never a device
    value, so never a wait."""
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclass(slots=True)
class Span:
    """One closed span: perf_counter_ns ``start`` and ``end``; ``id`` its
    serial number and ``parent`` its parent's (-1 at the top of its
    thread); ``batch`` the idx0 of its batch (None outside a batch);
    ``gen`` a ``gc`` span's generation."""

    name: str
    start: int
    end: int
    id: int
    parent: int
    batch: int | None
    gen: int | None = None


class _Null:
    """The span while tracing is off: entering and leaving do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL = _Null()


class _Open:
    """A span while it is open on its thread's stack."""

    __slots__ = ("tracer", "name", "batch", "id", "parent", "start",
                 "range")

    def __init__(self, tracer, name, batch):
        self.tracer, self.name, self.batch = tracer, name, batch

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        top = stack[-1] if stack else None
        self.parent = top.id if top else -1
        if self.batch is None and top:
            self.batch = top.batch
        self.id = next(tr._ids)
        stack.append(self)
        self.range = torch.profiler.record_function(self.name)
        # the clock is read just before the range opens, as a profiler
        # mark's is, and no collection may run between the two
        collecting = gc.isenabled()
        gc.disable()
        try:
            self.start = clock()
            self.range.__enter__()
        finally:
            if collecting:
                gc.enable()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = clock()
        tr = self.tracer
        tr._stack().pop()
        tr.spans.append(Span(self.name, self.start, end, self.id,
                             self.parent, self.batch))
        return None


class Tracer:
    """Spans and counters of one process; ``TRACER`` is the one the
    search path writes to.  Spans of several threads may interleave:
    each thread nests its own."""

    def __init__(self):
        self.on = False
        self._local = threading.local()
        self._ids = itertools.count()
        self.reset()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def reset(self) -> None:
        """Forget every closed span and zero every counter (spans open
        now close into the new record)."""
        self.spans: list[Span] = []
        self.counters = dict.fromkeys(COUNTERS, 0)
        self.counters["gc_collections"] = [0] * GENERATIONS

    def enable(self) -> None:
        """Start tracing afresh (``reset``) and hook the collector."""
        self.reset()
        if not self.on:
            gc.callbacks.append(self._gc)
        self.on = True

    def disable(self) -> None:
        """Stop tracing and unhook the collector; what was recorded
        stays for ``summary``."""
        if self.on:
            gc.callbacks.remove(self._gc)
        self.on = False

    def span(self, name: str, batch: int | None = None):
        """A context that records one span (``batch`` None: its parent's
        batch); the shared no-op while tracing is off."""
        if not self.on:
            return _NULL
        return _Open(self, name, batch)

    def count(self, name: str, n: int) -> None:
        if self.on:
            self.counters[name] += int(n)

    def _gc(self, phase: str, info: dict) -> None:
        local = self._local
        if phase == "start":
            local.gc_start = clock()
            return
        start = getattr(local, "gc_start", None)
        if start is None:  # hooked while a collection ran
            return
        local.gc_start = None
        stack = self._stack()
        top = stack[-1] if stack else None
        gen = int(info.get("generation", 0))
        self.spans.append(Span("gc", start, clock(), next(self._ids),
                               top.id if top else -1,
                               top.batch if top else None, gen))
        self.counters["gc_collections"][gen] += 1

    def closed(self) -> list[Span]:
        """The closed spans in the order they were opened."""
        return sorted(self.spans, key=lambda s: s.id)

    def summary(self) -> dict:
        """{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
        {...}} over the closed spans; self time is a span's duration less
        its closed child spans' durations."""
        child: dict[int, int] = {}
        for s in self.spans:
            if s.parent >= 0:
                child[s.parent] = child.get(s.parent, 0) + s.end - s.start
        by: dict[str, dict] = {}
        for s in self.spans:
            d = by.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                       "self_s": 0.0})
            d["count"] += 1
            d["total_s"] += (s.end - s.start) / 1e9
            d["self_s"] += (s.end - s.start - child.get(s.id, 0)) / 1e9
        counters = dict(self.counters)
        counters["gc_collections"] = list(counters["gc_collections"])
        return {"spans": by, "counters": counters}


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
enable = TRACER.enable
disable = TRACER.disable
reset = TRACER.reset
summary = TRACER.summary
