"""The reductions of a traced run on fixed inputs: busy time, idle gaps
and their names from a chrome trace, the breakdown, and the bytes and
roofline arithmetic of the kernel readers."""

import pytest
import torch

from harness.kernels import HBM_BYTES_PER_S, KernelLog, count_mask_bytes
from harness.trace import (MARK_END, MARK_START, Spans, breakdown,
                           name_gap, read_trace)


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(MARK_START, "user_annotation", 1000.0, 1.0),
    ev(MARK_END, "user_annotation", 11000.0, 1.0),
    ev("k_a", "kernel", 500.0, 1000.0),  # clipped to 1000-1500
    ev("k_a", "kernel", 2000.0, 1000.0),
    ev("k_b", "kernel", 2500.0, 1000.0),  # overlaps: busy 2000-3500
    ev("Memcpy HtoD", "gpu_memcpy", 6000.0, 500.0),
    ev("aten::add", "cpu_op", 4000.0, 3000.0),  # host: not device time
    ev("k_c", "kernel", 10800.0, 400.0),  # clipped to 10800-11000
]


def test_busy_time_gaps_and_ops_in_the_window():
    tr = read_trace(EVENTS, 50.0)
    assert tr.window_s == pytest.approx(0.010)
    # busy: 500 + 1500 + 500 + 200 us
    assert tr.busy_s == pytest.approx(0.0027)
    assert tr.ops == pytest.approx({"k_a": 0.0015, "k_b": 0.001,
                                    "Memcpy HtoD": 0.0005, "k_c": 0.0002})
    # gaps 1500-2000, 3500-6000, 6500-10800 us, on perf_counter seconds
    assert [(round(a - 50, 6), round(b - 50, 6)) for a, b in tr.gaps] == [
        (0.0005, 0.001), (0.0025, 0.005), (0.0055, 0.0098)]


def test_no_device_event_reads_nothing():
    assert read_trace(EVENTS[:2] + [EVENTS[6]], 0.0) is None
    assert read_trace(EVENTS[2:], 0.0) is None  # no marks


def test_gaps_named_by_the_host_span_that_covers_them():
    spans = Spans()
    spans.intervals["parse"] += [(0.0, 1.0)]
    spans.intervals["drain"] += [(2.0, 4.0)]
    spans.intervals["writer"] += [(2.5, 3.5)]
    assert name_gap((0.1, 0.9), spans) == "parse"
    assert name_gap((2.4, 3.4), spans) == "writer"
    assert name_gap((3.6, 3.9), spans) == "drain"
    assert name_gap((5.0, 6.0), spans) == "host loop"
    tr = read_trace(EVENTS, 0.0)
    bd = breakdown(tr, Spans())
    assert bd["device_ops"][0] == ["k_a", pytest.approx(0.0015)]
    assert [round(s, 6) for _, s in bd["idle_gaps"]] == [0.0043, 0.0025,
                                                         0.0005]


def test_count_mask_bytes_count_touched_rows_once():
    bits = torch.zeros((101, 8), dtype=torch.int32)  # 100 rows + sentinel
    loc = torch.tensor([[[3], [3], [7]], [[7], [100], [3]]], dtype=torch.int32)
    cthr = torch.zeros(2, dtype=torch.int32)
    thr = torch.zeros(256, dtype=torch.int32)
    out = (torch.zeros((2, 256), dtype=torch.int32),
           torch.zeros((2, 8), dtype=torch.int32))
    n = count_mask_bytes(torch, bits, loc, cthr, thr, out)
    fixed = 6 * 4 + 2 * 4 + 256 * 4 + 2 * 256 * 4 + 2 * 8 * 4
    assert int(n) == 3 * 8 * 4 + fixed  # rows 3, 7 and the sentinel


class FakeEvent:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_roofline_is_summed_bound_over_summed_time(monkeypatch):
    log = KernelLog()
    moved = HBM_BYTES_PER_S * 1e-3  # 1 ms of bytes a call
    log.calls = [(FakeEvent(0.0), FakeEvent(2.0), torch.tensor(int(moved))),
                 (FakeEvent(5.0), FakeEvent(7.0), torch.tensor(int(moved)))]
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert log.roofline_pct(torch) == pytest.approx(50.0, rel=1e-6)
    assert KernelLog().roofline_pct(torch) is None
