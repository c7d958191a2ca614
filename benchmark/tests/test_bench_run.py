"""Whole runs of the tiny cells on the CPU, past the harness's look for a
card: the program's plain versions in the window, the plain reference after
it.  ``correct`` comes out true as the program stands, and false with the
timed path broken underneath or the control in the program's place."""

import time

import numpy as np
import pytest
import torch

from harness.manifest import find_cell
from harness.window import run

CELLS = ["dense-se", "dense-host90-se", "dense-pe"]
SEED = 2**31 + 99


def one_run(root, name, trace=False, seconds=1.0):
    return run(find_cell(name, root), SEED, seconds, trace, "cpu",
               time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct_and_reports_its_metrics(tiny_root, small_batches,
                                                  name):
    out = one_run(tiny_root, name)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
    # no card, so no device trace: device_ns_per_query is left out
    assert set(out["metrics"]) == {"setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["queries_compared"]["value"] == min(
        8192, out["attempted"])


def test_a_traced_run_reads_its_host_spans(tiny_root, small_batches):
    out = one_run(tiny_root, "dense-pe", trace=True)
    assert out["correct"] is True
    # no card: the device's numbers are left out, never 0
    assert {"host_queries_per_s", "host_batch_p90_ms", "parse_us_per_q",
            "writer_us_per_q"} == set(out["metrics"])
    assert all(m["value"] > 0 for m in out["metrics"].values())


def _half_the_batch(monkeypatch):
    """Half of each batch's reads lose their candidates."""
    from kmcp_tpu_torch.search import stream

    unpack = stream._unpack_result

    def half(res, budget, nb, T):
        n, qi, t, cnt, nk = unpack(res, budget, nb, T)
        if qi is None:
            return n, qi, t, cnt, nk
        keep = qi < nb // 2
        return int(keep.sum()), qi[keep], t[keep], cnt[keep], nk
    monkeypatch.setattr(stream, "_unpack_result", half)


def _count_altered(monkeypatch):
    """K2' (its plain version) returns each count one higher."""
    from kmcp_tpu_torch.search import device_step

    count = device_step.count_mask

    def more(*args, **kwargs):
        counts, mask = count(*args, **kwargs)
        return counts + 1, mask
    monkeypatch.setattr(device_step, "count_mask", more)


def _stale_result(monkeypatch):
    """Every batch gets the first batch's result back."""
    from kmcp_tpu_torch.search import device

    result = device.SearchHandle.result
    first = []

    def stale(self):
        got = result(self)
        if not first:
            first.append(got)
        return first[0]
    monkeypatch.setattr(device.SearchHandle, "result", stale)


@pytest.mark.parametrize("fault", [_half_the_batch, _count_altered,
                                   _stale_result])
def test_a_broken_timed_path_is_not_correct(tiny_root, small_batches,
                                            monkeypatch, fault):
    fault(monkeypatch)
    out = one_run(tiny_root, "dense-se")
    assert out["correct"] is False
    assert out["checks"]["queries_differ"]["value"] > 0


@pytest.mark.parametrize("name,control", [
    ("dense-se", "forward_strand"), ("dense-host90-se", "forward_strand"),
    ("dense-pe", "forward_strand"), ("dense-pe", "counts_u8")])
def test_the_control_is_not_correct(tiny_root, name, control):
    """The reference with one guarantee broken, in the program's place,
    fails the comparison on every seed tried."""
    import limits

    for r in limits.readings(find_cell(name, tiny_root), [1, 2**31 + 7],
                             [control], "cpu", 1.0):
        assert r["correct"] is False and r["queries_differ"] > 0


def test_the_sample_is_drawn_from_the_seed():
    from harness.compare import draw_sample

    a, b = draw_sample(SEED, 10**6), draw_sample(SEED, 10**6)
    assert np.array_equal(a, b) and len(a) == 8192
    assert not np.array_equal(a, draw_sample(SEED + 1, 10**6))
    assert a.max() > 9 * 10**5  # spread over the whole window
    assert len(draw_sample(SEED, 100)) == 100
    assert torch.tensor(a).unique().numel() == len(a)
