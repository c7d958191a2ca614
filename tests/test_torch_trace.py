"""The port's tracer (kmcp_tpu_torch/utils/trace.py) on the CPU: off by
default and free while off; while on, one pull, flush and drain span a
batch with their stages nested inside and carrying the batch's id, the
device ranges inside the dispatch that issued them, byte counters equal to
the copied tensors' sizes, the dedup's counters (the pairs over the
threshold on the ``pe`` route, nothing elsewhere), the collector's runs as
``gc`` spans, the same names in a ``torch.profiler`` trace, the TSV
unchanged, and ``run_search`` exporting the summary."""

import gc
import io

import numpy as np
import pytest
import torch

from kmcp_tpu_torch.commands.search import run_search
from kmcp_tpu_torch.search import device as device_mod
from kmcp_tpu_torch.search import engine as port_engine
from kmcp_tpu_torch.search import stream as stream_mod
from kmcp_tpu_torch.search.stream import TorchStreamSearcher
from kmcp_tpu_torch.utils import trace

from .test_torch_paired import paired_reads
from .test_torch_stream import (_write_fastq, build_db, mixed_reads,
                                random_genomes)

torch.set_num_threads(1)

BATCH = 256
DEVICE_RANGES = {"k1.hash_loc", "tail.prep", "k2.count_mask", "tail.compact",
                 "d2h.result"}
# route -> (paired, backend, KMCP_TPU_DEVICE_HASH)
ROUTES = {"se": (False, "numpy", "1"), "pe": (True, "numpy", "1"),
          "host": (False, "host", "1"), "host-hash": (False, "numpy", "0")}


@pytest.fixture(autouse=True)
def traced_off():
    """Every test starts and ends with the tracer off and empty."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(29)
    genomes = random_genomes(rng, 4, 30000)
    db = build_db(tmp_path_factory.mktemp("trace"), genomes)
    return db, genomes


def queries(world, paired: bool, n: int = 700):
    rng = np.random.default_rng(5)
    if paired:
        return paired_reads(rng, world[1], n)
    return mixed_reads(rng, world[1], n)


def stream(world, route, monkeypatch):
    """The route's TSV and its drained batches' idx0."""
    paired, backend, device_hash = ROUTES[route]
    monkeypatch.setattr(stream_mod, "MIN_BATCH", BATCH)
    monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", device_hash)
    opt = port_engine.SearchOptions(batch_size=BATCH, backend=backend,
                                    paired_fpr_buf=paired)
    st = TorchStreamSearcher(port_engine.SearchEngine([world[0]], opt), "cpu")
    buf = io.StringIO()
    qs = queries(world, paired)
    total, _ = st.run(iter(qs), buf, paired=paired)
    assert total == len(qs)
    return buf.getvalue(), list(range(0, total, st.batch_size()))


def test_off_by_default_costs_nothing(world, monkeypatch):
    """No span, no clock read, no record_function, no gc callback."""
    def boom(*a, **k):
        raise AssertionError("called while tracing is off")

    callbacks = list(gc.callbacks)
    monkeypatch.setattr(trace, "clock", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not trace.TRACER.on
    stream(world, "pe", monkeypatch)
    assert trace.TRACER.spans == [] and gc.callbacks == callbacks
    assert trace.summary()["counters"]["h2d_bytes"] == 0
    assert trace.span("a") is trace.span("b")  # one shared no-op


@pytest.mark.parametrize("route", list(ROUTES))
def test_spans_nest_by_batch_and_tsv_is_unchanged(world, monkeypatch, route):
    plain, batches = stream(world, route, monkeypatch)
    assert len(batches) >= 3
    trace.enable()
    traced, _ = stream(world, route, monkeypatch)
    trace.disable()
    assert traced == plain
    spans = trace.TRACER.closed()
    by_id = {s.id: s for s in spans}
    for name in ("stream.pull", "stream.flush", "stream.drain"):
        top = [s.batch for s in spans if s.name == name]
        # the last pull finds the end of the input
        n = len(queries(world, ROUTES[route][0]))
        want = batches + [n] if name == "stream.pull" else batches
        assert sorted(top) == want, name
        assert all(s.parent == -1 for s in spans if s.name == name)
    for s in spans:
        if s.parent >= 0:
            p = by_id[s.parent]
            assert p.start <= s.start <= s.end <= p.end, (p, s)
            assert s.batch == p.batch
    under = {s.name for s in spans if s.parent >= 0}
    assert {"stream.pack", "stream.dispatch", "stream.wait", "stream.order",
            "stream.emit"} <= under
    names = {s.name for s in spans}
    if route in ("se", "pe"):
        assert DEVICE_RANGES <= names
        for s in spans:
            if s.name in DEVICE_RANGES - {"d2h.result"}:
                assert by_id[s.parent].name == "stream.dispatch"
    assert ("tail.dedup" in names) == (route == "pe")
    if route == "host":  # counted on the host's worker: no device range
        assert not names & DEVICE_RANGES
    c = trace.summary()["counters"]
    assert c["batches"] == len(batches)
    assert c["queries"] == len(queries(world, ROUTES[route][0]))
    assert c["tsv_rows"] == traced.count("\n")
    # the plain dedup on the CPU: no K8' launch; rows over 256 windows of
    # 21-mers (the joined row's N breaks a window) are uniqued
    over = sum(max(len(q[1]) - 20, 0) + max(len(q[2]) - 20, 0) > 256
               for q in queries(world, True)) if route == "pe" else 0
    assert c["dedup_launches"] == 0
    assert c["dedup_reads"] == over and (over > 100) == (route == "pe")
    assert (c["dedup_dropped"] > 0) == (route == "pe")


@pytest.mark.parametrize("route", ["se", "pe", "host-hash"])
def test_byte_counters_equal_the_copied_sizes(world, monkeypatch, route):
    """h2d: the reads matrix (or the host-hashed locations) and every
    host plane sent up; d2h: each step's three result tensors."""
    got = {"h2d": 0, "d2h": 0}

    def spy(fn, key, size):
        def call(*a, **k):
            got[key] += size(*a, **k)
            return fn(*a, **k)
        return call

    copy = device_mod._copy_async
    monkeypatch.setattr(device_mod, "_copy_async", spy(
        copy, "d2h", lambda res: sum(t.numel() * t.element_size()
                                     for t in (res.meta, res.aux,
                                               res.ranges))))
    monkeypatch.setattr(device_mod, "to_device", spy(
        device_mod.to_device, "h2d",
        lambda a, dev: np.ascontiguousarray(a).nbytes))
    monkeypatch.setattr(stream_mod, "_pack_reads_matrix", spy(
        stream_mod._pack_reads_matrix, "h2d",
        lambda seqs, lens, lmax, out=None: out.nbytes))
    planes = device_mod.TorchDeviceDB._host_planes
    monkeypatch.setattr(device_mod.TorchDeviceDB, "_host_planes", spy(
        planes, "h2d", lambda self, ps, fills: sum(
            np.asarray(a).size * 4 for a in ps
            if not isinstance(a, torch.Tensor))))
    hash_loc = stream_mod.native.hash_reads_loc
    monkeypatch.setattr(stream_mod.native, "hash_reads_loc", spy(
        hash_loc, "h2d", lambda *a, out=None, **k: out.nbytes))
    trace.enable()
    stream(world, route, monkeypatch)
    c = trace.summary()["counters"]
    assert got["h2d"] > 0 and got["d2h"] > 0
    assert (c["h2d_bytes"], c["d2h_bytes"]) == (got["h2d"], got["d2h"])


def test_summary_self_time(monkeypatch):
    ticks = iter(range(0, 10**6, 10))
    monkeypatch.setattr(trace, "clock", lambda: next(ticks))
    trace.enable()
    gc.disable()  # no collection may read the clock here
    try:
        with trace.span("a", 7):  # 0 .. 50
            with trace.span("b"):  # 10 .. 40
                with trace.span("c"):  # 20 .. 30
                    pass
        with trace.span("b", 9):  # 60 .. 70
            pass
    finally:
        gc.enable()
    s = trace.summary()["spans"]
    assert s["a"] == {"count": 1, "total_s": pytest.approx(50e-9),
                      "self_s": pytest.approx(20e-9)}
    assert s["b"] == {"count": 2, "total_s": pytest.approx(40e-9),
                      "self_s": pytest.approx(30e-9)}
    assert s["c"]["self_s"] == s["c"]["total_s"] == pytest.approx(10e-9)
    assert [x.batch for x in trace.TRACER.closed()] == [7, 7, 7, 9]


def test_gc_collect_is_a_generation_2_span():
    callbacks = len(gc.callbacks)
    trace.enable()
    assert len(gc.callbacks) == callbacks + 1
    with trace.span("outer", 3):
        gc.collect()
    trace.disable()
    assert len(gc.callbacks) == callbacks
    spans = trace.TRACER.closed()
    outer = next(s for s in spans if s.name == "outer")
    g = [s for s in spans if s.name == "gc" and s.gen == 2]
    assert g and g[0].parent == outer.id and g[0].batch == 3
    assert outer.start <= g[0].start <= g[0].end <= outer.end
    assert trace.summary()["counters"]["gc_collections"][2] >= 1


@pytest.mark.parametrize("route", ["se", "pe"])
def test_span_names_in_a_profiler_trace(world, monkeypatch, route):
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        stream(world, route, monkeypatch)
    trace.disable()
    seen = {e.name for e in prof.events()}
    ours = {s.name for s in trace.TRACER.spans} - {"gc"}
    assert ours <= seen
    assert {"stream.pull", "stream.flush", "stream.drain"} | DEVICE_RANGES \
        <= seen


def test_run_search_exports_the_summary(world, tmp_path, monkeypatch,
                                        capsys):
    monkeypatch.setattr(stream_mod, "MIN_BATCH", BATCH)
    reads = [(r[0], r[1]) for r in queries(world, False)]
    fq = _write_fastq(tmp_path / "r.fq", reads)
    opt = port_engine.SearchOptions(batch_size=BATCH)
    stats = {}
    run_search(world[0], [fq], out_file=str(tmp_path / "a.tsv"), opt=opt,
               device="cpu", verbose=False, stats=stats)
    assert "trace" not in stats
    monkeypatch.setenv("KMCP_TPU_TRACE", "1")
    stats = {}
    run_search(world[0], [fq], out_file=str(tmp_path / "b.tsv"), opt=opt,
               device="cpu", verbose=True, stats=stats)
    assert not trace.TRACER.on  # traced this search alone
    tr = stats["trace"]
    assert tr["spans"]["stream.drain"]["count"] == 3
    c = tr["counters"]
    assert c["queries"] == len(reads) and c["batches"] == 3
    assert c["retries"] == stats["retries"]
    assert c["slow_rows"] == stats["slow_rows"] > 0
    assert set(c["launches"]) == {"hash_loc", "count_mask", "pair_count",
                                  "group_count", "compact", "dedup"}
    # the CPU takes the plain versions; single reads are never uniqued
    assert c["compact_launches"] == c["dedup_launches"] == 0
    assert c["dedup_reads"] == c["dedup_dropped"] == 0
    assert (tmp_path / "a.tsv").read_bytes() == \
        (tmp_path / "b.tsv").read_bytes()
    line = capsys.readouterr().err.strip().splitlines()[-1]
    assert line.startswith("[search] trace: us/query pull ")
    assert "B/query" in line and "% of" in line
    assert line.endswith("; dedup 0.000 of queries")
