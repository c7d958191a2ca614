"""BENCHMARK.json against the benchmark's contract, and the harness finding
configurations, traffic mixes and metric readers by name."""

import json
import os
import re
import statistics

import pytest

from conftest import BENCH, CONFIG, REPO, manifest_copy

from harness.manifest import find_cell, load_metric

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in manifest[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in manifest[k]}) == len(manifest[k])
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 << 10


def test_configs_and_cells(manifest):
    cfgs = {c["name"]: c for c in manifest["configs"]}
    for c in cfgs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        with open(os.path.join(REPO, c["file"])) as f:
            body = json.load(f)
        assert all(k in body["published"] for k in c["reduced"])
    assert len({c["source"] for c in cfgs.values()}) == len(cfgs)
    used = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in cfgs
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
    assert {w["config"] for w in manifest["workloads"]} == set(cfgs)


def test_metrics_and_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        # listed, so that a cell added later does not report it unasked
        assert set(m["workloads"]) <= cells
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"
    layers = {}
    for m in manifest["per_layer"]:  # one layer, one spelling
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_run_seconds_fit_the_check(manifest):
    """A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    2 x 90 s a cell to compile, 1,200 s spare, within 43,200 s."""
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_cells_found_by_name(tiny_root):
    cell = find_cell("dense-se", tiny_root)
    assert cell.config["name"] == CONFIG
    assert cell.traffic["name"] == "se" and not cell.traffic["paired"]
    assert [m["name"] for m in cell.end_to_end] == [
        "device_ns_per_query", "setup_s"]
    layer = [m["name"] for m in cell.per_layer]
    assert "count_mask_roofline" in layer
    with pytest.raises(SystemExit):
        find_cell("no-such-cell", tiny_root)


def test_new_traffic_file_and_entry_make_a_cell(tmp_path):
    """A later cell needs only a new data file and a new entry."""
    from conftest import make_tree

    root = make_tree(str(tmp_path))
    with open(os.path.join(root, "benchmark", "traffic", "se.json")) as f:
        tr = json.load(f)
    tr["mix"] = {"source": 0.5, "random": 0.5}
    with open(os.path.join(root, "benchmark", "traffic", "half-se.json"),
              "w") as f:
        json.dump(tr, f)
    m = manifest_copy(root)
    m["workloads"].append({"name": "dense-half-se",
                           "config": CONFIG,
                           "traffic": "half-se", "chips": 1, "why": "x"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    cell = find_cell("dense-half-se", root)
    assert cell.traffic["mix"] == {"source": 0.5, "random": 0.5}
    # every per-layer metric lists its cells, so a new cell reports none
    # of them until an entry names it; one without a workloads key would
    # be read in every cell that reports the metric it moves
    assert cell.per_layer == []
    del m["per_layer"][0]["workloads"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    layer = [x["name"] for x in find_cell("dense-half-se", root).per_layer]
    assert layer == [m["per_layer"][0]["name"]]


@pytest.mark.parametrize("name", ["parse_us_per_q", "writer_us_per_q",
                                  "device_idle_share",
                                  "count_mask_roofline"])
def test_metric_readers_load_and_read_nothing_empty(name):
    """Each reader loads by name; with nothing recorded it returns None
    (the metric is left out of the line), never 0."""
    import torch

    from harness.window import Record

    mod = load_metric(name, REPO)
    assert mod.read(Record(torch)) is None


def test_quartile_spread_helper_is_pythons():
    """Bounds are set from statistics.quantiles(values, n=4) (kept here
    as the record of how the spread is read)."""
    q1, _, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert (q1, q3) == (1.75, 5.25)
