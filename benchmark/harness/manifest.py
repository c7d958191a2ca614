"""BENCHMARK.json and the files it names: a cell's configuration, its
traffic mix and its per-layer metrics, each found by name."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)  # the checkout the benchmark runs from


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names read in: ``config``
    and ``traffic`` are the parsed files, ``end_to_end`` and
    ``per_layer`` the metric entries this cell reports."""

    name: str
    root: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list

    @property
    def cache_dir(self) -> str:
        """Where DBs, genomes and k-mer files built on a cache miss stay:
        a fixed directory inside the checkout."""
        return os.path.join(self.root, "benchmark", ".cache")


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    config["name"] = w["config"]
    traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                     f"{w['traffic']}.json"))
    traffic["name"] = w["traffic"]
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if _reports(m, name) and m["moves"] in e2e_names]
    return Cell(name, root, config, traffic, int(w["chips"]), e2e, layer)


def load_metric(name: str, root: str = ROOT):
    """The reader module ``benchmark/metrics/<name>.py``: ``read(record)``
    returns the metric's value or None, and an optional ``instrument``
    (a context manager factory taking the record) installs what it reads
    for the whole run."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
