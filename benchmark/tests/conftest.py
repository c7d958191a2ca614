"""Tiny configurations of the benchmark's cells for the CPU tests: a
checkout-like tree in a temporary directory with its own BENCHMARK.json,
configs and traffic, the real metric readers, and (``small_batches``) the
streamer's batches cut to 1,024 reads so that a window holds several."""

import copy
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)

CONFIG = "gtdb-r202-256g"
TINY = {"genomes": 12, "genome_bp": 4000, "chunks_per_genome": 8,
        "genome_seed": 3}


def tiny_config(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    cfg["search"]["batch_size"] = 1024  # with small_batches: 1,024 a batch
    return cfg


def tiny_traffic(name: str) -> dict:
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        tr = json.load(f)
    tr.update(pool_per_second=8192, source_genomes=4)
    if "host_genome_bp" in tr:
        tr["host_genome_bp"] = 20_000
    return tr


def make_tree(root: str) -> str:
    """A checkout-like tree under ``root`` with the repository's
    BENCHMARK.json and cells over tiny configurations."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    os.makedirs(os.path.join(root, "benchmark", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "benchmark", "traffic"), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(root, "benchmark", "metrics"),
                    dirs_exist_ok=True)
    for c in manifest["configs"]:
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(tiny_config(c["name"]), f)
    for t in {w["traffic"] for w in manifest["workloads"]}:
        with open(os.path.join(root, "benchmark", "traffic", t + ".json"),
                  "w") as f:
            json.dump(tiny_traffic(t), f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tree(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def small_batches(monkeypatch):
    from kmcp_tpu_torch.search import stream

    monkeypatch.setattr(stream, "MIN_BATCH", 256)


def manifest_copy(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return copy.deepcopy(json.load(f))
