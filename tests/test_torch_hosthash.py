"""Host hashing on the device (ROADMAP A15) on the CPU: with
``KMCP_TPU_DEVICE_HASH=0`` the streamer hashes reads with the C++ to Bloom
locations and K2' (its plain version on CPU tensors) counts them.

- Single-end reads (some too short, some over the dedup threshold) on one
  block, read pairs (joined rows past 256 k-mers are slow rows) and
  batches that overflow their budget: the TSV is kmcp_tpu's ``--backend
  jax`` TSV with ``KMCP_TPU_DEVICE_HASH=0`` (its host-hash branch) and
  ``--backend host``'s, byte for byte; on three hashes, ``--backend
  host``'s.  The port streams 256-read batches (``stream.MIN_BATCH``
  patched), several in flight.
- A non-canonical one-block DB streams on this branch (the host hash
  honours the flag): kmcp_tpu's host-hash TSV and ``--backend host``'s,
  byte for byte, and not the canonical DB's.
- Multi-block and sketch DBs take the object engine on this branch, as in
  kmcp_tpu.
- ``TorchDeviceDB.search_async`` returns a handle whose result holds the
  candidates of kmcp_tpu's ``DeviceDB.search_async``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from kmcp_tpu.commands.search import run_search as run_search_host
from kmcp_tpu.search.device import DeviceDB
from kmcp_tpu.search.engine import SearchEngine as JaxEngine
from kmcp_tpu.search.engine import SearchOptions
from kmcp_tpu_torch.commands.search import run_search
from kmcp_tpu_torch.kmer import native
from kmcp_tpu_torch.search import engine as port_engine
from kmcp_tpu_torch.search import stream
from kmcp_tpu_torch.search.device import SearchHandle, TorchDeviceDB

from .test_torch_engine import write_fastq
from .test_torch_hostdb import build
from .test_torch_stream import mixed_reads, random_genomes

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("hosthash")
    rng = np.random.default_rng(29)
    genomes = random_genomes(rng, 4, 20000)
    w = {
        "one": build(root / "one", genomes, tpu_native=True),
        "three": build(root / "three", genomes, tpu_native=True, h=3),
        "multi": build(root / "multi", genomes, block_size=2),
        "minimizer": build(root / "mini", genomes, tpu_native=True,
                           sketch={"minimizer_w": 5}),
        "genomes": genomes,
    }
    nc = str(root / "noncanonical")
    shutil.copytree(w["one"], nc)
    with open(os.path.join(nc, "db.json")) as f:
        info = f.read()
    with open(os.path.join(nc, "db.json"), "w") as f:
        f.write(info.replace('"canonical": true', '"canonical": false'))
    w["noncanonical"] = nc
    reads = [(r[0], r[1]) for r in mixed_reads(rng, genomes, 600)]
    w["reads"], w["few"] = str(root / "reads.fq"), str(root / "few.fq")
    write_fastq(w["reads"], reads)
    write_fastq(w["few"], reads[:40])
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    m1, m2 = [], []
    for i in range(120):
        g = genomes[i % 4]
        p = int(rng.integers(0, len(g) - 350))
        ln = 150 if i % 5 else 100  # 100 + 1 + 100 bases: 160 k-mers
        m1.append((f"p{i}", g[p : p + ln]))
        m2.append((f"p{i}", g[p + 200 : p + 200 + ln].translate(rc)[::-1]
                   if i % 3 else rng.choice(bases, size=ln).tobytes()))
    w["r1"], w["r2"] = str(root / "r1.fq"), str(root / "r2.fq")
    write_fastq(w["r1"], m1)
    write_fastq(w["r2"], m2)
    w["n_long_pairs"] = sum(1 for i in range(120) if i % 5)
    return w


@pytest.fixture(autouse=True)
def small_batches(monkeypatch):
    monkeypatch.setattr(stream, "MIN_BATCH", 256)


def tsvs(world, tmp_path, key, query, backends=("jax", "host"), **opt_kw):
    """(the port's host-hash TSV on the CPU and its stats, [kmcp_tpu's TSV
    with each backend])."""
    stats: dict = {}
    run_search(world[key], out_file=str(tmp_path / "port.tsv"),
               device="cpu", verbose=False, stats=stats,
               opt=port_engine.SearchOptions(batch_size=256, **opt_kw),
               **query)
    got = (tmp_path / "port.tsv").read_bytes()
    want = []
    for backend in backends:
        out = tmp_path / f"{backend}.tsv"
        run_search_host(world[key], out_file=str(out), verbose=False,
                        opt=SearchOptions(backend=backend, **opt_kw), **query)
        want.append(out.read_bytes())
    return got, want, stats


@pytest.mark.parametrize("key", ["one", "three"])
def test_single_end_matches_jax_host_hash(world, tmp_path, monkeypatch, key):
    monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", "0")
    # the JAX step compiles for a while on the CPU: once, on one block
    backends = ("jax", "host") if key == "one" else ("host",)
    got, want, stats = tsvs(world, tmp_path, key,
                            {"files": [world["reads"]]}, backends)
    assert want == [got] * len(backends)
    assert stats["route"] == "stream" and stats["hash"] == "host"
    n_long = sum(1 for i in range(600) if i % 37 == 0)
    assert stats["slow_rows"] == n_long > 0
    assert got.count(b"\n") > 500


def test_noncanonical_matches_jax_host_hash(world, tmp_path, monkeypatch):
    """A non-canonical one-block DB streams with host hashing: kmcp_tpu's
    host-hash TSV and ``--backend host``'s, and not the canonical DB's
    (the reads' reverse-strand k-mers no longer count)."""
    monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", "0")
    got, want, stats = tsvs(world, tmp_path, "noncanonical",
                            {"files": [world["reads"]]})
    assert want == [got, got]
    assert stats["route"] == "stream" and stats["hash"] == "host"
    canonical, _, _ = tsvs(world, tmp_path, "one",
                           {"files": [world["reads"]]}, ())
    assert canonical != got and got.count(b"\n") > 100


def test_paired_slow_rows(world, tmp_path, monkeypatch):
    """Joined 150 + 150 base rows (260 k-mers) are over the dedup
    threshold, which the host hash does not unique: they are slow rows,
    the 100 + 100 base ones are not."""
    monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", "0")
    got, want, stats = tsvs(world, tmp_path, "one",
                            {"read1": world["r1"], "read2": world["r2"]})
    assert want == [got, got]
    assert stats["hash"] == "host"
    assert stats["slow_rows"] == world["n_long_pairs"]
    assert got.count(b"\n") > 100


def test_budget_overflow_retry(world, tmp_path, monkeypatch):
    """256-read batches from 4 slots each: every batch overflows and
    re-runs at 4x, 4 batches in flight."""
    monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", "0")
    monkeypatch.setattr(stream, "SLOTS_PER_READ", 4 / 256)
    got, want, stats = tsvs(world, tmp_path, "one",
                            {"files": [world["reads"]]})
    assert want == [got, got]
    assert stats["retries"] >= 3 and stats["in_flight"] == 4


def test_routes(world, tmp_path, monkeypatch):
    """Multi-block and sketch DBs take the object engine on the host-hash
    branch, and sketch DBs under "scan" too, as kmcp_tpu's streamer
    declines them (stream.py:221); "1" and "scan" hash on the device."""
    def route(key, backend="numpy"):
        stats: dict = {}
        run_search(world[key], [world["few"]], device="cpu",
                   out_file=str(tmp_path / "out.tsv"), verbose=False,
                   stats=stats, opt=port_engine.SearchOptions(
                       batch_size=256, backend=backend))
        return stats["route"], stats.get("hash")

    for value, want in (("0", "host"), ("host", "host"), ("1", "device"),
                        ("scan", "device")):
        monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", value)
        assert route("one") == ("stream", want)
        assert route("minimizer")[0] == ("stream" if value == "1"
                                         else "engine")
        assert route("multi") == ("engine", None)
        assert route("one", backend="host") == ("stream", "host")
    monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", "0")
    eng = port_engine.SearchEngine([world["one"]], port_engine.SearchOptions())
    eng.dbs[0].info.canonical = False
    assert stream.usable(eng)
    monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", "1")
    assert not stream.usable(eng)


@pytest.mark.parametrize("h", [1, 3])
def test_search_async_handle_matches_jax(world, h):
    key = "one" if h == 1 else "three"
    rng = np.random.default_rng(h)
    reads = [g[p : p + 150] for g in world["genomes"]
             for p in rng.integers(0, 19000, 40).tolist()]
    opt = port_engine.SearchOptions()
    db = port_engine.SearchEngine([world[key]], opt).dbs[0]
    dev = TorchDeviceDB(db, opt, "cpu")
    loc, nk = native.hash_reads_loc(reads, 21, 160, dev.total_rows, h)
    budget = 4 * len(reads)
    handle = dev.search_async(loc, nk, budget)
    assert isinstance(handle, SearchHandle)
    meta, aux = handle.result()
    jdb = JaxEngine([world[key]], SearchOptions()).dbs[0]
    want = np.asarray(DeviceDB(jdb, SearchOptions()).search_async(
        loc, nk, budget))
    n = int(meta[0])
    assert n == int(want[0]) > len(reads)
    np.testing.assert_array_equal(meta[1 : 1 + n], want[1 : 1 + n])
    np.testing.assert_array_equal(aux[:n], want[1 + budget : 1 + budget + n])
