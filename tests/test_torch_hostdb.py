"""The host search backend (ROADMAP A14) of the port on the CPU.

- The port's C++ read hashing and counters (csrc/host/nthash.cpp through
  kmer/native.py) equal kmcp_tpu's on the same seeded inputs, exactly:
  ``hash_reads_padded`` and ``hash_reads_loc`` (plain, minimizer and
  syncmer windows, with and without the dedup threshold),
  ``count_block``, ``count_block_sparse``, ``count_hashes_sparse`` (with
  and without a read mask) and ``union_count``; and the build without
  AVX2 (``g++ -mno-avx2``, the scalar branches) equals the AVX2 build.
- ``run_search`` on backend "host" writes the TSV of kmcp_tpu's ``search
  --backend host`` byte for byte: one block (1 and 3 hashes), several
  blocks without screens (2 hashes), a screened ``--uniform-sigs`` DB with
  and without ``KMCP_TPU_NO_SCREEN``, pairs on one block and on several,
  minimizer and syncmer DBs single-end and paired (mates), a
  non-canonical DB, a multi-k DB, ``-n 1``, a budget that overflows, ``-g``
  on the engine's C++ counter, a reference ``.kmcp`` DB and ``--low-mem``
  (reading fewer bytes than the block file holds); it never opens a torch
  device.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from kmcp_tpu.commands.compute import ComputeOptions, run_compute
from kmcp_tpu.commands.search import run_search as run_search_host
from kmcp_tpu.index.build import run_index
from kmcp_tpu.kmer import native as jax_native
from kmcp_tpu.search.engine import SearchOptions
from kmcp_tpu_torch import cli
from kmcp_tpu_torch.commands import search as port_search
from kmcp_tpu_torch.commands.search import run_search
from kmcp_tpu_torch.index import uniki
from kmcp_tpu_torch.kmer import native
from kmcp_tpu_torch.search import engine as port_engine

from .test_torch_engine import write_fastq
from .test_torch_stream import mixed_reads, random_genomes

torch.set_num_threads(1)

ACGTN = np.frombuffer(b"ACGTNacgt", dtype=np.uint8)


def seeded_reads(rng, n=60):
    """Reads of 0-700 bases with Ns and lowercase, and a few of 600
    bases (past a dedup threshold of 256 windows, and of 64 selected
    sketch windows)."""
    lens = rng.integers(0, 300, n)
    lens[::9] = 600
    p = np.array([0.24] * 4 + [0.01, 0.09, 0.09, 0.09, 0.09])
    return [rng.choice(ACGTN, size=int(n), p=p / p.sum()).tobytes()
            for n in lens]


@pytest.mark.parametrize("sketch", [{}, {"minimizer_w": 5},
                                    {"syncmer_s": 11}])
@pytest.mark.parametrize("dedup", [0, 64])
def test_hash_reads_match_kmcp_tpu(sketch, dedup):
    rng = np.random.default_rng(7 + dedup + len(sketch))
    reads = seeded_reads(rng)
    kw = dict(canonical=True, max_hash=(1 << 63) + 12345,
              dedup_threshold=dedup, **sketch)
    got = native.hash_reads_padded(reads, 21, 700, **kw)
    want = jax_native.hash_reads_padded(reads, 21, 700, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].max() > (dedup or 10)
    for h in (1, 3):
        got = native.hash_reads_loc(reads, 21, 700, 4999, h, **kw)
        want = jax_native.hash_reads_loc(reads, 21, 700, 4999, h, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    kw["canonical"] = False
    np.testing.assert_array_equal(
        native.hash_reads_padded(reads, 21, 700, **kw)[0],
        jax_native.hash_reads_padded(reads, 21, 700, **kw)[0])


def counter_inputs(rng, h):
    """A random matrix with its sentinel row, locations with padding
    lanes (600 windows a read: past the 255-window widening of the AVX2
    counters), hashes with zero lanes, floors and a read mask."""
    S, W, B, K = 997, 3, 40, 600
    bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
    bits |= rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
    bits[S] = 0
    loc = rng.integers(0, S, (B, K, h)).astype(np.int32)
    lens = rng.integers(0, K + 1, B)
    loc[np.arange(K)[None, :] >= lens[:, None]] = S
    hashes = rng.integers(1, 2**64, (B, K), dtype=np.uint64)
    hashes[np.arange(K)[None, :] >= lens[:, None]] = 0
    cmin = rng.integers(1, 400, B).astype(np.int32)
    cmin[::7] = np.iinfo(np.int32).max
    tmin = rng.integers(1, 200, 32 * W).astype(np.int32)
    tmin[-3:] = np.iinfo(np.int32).max
    active = (rng.random(B) < 0.7).astype(np.uint8)
    return bits, loc, hashes, cmin, tmin, active


def sparse_pairs(n, idx, cnt, budget):
    """The stored candidates as (id, count) pairs in id order: the
    counters append in their threads' order."""
    m = min(n, budget)
    order = np.argsort(idx[:m], kind="stable")
    return n, idx[:m][order], cnt[:m][order]


def run_counters(mod, rng_seed, h):
    """Every counter of ``mod`` (a native module) on one seeded input."""
    rng = np.random.default_rng(rng_seed)
    bits, loc, hashes, cmin, tmin, active = counter_inputs(rng, h)
    out = {"dense": mod.count_block(bits, loc, h),
           "dense_active": mod.count_block(bits, loc, h, active=active)}
    for budget in (10**6, 50):
        for act in (None, active):
            idx = np.zeros(budget, np.int64)  # slots 0-2: an earlier call
            cnt = np.zeros(budget, np.int32)
            n = mod.count_block_sparse(bits, loc, h, cmin, tmin, 96, 500,
                                       budget, idx, cnt, 3, active=act)
            out[("loc", budget, act is None)] = sparse_pairs(n, idx, cnt,
                                                             budget)
            n = mod.count_hashes_sparse(bits, hashes, h, 991, 5, cmin, tmin,
                                        96, 500, budget, idx, cnt, 3,
                                        active=act)
            out[("hash", budget, act is None)] = sparse_pairs(n, idx, cnt,
                                                              budget)
    words = rng.integers(0, 2**64, 1 << 10, dtype=np.uint64)
    out["union"] = mod.union_count(words, 65_000, hashes)
    return out


def assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in got:
        g, w = got[key], want[key]
        if isinstance(g, tuple):  # (total, ids, counts)
            assert g[0] == w[0], key
            g, w = g[1:], w[1:]
        else:
            g, w = (g,), (w,)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b, err_msg=str(key))


@pytest.mark.parametrize("h", [1, 3])
def test_counters_match_kmcp_tpu(h):
    got = run_counters(native, 100 + h, h)
    assert_same(got, run_counters(jax_native, 100 + h, h))
    assert got["dense"].max() > 255  # the widening ran
    assert got[("loc", 50, True)][0] > 50  # an overflow counts on
    assert got[("hash", 10**6, False)][0] > 0


def test_scalar_build_matches_avx2(tmp_path, monkeypatch):
    """The counters' and hashers' scalar branches (a host without AVX2,
    e.g. an aarch64 one) give the AVX2 branches' results."""
    so = str(tmp_path / "libkmcp_host_scalar.so")
    cmd = ["g++", *native.GXX_FLAGS, "-mno-avx2", "-o", so,
           *native.sources()]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    rng = np.random.default_rng(3)
    reads = seeded_reads(rng, 30)
    want = {h: run_counters(native, 200 + h, h) for h in (1, 3)}
    want_hash = native.hash_reads_loc(reads, 21, 700, 4999, 2,
                                      minimizer_w=5, dedup_threshold=64)
    native.get_lib()
    monkeypatch.setattr(native, "_lib", native.bind(ctypes.CDLL(so)))
    for h in (1, 3):
        assert_same(run_counters(native, 200 + h, h), want[h])
    for g, w in zip(native.hash_reads_loc(reads, 21, 700, 4999, 2,
                                          minimizer_w=5,
                                          dedup_threshold=64), want_hash):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ searches

def build(root, genomes, ks=(21,), split_number=3, sketch=None, **index_kw):
    """kmcp_tpu's compute + index of the genomes (the port's write the same
    bytes, test_torch_host.py), FPR 0.3."""
    os.makedirs(root, exist_ok=True)
    files = []
    for g, seq in enumerate(genomes):
        p = os.path.join(root, f"g{g}.fa")
        with open(p, "w") as f:
            f.write(f">g{g}\n{seq.decode()}\n")
        files.append(p)
    ks_dir, db = os.path.join(root, "ks"), os.path.join(root, "db")
    run_compute(out_dir=ks_dir, files=files,
                opt=ComputeOptions(ks=list(ks), split_number=split_number,
                                   split_overlap=100, **(sketch or {})),
                force=True, verbose=False)
    run_index(in_dir=ks_dir, out_dir=db, num_hashes=index_kw.pop("h", 1),
              fpr=index_kw.pop("fpr", 0.3), force=True, verbose=False,
              **index_kw)
    return db


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The DBs of four 20 kb genomes, the reads (mixed lengths, junk,
    reads mutated every 25 bases for the multi-k retry) and read pairs."""
    root = tmp_path_factory.mktemp("hostdb")
    rng = np.random.default_rng(23)
    genomes = random_genomes(rng, 4, 20000)
    w = {
        "one": build(root / "one", genomes, tpu_native=True),
        "three": build(root / "three", genomes, tpu_native=True, h=3),
        "multi": build(root / "multi", genomes, block_size=2, h=2),
        "screened": build(root / "screened", genomes, split_number=4,
                          tpu_native=True, native_block_targets=4,
                          block_screen=True, uniform_sigs=True),
        "minimizer": build(root / "mini", genomes, tpu_native=True,
                           sketch={"minimizer_w": 5}),
        "syncmer": build(root / "sync", genomes, tpu_native=True,
                         sketch={"syncmer_s": 11}),
        "multi_k": build(root / "multik", genomes, ks=(21, 31),
                         tpu_native=True),
    }
    nc = str(root / "noncanonical")
    shutil.copytree(w["one"], nc)
    with open(os.path.join(nc, "db.json")) as f:
        info = f.read()
    with open(os.path.join(nc, "db.json"), "w") as f:
        f.write(info.replace('"canonical": true', '"canonical": false'))
    w["noncanonical"] = nc
    w["ref"] = uniki.export_ref_layout(w["one"], str(root / "ref"))
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = [(r[0], r[1]) for r in mixed_reads(rng, genomes, 100)]
    for i in range(30):
        g = genomes[i % 4]
        p = int(rng.integers(0, len(g) - 150))
        r = bytearray(g[p : p + 150])
        for q in range(5 + i % 20, 150, 25):
            r[q] = ord("A") if r[q] != ord("A") else ord("C")
        reads.append((f"m{i}", bytes(r)))
        reads.append((f"j{i}", rng.choice(bases, size=150).tobytes()))
    w["reads"] = str(root / "reads.fq")
    write_fastq(w["reads"], reads)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    m1, m2 = [], []
    for i in range(60):
        g = genomes[i % 4]
        p = int(rng.integers(0, len(g) - 350))
        m1.append((f"p{i}", g[p : p + 150]))
        m2.append((f"p{i}", g[p + 200 : p + 350].translate(rc)[::-1]
                   if i % 3 else rng.choice(bases, size=150).tobytes()))
    w["r1"], w["r2"] = str(root / "r1.fq"), str(root / "r2.fq")
    write_fastq(w["r1"], m1)
    write_fastq(w["r2"], m2)
    w["genome"] = str(root / "one" / "g1.fa")
    return w


CASES = {
    # case: (DB, reads: "single" | "paired" | "genome", option fields,
    #        the route)
    "one_h1": ("one", "single", {}, "stream"),
    "one_h3": ("three", "single", {}, "stream"),
    "multi_block_h2": ("multi", "single", {}, "stream"),
    "screened": ("screened", "single", {}, "stream"),
    "screened_no_screen": ("screened", "single", {}, "stream"),
    "paired_one": ("one", "paired", {}, "stream"),
    "paired_multi": ("multi", "paired", {}, "stream"),
    "minimizer": ("minimizer", "single", {}, "stream"),
    "minimizer_paired": ("minimizer", "paired", {}, "stream"),
    "syncmer": ("syncmer", "single", {}, "stream"),
    "syncmer_paired": ("syncmer", "paired", {}, "stream"),
    "noncanonical": ("noncanonical", "single", dict(keep_unmatched=True),
                     "stream"),
    "multi_k": ("multi_k", "single", {}, "stream"),
    "top_n": ("one", "single", dict(keep_top_scores=1, keep_unmatched=True),
              "stream"),
    "ref_kmcp": ("ref", "single", {}, "stream"),
    "whole_file": ("one", "genome", dict(min_query_cov=0.4), "engine"),
    "low_mem": ("one", "single", dict(low_mem=True), "engine"),
}


def query_args(world, kind):
    if kind == "paired":
        return {"read1": world["r1"], "read2": world["r2"]}
    if kind == "genome":
        return {"files": [world["genome"]], "whole_file": True}
    return {"files": [world["reads"]]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_backend_matches_kmcp_tpu(world, tmp_path, monkeypatch, case):
    key, kind, kw, route = CASES[case]
    if case == "screened_no_screen":
        monkeypatch.setenv("KMCP_TPU_NO_SCREEN", "1")

    def no_device(device):
        raise AssertionError("the host backend opened a torch device")

    monkeypatch.setattr(port_search, "resolve_device", no_device)
    readers = []
    if case == "low_mem":
        class Reader(port_engine.BlockRowReader):
            def __init__(self, *a):
                super().__init__(*a)
                readers.append(self)

        monkeypatch.setattr(port_engine, "BlockRowReader", Reader)
    stats: dict = {}
    args = query_args(world, kind)
    run_search(world[key], out_file=str(tmp_path / "port.tsv"),
               opt=port_engine.SearchOptions(backend="host", **kw),
               verbose=False, stats=stats, **args)
    run_search_host(world[key], out_file=str(tmp_path / "host.tsv"),
                    opt=SearchOptions(backend="host", **kw), verbose=False,
                    **args)
    got = (tmp_path / "port.tsv").read_bytes()
    assert got == (tmp_path / "host.tsv").read_bytes()
    assert stats["route"] == route and stats["backend"] == "host"
    assert got.count(b"\n") > (5 if kind == "genome" else 60)
    if route == "stream":
        assert stats["hash"] == "host" and stats["in_flight"] == 2
    if case.startswith("screened"):
        assert stats["n_blocks"] == 4
        assert (stats["union_rows"] > 0) == (case == "screened")
    if case == "multi_k":
        assert stats["slow_rows"] > 0  # unmatched reads retried at k = 21
    if case == "low_mem":
        size = os.path.getsize(os.path.join(world[key],
                                            "block_000.bits.npy"))
        assert len(readers) == 1 and 0 < readers[0].bytes_read < size


def test_host_budget_overflow_retry(tmp_path, monkeypatch):
    """Eight near-identical genomes: every read matches 8+ targets, past
    the host's 3 slots a read, so a 16,384-read batch re-runs at 4x."""
    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base_seq = bytearray(rng.choice(bases, size=12000).tobytes())
    genomes = []
    for _ in range(8):
        seq = bytearray(base_seq)
        for pos in rng.integers(0, len(seq), size=5):
            seq[pos] = bases[int(rng.integers(0, 4))]
        genomes.append(bytes(seq))
    db = build(tmp_path / "db", genomes, split_number=2, tpu_native=True)
    reads = []
    for i in range(16384):
        p = int(rng.integers(0, len(base_seq) - 150))
        reads.append((f"r{i}", bytes(base_seq[p : p + 150])))
    fq = str(tmp_path / "reads.fq")
    write_fastq(fq, reads)
    stats: dict = {}
    run_search(db, [fq], out_file=str(tmp_path / "port.tsv"),
               opt=port_engine.SearchOptions(backend="host"), verbose=False,
               stats=stats)
    run_search_host(db, [fq], out_file=str(tmp_path / "host.tsv"),
                    opt=SearchOptions(backend="host"), verbose=False)
    got = (tmp_path / "port.tsv").read_bytes()
    assert got == (tmp_path / "host.tsv").read_bytes()
    assert stats["retries"] == 1 and got.count(b"\n") >= 8 * len(reads)


def test_cli_backend_host(world, tmp_path, monkeypatch):
    """``search --backend host`` from the command line, with no CUDA
    device; ``--backend jax`` is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "cli.tsv")
    assert cli.main(["-q", "search", "--backend", "host", "-d", world["one"],
                     world["reads"], "-o", out]) == 0
    run_search_host(world["one"], [world["reads"]],
                    out_file=str(tmp_path / "host.tsv"),
                    opt=SearchOptions(backend="host"), verbose=False)
    with open(out, "rb") as f:
        assert f.read() == (tmp_path / "host.tsv").read_bytes()
    with pytest.raises(SystemExit, match="jax"):
        cli.main(["-q", "search", "--backend", "jax", "-d", world["one"],
                  world["reads"], "-o", out])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-q", "search", "-d", world["one"], world["reads"], "-o",
                  out])
