"""The object engine on its torch counter (ROADMAP A8) on the CPU.

- ``TorchBlockCounter`` (K2''s plain version on CPU tensors) equals
  kmcp_tpu's ``JaxBlockCounter`` on JAX's CPU and the NumPy counter: one
  and three hashes, padded and masked rows, rows folded into pseudo-rows,
  and a row of 262,150 k-mers (the JAX package's chunked genome path).
- Every search the streamer turns down runs the object engine, and its TSV
  is byte-identical to ``kmcp_tpu search --backend host``: ``-g`` (with
  ``-G`` and ``--query-id``), sort orders other than qcov and ``-S``, two
  DBs at once, paired ``--try-se``, ``--low-mem`` (with its warning), a
  multi-block DB without union screens and a non-canonical DB.
"""

import gzip
import json
import os
import shutil

import numpy as np
import pytest
import torch

from kmcp_tpu.commands.compute import ComputeOptions, run_compute
from kmcp_tpu.commands.search import run_search as run_search_host
from kmcp_tpu.index.build import run_index
from kmcp_tpu.search.engine import SearchOptions
from kmcp_tpu.search.kernel import JaxBlockCounter
from kmcp_tpu_torch.commands.search import run_search
from kmcp_tpu_torch.search import engine as port_engine
from kmcp_tpu_torch.search.kernel import (
    ROW_WINDOWS,
    TorchBlockCounter,
    count_matches_numpy,
)

from .test_torch_stream import mixed_reads, random_genomes

torch.set_num_threads(1)


@pytest.mark.parametrize("h,B,K", [
    (1, 5, 130), (3, 7, 130), (1, 3, ROW_WINDOWS + 1), (3, 4, 1000),
    (1, 1, 262_150),
])
def test_block_counter_matches_jax(tmp_path, monkeypatch, h, B, K):
    monkeypatch.setenv("KMCP_TPU_JAX_CACHE", str(tmp_path / "jax-cache"))
    rng = np.random.default_rng(h * 1000 + K)
    S, W = 977, 3
    bits = (rng.integers(0, 2**32, (S, W), dtype=np.uint32)
            & rng.integers(0, 2**32, (S, W), dtype=np.uint32))
    hashes = rng.integers(0, 2**64, (B, K), dtype=np.uint64)
    lens = rng.integers(0, K + 1, B)
    lens[0] = K
    mask = np.arange(K)[None, :] < lens[:, None]  # padded rows
    mask &= rng.random((B, K)) < 0.9  # and masked windows
    if B > 2:
        mask[1] = False  # a row of no k-mer
    counter = TorchBlockCounter(bits, h, "cpu")
    got = counter(hashes, mask)
    assert got.dtype == np.int32 and got.shape == (B, 32 * W)
    np.testing.assert_array_equal(got, JaxBlockCounter(bits, h)(hashes, mask))
    np.testing.assert_array_equal(got, count_matches_numpy(bits, hashes,
                                                          mask, h))
    loc, owner = counter.rows(hashes, mask)
    assert loc.shape[0] % 1024 == 0 and loc.shape[1] % 32 == 0
    assert loc.shape[1] <= ROW_WINDOWS and got[0].sum() > 0


def build_db(root, genomes, split_number=3, **index_kw):
    """kmcp_tpu's compute + index (the port's write the same bytes,
    test_torch_host.py) of the genomes, k = 21, FPR 0.3."""
    os.makedirs(root, exist_ok=True)
    files = []
    for g, seq in enumerate(genomes):
        p = os.path.join(root, f"g{g}.fa")
        with open(p, "w") as f:
            f.write(f">g{g}\n{seq.decode()}\n")
        files.append(p)
    ks, db = os.path.join(root, "ks"), os.path.join(root, "db")
    run_compute(out_dir=ks, files=files,
                opt=ComputeOptions(ks=[21], split_number=split_number,
                                   split_overlap=100),
                force=True, verbose=False)
    index_kw.setdefault("fpr", 0.3)
    run_index(in_dir=ks, out_dir=db, num_hashes=index_kw.pop("h", 1),
              force=True, verbose=False, **index_kw)
    return db


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """One-block, second one-block (3 hashes), multi-block without screens
    and non-canonical DBs of the same genomes; a directory holding the
    first two; the reads as FASTQ, and read pairs."""
    root = tmp_path_factory.mktemp("engine")
    rng = np.random.default_rng(17)
    genomes = random_genomes(rng, 4, 20000)
    out = {
        "one": build_db(root / "one", genomes, tpu_native=True),
        "three": build_db(root / "three", genomes, tpu_native=True, h=3),
        "multi": build_db(root / "multi", genomes, block_size=2),
    }
    nc = str(root / "noncanonical")
    shutil.copytree(out["one"], nc)
    with open(os.path.join(nc, "db.json")) as f:
        info = json.load(f)
    info["canonical"] = False
    with open(os.path.join(nc, "db.json"), "w") as f:
        json.dump(info, f, indent=1)
    out["noncanonical"] = nc
    both = root / "both"
    both.mkdir()
    for name in ("one", "three"):
        os.symlink(out[name], both / name)
    out["both"] = str(both)
    reads = mixed_reads(rng, genomes, 120)
    out["reads"] = str(root / "reads.fq")
    write_fastq(out["reads"], [(r[0], r[1]) for r in reads])
    # pairs: mate 2 a reverse complement 200 bp on, or junk (--try-se
    # then retries each mate alone)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    m1, m2 = [], []
    for i in range(80):
        g = genomes[i % 4]
        p = int(rng.integers(0, len(g) - 350))
        m1.append((f"p{i}", g[p : p + 150]))
        m2.append((f"p{i}", g[p + 200 : p + 350].translate(rc)[::-1]
                   if i % 3 else rng.choice(bases, size=150).tobytes()))
    out["r1"], out["r2"] = str(root / "r1.fq"), str(root / "r2.fq")
    write_fastq(out["r1"], m1)
    write_fastq(out["r2"], m2)
    return out


def write_fastq(path, recs):
    with open(path, "w") as f:
        for rid, seq in recs:
            f.write(f"@{rid}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")


ROUTES = {
    # case: (db key, reads: "single" | "paired", option fields)
    "sort_tcov": ("one", "single", dict(sort_by="tcov")),
    "sort_jacc": ("three", "single", dict(sort_by="jacc",
                                          keep_top_scores=2)),
    "do_not_sort": ("one", "single", dict(do_not_sort=True)),
    "two_dbs": ("both", "single", {}),
    "try_se": ("one", "paired", dict(try_se=True)),
    "low_mem": ("one", "single", dict(low_mem=True)),
    "multi_block": ("multi", "single", {}),
    "noncanonical": ("noncanonical", "single", dict(keep_unmatched=True)),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_engine_route_matches_host(dbs, tmp_path, capsys, case):
    key, kind, kw = ROUTES[case]
    reads = ({"read1": dbs["r1"], "read2": dbs["r2"]} if kind == "paired"
             else {"files": [dbs["reads"]]})
    stats: dict = {}
    run_search(dbs[key], out_file=str(tmp_path / "port.tsv"), device="cpu",
               verbose=False, stats=stats,
               opt=port_engine.SearchOptions(**kw), **reads)
    err = capsys.readouterr().err
    assert ("--low-mem is ignored" in err) == (case == "low_mem")
    run_search_host(dbs[key], out_file=str(tmp_path / "host.tsv"),
                    opt=SearchOptions(backend="host", **kw), verbose=False,
                    **reads)
    got = (tmp_path / "port.tsv").read_bytes()
    assert got == (tmp_path / "host.tsv").read_bytes()
    assert stats["route"] == "engine"
    assert got.count(b"\n") > 60


def test_whole_file_query_matches_host(tmp_path):
    """The mirror of test_whole_file_query_jax_matches_numpy: ``-g`` with a
    query of genome 0 + half of genome 1 (~450k k-mers, past the JAX
    package's 262,144 genome threshold) and a two-record file (joined by
    k - 1 N's), with query ids from the first record, ``-G`` and
    ``--query-id``; byte-identical to kmcp_tpu's --backend host."""
    rng = np.random.default_rng(11)
    genomes = random_genomes(rng, 3, 300_000)
    db = build_db(tmp_path / "g", genomes, split_number=1, fpr=0.1)
    q1 = tmp_path / "q1.fa"
    q1.write_text(f">q\n{genomes[0].decode()}{genomes[1][:150000].decode()}\n")
    q2 = tmp_path / "two.records.fa.gz"
    with gzip.open(q2, "wt") as f:
        f.write(f">a first\n{genomes[2][:50000].decode()}\n"
                f">b\n{genomes[2][100000:160000].decode()}\n")
    files = [str(q1), str(q2)]
    for kw in ({}, {"use_filename": True}, {"query_id": "myq"}):
        stats: dict = {}
        port_out, host_out = tmp_path / "port.tsv", tmp_path / "host.tsv"
        run_search(db, files, out_file=str(port_out), whole_file=True,
                   opt=port_engine.SearchOptions(min_query_cov=0.3),
                   device="cpu", verbose=False, stats=stats, **kw)
        run_search_host(db, files=files, out_file=str(host_out),
                        whole_file=True,
                        opt=SearchOptions(backend="host", min_query_cov=0.3),
                        verbose=False, **kw)
        got = port_out.read_text()
        assert got == host_out.read_text()
        assert stats["route"] == "engine"
        rows = [line.split("\t") for line in got.splitlines()
                if not line.startswith("#")]
        want_ids = {(): ["q", "a"], ("use_filename",): ["q1", "two.records"],
                    ("query_id",): ["myq", "myq"]}[tuple(kw)]
        assert [r[0] for r in rows if r[5] in ("g0", "g2")] == want_ids
        assert rows[0][5] == "g0"
