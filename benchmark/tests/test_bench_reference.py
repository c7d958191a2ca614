"""The plain reference against the program's host code on the CPU: its
hash, row, sizing and FPR arithmetic, and its rows against the port's
``--backend host`` TSV on tiny DBs."""

import math
import os
import random

import numpy as np
import pytest
import torch

from conftest import CONFIG, tiny_config, tiny_traffic

from harness import compare
from harness.dbcache import ensure_db
from harness.genomes import genome_codes
from harness.reference import (CODE, Hasher, Reference, query_fpr,
                               rows_of, signature_size)
from harness.traffic import make_pool, pool_size, write_fastq


def test_hash_is_canonical_nthash1():
    from kmcp_tpu_torch.kmer.nthash import hash_windows

    rng = np.random.default_rng(1)
    hasher = Hasher(21, "cpu")
    alphabet = np.frombuffer(b"ACGTacgtN", np.uint8)
    seqs = [rng.choice(alphabet, size=n).tobytes() for n in (21, 60, 300)]
    seqs += [rng.choice(alphabet[:4], size=200).tobytes()]
    for s in seqs:
        codes = torch.from_numpy(CODE[np.frombuffer(s, np.uint8)])[None]
        h, ok = hasher(codes)
        fh, _rh, can, valid = hash_windows(s, 21)
        assert np.array_equal(ok[0].numpy(), valid & (can != 0))
        got = h[0].numpy().view(np.uint64)
        assert np.array_equal(got[valid], can[valid])
        hf, _ = hasher(codes, canonical=False)
        assert np.array_equal(hf[0].numpy().view(np.uint64)[valid],
                              fh[valid])


def test_rows_are_exact_unsigned_moduli():
    rng = random.Random(2)
    hs = [rng.getrandbits(64) for _ in range(2000)] + [2**64 - 1, 0, 2**63]
    t = torch.tensor([h - (1 << 64) if h >> 63 else h for h in hs])
    for s in (126_961, 60_894, 2**31 - 1, 7):
        assert rows_of(t, s).tolist() == [h % s for h in hs]


def test_sizing_and_fpr_match_the_programs():
    from kmcp_tpu_torch.index.sizing import calc_signature_size
    from kmcp_tpu_torch.search.fpr import query_fpr as prog_fpr

    for n in (1, 612, 1276, 99_999):
        for f in (0.3, 0.01):
            assert signature_size(n, 1, f) == calc_signature_size(n, 1, f)
    for n, c in ((130, 72), (130, 130), (260, 150), (260, 260), (40, 23)):
        assert query_fpr(n, c, 0.01) == prog_fpr(n, c, 0.01)
    assert not math.isnan(query_fpr(511, 300, 0.3))


def host_rows(db: str, paths: list, paired: bool, tmp: str,
              search: dict) -> dict:
    """{queryIdx: [rows]} of the port's --backend host search."""
    from kmcp_tpu_torch.commands.search import run_search
    from kmcp_tpu_torch.search.engine import SearchOptions

    out = os.path.join(tmp, "host.tsv")
    kw = ({"read1": paths[0], "read2": paths[1]} if paired
          else {"files": paths})
    run_search(db, out_file=out, opt=SearchOptions(backend="host", **search),
               verbose=False, **kw)
    rows: dict = {}
    with open(out) as f:
        for line in f:
            if not line.startswith("#"):
                line = line.rstrip("\n")
                rows.setdefault(int(line.rsplit("\t", 1)[1]), []).append(line)
    return rows


@pytest.mark.parametrize("traffic", ["se", "pe", "host90-se"])
def test_reference_rows_equal_the_host_backend(tmp_path, tiny_root,
                                               traffic):
    cfg, tr = tiny_config(CONFIG), tiny_traffic(traffic)
    db, _ = ensure_db(cfg, os.path.join(tiny_root, "benchmark", ".cache"))
    codes = genome_codes(cfg)
    pool = make_pool(tr, cfg, codes, 77, pool_size(tr, 0.125))
    paths = write_fastq(pool, str(tmp_path))
    got = host_rows(db, paths, tr["paired"], str(tmp_path), cfg["search"])
    idx = np.arange(pool.size)
    queries = compare.sample_queries(pool, idx)
    want = Reference(cfg, codes, "cpu").rows(queries)
    assert sum(len(r) for r in want) > pool.size // 20
    bad, examples = compare.mismatches(got, want, queries)
    assert bad == 0, examples
