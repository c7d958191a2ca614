"""The read-pool generator: deterministic for a seed, different across
seeds, exact class counts, and pairs whose fragment lies in one chunk."""

import numpy as np
import pytest

from conftest import CONFIG, tiny_config, tiny_traffic

from harness.genomes import chunk_bounds, genome_codes
from harness.traffic import CLASSES, make_pool, pool_size, write_fastq

BIG_SEED = 2**31 + 12345  # seeds may pass 32 signed bits


@pytest.mark.parametrize("traffic", ["se", "host90-se", "pe"])
def test_pool_is_a_function_of_the_seed(traffic):
    cfg, tr = tiny_config(CONFIG), tiny_traffic(traffic)
    codes = genome_codes(cfg)
    n = pool_size(tr, 0.125)
    a = make_pool(tr, cfg, codes, BIG_SEED, n)
    b = make_pool(tr, cfg, codes, BIG_SEED, n)
    c = make_pool(tr, cfg, codes, BIG_SEED + 1, n)
    assert np.array_equal(a.seq1, b.seq1) and np.array_equal(a.kind, b.kind)
    assert not np.array_equal(a.seq1, c.seq1)
    assert a.seq1.shape == (n, tr["read_bp"]) and n == 1024
    assert (a.seq2 is not None) == tr["paired"]
    # every seed gets the same amount of each class, in another order
    for i, cls in enumerate(CLASSES):
        want = round(tr["mix"].get(cls, 0.0) * n)
        assert (a.kind == i).sum() == (c.kind == i).sum() == want
    assert not np.array_equal(a.kind, c.kind)
    assert set(np.unique(a.seq1).tobytes()) <= set(b"ACGT")


def test_source_reads_and_pairs_come_from_their_genomes():
    cfg = tiny_config(CONFIG)
    codes = genome_codes(cfg)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = [acgt[g].tobytes() for g in codes]
    se = make_pool(tiny_traffic("se"), cfg, codes, 5, 768)
    for i in np.nonzero(se.kind == 0)[0][:50]:
        assert any(se.seq1[i].tobytes() in g for g in genomes)
    pe = make_pool(tiny_traffic("pe"), cfg, codes, 5, 768)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    bounds = chunk_bounds(cfg)
    for i in np.nonzero(pe.kind == 0)[0][:50]:
        m1 = pe.seq1[i].tobytes()
        m2 = pe.seq2[i].tobytes().translate(comp)[::-1]
        hits = [(g, gs.find(m1)) for g, gs in enumerate(genomes)
                if gs.find(m1) >= 0]
        assert hits
        g, p = hits[0]
        assert genomes[g][p + 200:p + 350] == m2
        assert any(a <= p and p + 350 <= b for a, b in bounds)


def test_chunk_bounds_are_computes():
    """The chunk rule equals the program's split-by-number window."""
    from kmcp_tpu_torch.seqio.fastx import slider, split_chunk_size

    cfg = tiny_config(CONFIG)
    for bp, n in ((4000, 8), (73450, 64), (1000, 10), (5000, 3)):
        cfg.update(genome_bp=bp, chunks_per_genome=n)
        size, step = split_chunk_size(bp, n, 150, circular=False)
        want = [(s, s + len(sub)) for s, sub in slider(b"A" * bp, size, step)
                if not (len(sub) - 1 <= 150 or len(sub) < 21)]
        assert chunk_bounds(cfg) == want


def test_fastq_round_trips_through_the_programs_parser(tmp_path):
    from kmcp_tpu_torch.commands.search import iter_queries

    cfg = tiny_config(CONFIG)
    pool = make_pool(tiny_traffic("pe"), cfg, genome_codes(cfg), 9, 768)
    r1, r2 = write_fastq(pool, str(tmp_path))
    got = list(iter_queries([], r1, r2))
    assert len(got) == pool.size
    for i in (0, 1, pool.size - 1):
        assert got[i] == (pool.query_id(i), pool.seq1[i].tobytes(),
                          pool.seq2[i].tobytes())
    # the warm-up's file: the pool's last queries
    w1, w2 = write_fastq(pool, str(tmp_path), "warm", pool.size - 100)
    assert list(iter_queries([], w1, w2)) == got[-100:]
