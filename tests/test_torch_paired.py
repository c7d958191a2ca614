"""Paired streaming in the port (ROADMAP A6) against the JAX package and
``--backend host``, on the CPU:

- the in-step k-mer dedup (kmcp_tpu_torch/search/dedup.py) against
  ``_dedup_value_planes`` on value pools dense in duplicates, per-plane
  sentinels, as per-read multisets of locations (window order within a read
  is free) and unique counts, its traced tally of rows uniqued and windows
  dropped against a numpy count, and window by window against a numpy
  loop that keeps each value's first window;
- the dense tail ``count_tail(in_dedup=True)`` against ``_make_count_tail``
  with value planes (1 and 3 hashes); the screened tail's counterpart is in
  test_torch_screen.py, beside the interpret-mode pair kernel it shares;
- the port's paired stream (``run(paired=True)``, the kernels' plain
  versions) byte-identical to kmcp_tpu's ``--backend host`` paired
  ``StreamSearcher`` on one-block DBs (1 and 3 hashes) and screened
  multi-block DBs (W_b = 1 and 2, both pass-2 kernels), and to its numpy
  object engine where that engine, which screens no block, finds the same
  (one block, and the W_b = 1 screened DB): junk, short, empty, fully
  duplicate and overlapping mates, rows under the dedup threshold that keep
  their duplicate windows, and a batch that overflows its candidate budget
  and re-runs;
- ``run_search(read1=, read2=)`` on FASTQ files.
Every value is an integer: compared exactly."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcp_tpu.commands.search import run_search as run_search_host
from kmcp_tpu.search.device import _make_count_tail
from kmcp_tpu.search.device_step import _dedup_value_planes
from kmcp_tpu.search.engine import SearchEngine, SearchOptions
from kmcp_tpu.search.stream import StreamSearcher
from kmcp_tpu.search.tsv import write_results
from kmcp_tpu_torch.commands.search import run_search
from kmcp_tpu_torch.search import engine as port_engine
from kmcp_tpu_torch.search.dedup import dedup_planes, take_tally
from kmcp_tpu_torch.search.device_step import count_tail, target_floor
from kmcp_tpu_torch.search.stream import TorchStreamSearcher
from kmcp_tpu_torch.utils import trace

from .test_torch_screen_stream import screened_db, uneven_genomes
from .test_torch_stream import build_db, random_genomes

torch.set_num_threads(1)


def value_pool(rng, K, B, n_pool, planes, thr):
    """[K, B] value halves drawn from a pool of n_pool values (duplicates
    common), location planes that follow the value (each plane's modulus,
    sentinel = modulus), 15% invalid windows, and half the reads cut to
    thr - 2 windows (at or under the threshold, duplicates kept).  Returns
    (vhi, vlo, [plane [K, B] int32], nk [B])."""
    pool_hi = rng.integers(1, 2**32, n_pool, dtype=np.uint64)
    pool_lo = rng.integers(0, 2**32, n_pool, dtype=np.uint64)
    pick = rng.integers(0, n_pool, (K, B))
    vhi = pool_hi[pick].astype(np.uint32)
    vlo = pool_lo[pick].astype(np.uint32)
    invalid = rng.random((K, B)) < 0.15
    invalid |= (np.arange(K)[:, None] >= thr - 2) & (np.arange(B) % 2 == 0)
    vhi[invalid], vlo[invalid] = 0, 0
    locs = []
    for j, m in enumerate(planes):
        loc = ((pool_lo[pick] + j * pool_hi[pick]) % np.uint64(m)).astype(
            np.int32)
        loc[invalid] = m
        locs.append(loc)
    nk = (~invalid).sum(axis=0).astype(np.int32)
    return vhi, vlo, locs, nk


def joined_values(vhi, vlo) -> torch.Tensor:
    """[K, B] uint32 halves -> the port's int64 [B, K] value plane."""
    v = (vhi.astype(np.uint64) << np.uint64(32)) | vlo.astype(np.uint64)
    return torch.from_numpy(np.ascontiguousarray(v.T).view(np.int64))


def numpy_dedup_counts(vhi, vlo, nk, thr) -> tuple[int, int]:
    """(reads over thr, their windows that repeat an earlier non-zero
    value) of value_pool's data, counted in numpy."""
    v = ((vhi.astype(np.uint64) << np.uint64(32)) | vlo.astype(np.uint64)).T
    over = v[nk > thr]
    dropped = sum(int((r != 0).sum()) - len(np.unique(r[r != 0]))
                  for r in over)
    return len(over), dropped


def test_dedup_matches_jax():
    """Two [B, K] planes with their own sentinels and one [B, K, 3] plane:
    per read, the multiset of locations and the unique count equal
    _dedup_value_planes'; the tally, traced, equals a numpy count."""
    rng = np.random.default_rng(5)
    K, B, thr = 40, 96, 12
    mods = (251, 4099, 97, 98, 99)
    vhi, vlo, locs, nk = value_pool(rng, K, B, 9, mods, thr)
    want, want_nk = _dedup_value_planes(
        jnp.asarray(vhi), jnp.asarray(vlo), [jnp.asarray(p) for p in locs],
        jnp.asarray(nk), thr, list(mods))
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))  # noqa: E731
    planes = [as_t(locs[0]), as_t(locs[1]),
              torch.from_numpy(np.ascontiguousarray(
                  np.stack(locs[2:], axis=-1).transpose(1, 0, 2)))]
    trace.enable()
    try:
        got, got_nk = dedup_planes(joined_values(vhi, vlo), planes,
                                   torch.from_numpy(nk), thr,
                                   [mods[0], mods[1], torch.tensor(mods[2:])])
        tally = take_tally()
    finally:
        trace.disable()
        trace.reset()
    assert tally == numpy_dedup_counts(vhi, vlo, nk, thr)
    assert tally[1] == int((nk - got_nk.numpy()).sum()) > 0
    np.testing.assert_array_equal(got_nk.numpy(), np.asarray(want_nk))
    assert (got_nk.numpy() < nk).sum() > B // 4  # the dedup bit
    assert (nk[::2] <= thr).all()  # and half the reads kept duplicates
    mine = [got[0].numpy(), got[1].numpy()] + [
        got[2].numpy()[..., j] for j in range(3)]
    for p, (g, w) in enumerate(zip(mine, want)):
        w = np.asarray(w).T
        assert g.dtype == np.int32
        for b in range(B):
            assert sorted(g[b].tolist()) == sorted(w[b].tolist()), (p, b)


@pytest.mark.parametrize("h,n_pool", [(1, 9), (3, 9), (1, 1000)])
def test_dedup_keeps_each_first_window(h, n_pool):
    """Window by window, against a numpy loop: in a read over the
    threshold each value's first window keeps its locations and every
    later copy takes the sentinel (per column); other reads come back
    unchanged; nk drops by the copies.  Untraced, nothing is tallied."""
    rng = np.random.default_rng(3 + h + n_pool)
    K, B, thr = 50, 64, 20
    mods = [101 + j for j in range(h)]
    vhi, vlo, locs, nk = value_pool(rng, K, B, n_pool, mods, thr)
    loc = np.ascontiguousarray(np.stack(locs, axis=-1).transpose(1, 0, 2))
    v = ((vhi.astype(np.uint64) << np.uint64(32)) | vlo.astype(np.uint64)).T
    want, want_nk = loc.copy(), nk.copy()
    for b in np.nonzero(nk > thr)[0]:
        seen = set()
        for i, x in enumerate(v[b].tolist()):
            if x and x in seen:
                want[b, i] = mods
                want_nk[b] -= 1
            seen.add(x)
    (got,), got_nk = dedup_planes(joined_values(vhi, vlo),
                                  [torch.from_numpy(loc)],
                                  torch.from_numpy(nk), thr,
                                  [torch.tensor(mods)])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_nk.numpy(), want_nk)
    assert (want_nk < nk).sum() > (B // 8 if n_pool < K else 0)
    assert take_tally() == (0, 0)


@pytest.mark.parametrize("h", [1, 3])
def test_count_tail_in_dedup_matches_jax(h):
    """test_count_tail_in_dedup_matches_manual's recipe: the port's dense
    tail with in_dedup equals _make_count_tail(in_dedup=True) with value
    planes: the same candidates, counts and unique k-mer counts."""
    rng = np.random.default_rng(41 + h)
    S, W, K, B, thr = 251, 4, 24, 64, 12
    T = W * 32
    bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
    bits[S] = 0
    vhi, vlo, locs, nk = value_pool(rng, K, B, 10, [S] * h, thr)
    lens = np.full(B, 150, dtype=np.int32)
    lens[::9] = 20  # under min_len
    cmin = np.full(K + 1, 1, dtype=np.int32)
    cmin[8:] = 3
    tmin = np.zeros(T, dtype=np.int32)
    spos = np.ones(T, dtype=bool)
    spos[-3:] = False
    budget = B * T
    meta_j, aux_j = _make_count_tail(budget, 30, thr, 1, None, True)(
        jnp.asarray(bits), tuple(jnp.asarray(p) for p in locs),
        jnp.asarray(nk[None]), jnp.asarray(lens), jnp.asarray(cmin),
        jnp.asarray(tmin), jnp.asarray(spos),
        (jnp.asarray(vhi), jnp.asarray(vlo)))
    meta_j, aux_j = np.asarray(meta_j), np.asarray(aux_j)
    loc = np.ascontiguousarray(np.stack(locs, axis=-1).transpose(1, 0, 2))
    meta, aux = count_tail(
        torch.from_numpy(bits.view(np.int32)), torch.from_numpy(loc),
        torch.from_numpy(nk), torch.from_numpy(lens), torch.from_numpy(cmin),
        torch.from_numpy(target_floor(tmin, spos)), budget, 30, thr,
        in_dedup=True, values=joined_values(vhi, vlo))
    n = int(meta_j[0])
    assert int(meta[0]) == n and 0 < n <= budget
    o_j = np.argsort(meta_j[1 : 1 + n])
    np.testing.assert_array_equal(meta[1 : 1 + n], meta_j[1 : 1 + n][o_j])
    np.testing.assert_array_equal(aux[:n], aux_j[:n][o_j])
    np.testing.assert_array_equal(aux[budget:], aux_j[budget:])
    # reads over the threshold were uniqued, not excluded
    assert (aux[budget:][1::2] < nk[1::2]).any()
    over = np.nonzero(nk > thr)[0]
    assert np.isin(meta[1 : 1 + n] // T, over).any()


# ----------------------------------------------------------- streams


def paired_reads(rng, genomes, n, dup_short=False):
    """test_stream_paired_parity's and test_screened_paired_dedup_matches_
    host's mix: mate 2 the reverse complement 200 bp downstream; junk,
    short (< min_query_len), empty, fully duplicate and overlapping mates;
    with ``dup_short`` also 40 + 40 bp rows with every window twice."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    out = []
    for i in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        p = int(rng.integers(0, len(g) - 500))
        r1 = g[p : p + 150]
        r2 = g[p + 200 : p + 350].translate(rc)[::-1]
        if i % 23 == 0:  # junk mate
            r2 = rng.choice(bases, size=150).tobytes()
        elif i % 31 == 0:  # short mate
            r2 = r2[:25]
        elif i % 41 == 0:  # empty mate
            r2 = b""
        elif i % 7 == 6:  # fully duplicate mates
            r2 = r1
        elif i % 11 == 10:  # overlapping mates
            r2 = g[p + 50 : p + 200]
        elif dup_short and i % 13 == 12:  # under the threshold, duplicated
            r1 = g[p : p + 40] + g[p : p + 40]
            r2 = b""
        elif i % 29 == 28:  # a short pair
            r1, r2 = r1[:22], r2[:20]
        out.append((f"p{i}", r1, r2))
    return out


def port_paired_tsv(db, pairs, pass2="auto", **opt_kw):
    opt = port_engine.SearchOptions(batch_size=128, paired_fpr_buf=True,
                                    **opt_kw)
    st = TorchStreamSearcher(port_engine.SearchEngine([db], opt), "cpu",
                             pass2)
    buf = io.StringIO()
    total, _ = st.run(iter(pairs), buf, paired=True)
    assert total == len(pairs)
    return buf.getvalue(), st


def host_paired_tsv(db, pairs, **opt_kw):
    opt = SearchOptions(backend="host", batch_size=128, paired_fpr_buf=True,
                        **opt_kw)
    eng = SearchEngine([db], opt)
    assert StreamSearcher.usable(eng, paired=True)
    buf = io.StringIO()
    total, _ = StreamSearcher(eng).run(iter(pairs), buf, paired=True)
    assert total == len(pairs)
    return buf.getvalue()


def numpy_paired_tsv(db, pairs, **opt_kw):
    opt = SearchOptions(backend="numpy", paired_fpr_buf=True, **opt_kw)
    buf = io.StringIO()
    write_results(buf, SearchEngine([db], opt).search_batch(pairs, 0), False)
    return buf.getvalue()


@pytest.mark.parametrize("num_hashes,thr", [(1, 256), (3, 70)])
def test_paired_stream_matches_host_and_numpy(tmp_path, num_hashes, thr):
    """One-block DBs: joined rows over the threshold (150 + 150 bp: 280
    windows against 256; every pair against 70) are uniqued on the card's
    path, the 40 + 40 bp rows under 70 keep their duplicates."""
    rng = np.random.default_rng(3 + num_hashes)
    genomes = random_genomes(rng, 4, 30000)
    db = build_db(tmp_path, genomes, num_hashes=num_hashes)
    pairs = paired_reads(rng, genomes, 300, dup_short=thr < 256)
    got, st = port_paired_tsv(db, pairs, kmer_dedup_threshold=thr)
    assert st.slow_rows == 0 and st.dev.n_blocks == 1
    assert got == host_paired_tsv(db, pairs, kmer_dedup_threshold=thr)
    assert got == numpy_paired_tsv(db, pairs, kmer_dedup_threshold=thr)
    assert got.count("\n") > 250


@pytest.mark.parametrize("block_targets,n_words", [(4, 1), (64, 2)])
def test_paired_screened_stream_matches_host(tmp_path, block_targets,
                                              n_words):
    """Screened multi-block DBs (W_b = 1 and 2): both pass-2 kernels equal
    --backend host, dedup threshold 70.  The numpy object engine agrees on
    the W_b = 1 DB; it screens no block, and on the W_b = 2 DB it reports
    two weak matches (35 and 34 of 60 k-mers) of one 40 + 40 bp row in
    blocks that the host backend's union screen drops, so --backend host,
    the streaming contract, is the yardstick there."""
    rng = np.random.default_rng(77)
    if block_targets == 4:
        genomes = uneven_genomes(rng, [30000, 42000, 36000, 30000])
        db = screened_db(tmp_path, genomes, 4)
    else:
        genomes = uneven_genomes(rng, [20000] * 16)
        db = screened_db(tmp_path, genomes, 64, split_number=10)
    pairs = paired_reads(rng, genomes, 256, dup_short=True)
    want = host_paired_tsv(db, pairs, kmer_dedup_threshold=70)
    if n_words == 1:
        assert want == numpy_paired_tsv(db, pairs, kmer_dedup_threshold=70)
    for pass2 in ("pair", "gemm"):
        got, st = port_paired_tsv(db, pairs, pass2, kmer_dedup_threshold=70)
        assert st.dev.n_blocks > 1 and st.dev.w == n_words
        assert st.dev.pass2 == pass2 and st.slow_rows == 0
        assert got == want, pass2
    assert want.count("\n") > 200


def test_paired_stream_budget_overflow_retry(tmp_path):
    """Eight near-identical genomes: every pair matches 8+ targets, past
    the 2-slots-per-row budget of a 16,384-row batch, so the batch re-runs
    with 4x the budget."""
    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base_seq = bytearray(rng.choice(bases, size=12000).tobytes())
    genomes = []
    for _ in range(8):
        seq = bytearray(base_seq)
        for pos in rng.integers(0, len(seq), size=5):
            seq[pos] = bases[int(rng.integers(0, 4))]
        genomes.append(bytes(seq))
    db = build_db(tmp_path, genomes, split_number=2)
    pairs = paired_reads(rng, [bytes(base_seq)], 4500)
    got, st = port_paired_tsv(db, pairs)
    assert st.retries >= 1
    assert got == host_paired_tsv(db, pairs)
    assert got.count("\n") > 2 * 16384  # more rows than the first budget


def test_run_search_paired_files_match_host(tmp_path):
    """The command entry point with -1/-2 FASTQ files (on a screened DB)
    equals kmcp_tpu's run_search with --backend host."""
    rng = np.random.default_rng(8)
    genomes = uneven_genomes(rng, [30000, 30000, 30000])
    db = screened_db(tmp_path, genomes, 4)
    pairs = paired_reads(rng, genomes, 120)
    r1, r2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for pid, s1, s2 in pairs:
            f1.write(f"@{pid}/1\n{s1.decode()}\n+\n{'I' * len(s1)}\n")
            f2.write(f"@{pid}/2\n{s2.decode()}\n+\n{'I' * len(s2)}\n")
    stats = {}
    run_search(db, read1=str(r1), read2=str(r2), out_file=str(tmp_path / "t.tsv"),
               device="cpu", verbose=False, stats=stats)
    run_search_host(db, read1=str(r1), read2=str(r2),
                    out_file=str(tmp_path / "h.tsv"),
                    opt=SearchOptions(backend="host"), verbose=False)
    got = (tmp_path / "t.tsv").read_bytes()
    assert got == (tmp_path / "h.tsv").read_bytes()
    assert stats["slow_rows"] == 0 and stats["n_blocks"] == 3
    assert got.count(b"\n") > 100
