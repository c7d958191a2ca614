"""Batches in flight (the JAX streamer's flush/drain pipeline) and the
sync-free fixed-budget step under it, on the CPU, exactly (every value is
an integer):

- the port's compaction (``nonzero_asc``, ``compact_candidates`` on K2''s
  mask words) against ``kmcp_tpu.search.device_step._nonzero_asc`` and
  ``_compact_candidates`` run in JAX, at budgets under, at and over the
  total;
- the dense tail's chunk splice against ``compact_plain`` + ``pack_result``
  over the whole batch, with the candidates crowded into one chunk;
- the screened pair list against ``_nonzero_asc`` over the same active
  mask, and a pair overflow reporting budget + 1 as the JAX tail does;
- the sharded screened tail on a world of one, its last pass-2 chunks
  padding pairs only, against the single-device tail;
- the streamer at ``in_flight`` 1, 2 and 4 with more batches than the
  depth (the 16,384-read floor patched to 256), byte-identical to
  ``kmcp_tpu``'s ``--backend host`` on single-end and paired dense,
  screened single-end and paired, and sketch DBs; candidate-overflow
  retries inside a full pipeline; an out-of-range location raising at
  drain with ``check_rows``'s message."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcp_tpu.search.device import _make_screened_tail
from kmcp_tpu.search.device_step import _compact_candidates, _nonzero_asc
from kmcp_tpu_torch.search import device as device_mod
from kmcp_tpu_torch.search import engine as port_engine
from kmcp_tpu_torch.search import stream as stream_mod
from kmcp_tpu_torch.search.count import count_mask_plain
from kmcp_tpu_torch.parallel.sharding import make_mesh
from kmcp_tpu_torch.search.device_step import (
    compact_candidates,
    compact_plain,
    count_tail,
    host_result,
    nonzero_asc,
    pack_result,
    read_floor,
    target_floor,
)
from kmcp_tpu_torch.search import screen as screen_mod
from kmcp_tpu_torch.search.screen import (
    active_pairs,
    pair_list,
    screened_tail,
    sharded_screened_tail,
)
from kmcp_tpu_torch.search.stream import TorchStreamSearcher

from .test_pallas_pair import B as SB, NB, S_BLOCK, T_BLOCK, _synthetic
from .test_torch_paired import host_paired_tsv, paired_reads
from .test_torch_screen import DEDUP, MIN_LEN, port_inputs
from .test_torch_screen_stream import screened_db, uneven_genomes
from .test_torch_sketch import sketch_db, sketch_reads
from .test_torch_stream import (
    build_db,
    mixed_reads,
    random_genomes,
    stream_tsv,
)

torch.set_num_threads(1)

DEPTHS = (1, 2, 4)


def budgets(total: int) -> tuple:
    """Budgets under, at and over a total."""
    return (max(1, total // 3), total, total + 37)


# ------------------------------------------------------------ compaction

@pytest.mark.parametrize("density", [0.02, 0.3])
def test_nonzero_asc_matches_jax(density):
    rng = np.random.default_rng(1)
    flat = rng.random(5003) < density
    n_all = int(flat.sum())
    for budget in budgets(n_all):
        want_idx, want_n = _nonzero_asc(jnp.asarray(flat), budget, 5003)
        idx, n = nonzero_asc(torch.from_numpy(flat), budget, 5003)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        assert int(n) == int(want_n) == n_all


def pack_words(ok: np.ndarray) -> np.ndarray:
    """ok bool [B, 32 W] -> K2''s mask int32 [B, W] (bit j of word w =
    target 32 w + j)."""
    B, T = ok.shape
    bits = ok.reshape(B, T // 32, 32).astype(np.uint64)
    words = (bits << np.arange(32, dtype=np.uint64)).sum(axis=2)
    return words.astype(np.uint32).view(np.int32)


def test_compact_candidates_matches_jax():
    """Sparse words, full words (bit 31 set: negative int32) and empty
    rows; counts padded with a fill of 7."""
    rng = np.random.default_rng(2)
    B, T = 40, 96
    ok = rng.random((B, T)) < 0.06
    ok[3, 32:64] = True  # a word of all ones
    ok[5, 31] = ok[5, 63] = True  # bit 31 of two words
    ok[8:12] = False
    counts = rng.integers(0, 500, (B, T)).astype(np.int32)
    mask = torch.from_numpy(pack_words(ok))
    n_all = int(ok.sum())
    for budget in budgets(n_all):
        w_idx, w_cnt, w_n = _compact_candidates(
            jnp.asarray(ok), jnp.asarray(counts), budget, 7)
        idx, cnt, n = compact_candidates(mask, torch.from_numpy(counts),
                                         budget, 7)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(w_cnt))
        assert int(n) == int(w_n) == n_all


@pytest.mark.parametrize("crowded", [True, False])
def test_chunk_splice_matches_compact_plain(crowded):
    """The dense tail on 8 read chunks against one compaction of the whole
    batch (``compact_plain`` + ``pack_result``), byte for byte; with
    ``crowded`` every candidate lies in chunk 3 (the other reads are too
    short), so that chunk alone overflows the smaller budgets."""
    rng = np.random.default_rng(4)
    B, S, W, K = 64, 300, 3, 20
    bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint64)
    bits &= rng.integers(0, 2**32, (S + 1, W), dtype=np.uint64)
    bits = bits.astype(np.uint32)
    bits[S] = 0
    loc = rng.integers(0, S + 1, (B, K, 1)).astype(np.int32)
    nk = (loc[:, :, 0] != S).sum(axis=1).astype(np.int32)
    lens = np.full(B, 150, dtype=np.int32)
    if crowded:
        lens[:24] = lens[32:] = MIN_LEN - 1
    cmin = np.maximum(1, np.arange(K + 1) // 3).astype(np.int32)
    thr = target_floor(np.ones(32 * W, np.int32), np.ones(32 * W, bool))
    t = [torch.from_numpy(a) for a in (bits.view(np.int32), loc, nk, lens,
                                       cmin, thr)]
    cthr = read_floor(t[2], t[3], t[4], MIN_LEN, DEDUP)
    counts, mask = count_mask_plain(t[0], t[1], cthr, t[5])
    ids, cnt = compact_plain(mask, counts)
    n_all = ids.numel()
    assert n_all > 40 and (not crowded or (ids // (32 * W) >= 24).all())
    for budget in budgets(n_all):
        meta, aux = pack_result(ids, cnt, t[2], budget, B * 32 * W)
        want = meta.numpy(), aux.numpy().astype(np.uint16)
        got = count_tail(*t, budget, MIN_LEN, DEDUP, chunk_reads=8)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert int(got[0][0]) == n_all


def test_pair_list_matches_jax():
    rng = np.random.default_rng(6)
    B, nb = 50, 7
    active = rng.random((B, nb)) < 0.3
    n_all = int(active.sum())
    for budget in budgets(n_all):
        w_idx, w_n = _nonzero_asc(jnp.asarray(active.reshape(-1)), budget,
                                  B * nb)
        w_idx = np.asarray(w_idx)
        pb, pg, n = pair_list(torch.from_numpy(active), budget)
        pb, pg = pb.numpy(), pg.numpy()
        real = w_idx < B * nb
        assert int(n) == int(w_n) == n_all
        np.testing.assert_array_equal((pb * nb + pg)[real], w_idx[real])
        assert (pg[~real] == nb).all() and (pb[~real] == B - 1).all()


@pytest.mark.parametrize("pass2", ["pair", "gemm"])
def test_pair_overflow_reports_budget_plus_one(pass2):
    """Seed 3's screened tail with 8 pair slots reports budget + 1, as
    ``_make_screened_tail`` with a pair budget of 8 does; with a slot for
    every (read, block) pair it equals that tail byte for byte, and so does
    the default pair budget."""
    x = port_inputs(3)
    args = (x["bits_ext"], x["u_ext"], x["loc"], x["loc_u"], x["nk"],
            x["lens"], x["cmin"], x["theta"], x["thr"])
    budget = 8192  # over the 7,343 candidates

    def port(pair_budget):
        return screened_tail(*args, budget, MIN_LEN, DEDUP, pass2,
                             x["bits01"], pair_budget=pair_budget)

    def jax(pair_budget):
        bits, jargs = _synthetic(3)
        out = _make_screened_tail(budget, pair_budget, MIN_LEN, DEDUP, NB,
                                  T_BLOCK, S_BLOCK, 1)(jnp.asarray(bits),
                                                       *jargs)
        return [np.asarray(a) for a in out]

    assert int(jax(8)[0][0]) == int(port(8)[0][0]) == budget + 1
    want = jax(SB * NB)
    assert 0 < int(want[0][0]) <= budget
    for got in (port(SB * NB), port(None)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_mesh_screened_tail_with_padding_chunks(tmp_path, monkeypatch):
    """The sharded screened tail on a world of one (gloo, in process) pads
    its pair list to B nb slots; with half the reads too short and pass 2
    cut into chunks of 8 pairs, its last chunks hold padding pairs only
    (block nb, past every target id).  Byte-identical to the single-device tail on both routes."""
    import torch.distributed as dist

    x = port_inputs(3)
    B = x["loc"].shape[0]
    lens = x["lens"].clone()
    lens[B // 2 :] = MIN_LEN - 1  # too short: no pair
    args = (x["bits_ext"], x["u_ext"], x["loc"], x["loc_u"], x["nk"], lens,
            x["cmin"], x["theta"], x["thr"])
    pb, _pg = active_pairs(x["u_ext"], x["loc_u"], x["nk"], lens,
                           x["theta"], NB, MIN_LEN, DEDUP)
    assert 0 < pb.numel() < B * NB - 8
    want = screened_tail(*args, 8192, MIN_LEN, DEDUP, "pair")
    assert 0 < int(want[0][0]) <= 8192
    monkeypatch.setattr(screen_mod, "pass2_chunk", lambda T_b: 8)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        for pass2, bits01 in (("pair", None), ("gemm", x["bits01"])):
            got = host_result(sharded_screened_tail(
                *args, 8192, MIN_LEN, DEDUP, mesh, B, pass2, bits01))
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------------- streams

@pytest.fixture
def small_batches(monkeypatch):
    """Batches of 256 reads, so a few hundred reads fill several."""
    monkeypatch.setattr(stream_mod, "MIN_BATCH", 256)


def port_tsv(db, reads, depth, paired=False, pass2="auto", **opt_kw):
    opt = port_engine.SearchOptions(batch_size=256, paired_fpr_buf=paired,
                                    **opt_kw)
    st = TorchStreamSearcher(port_engine.SearchEngine([db], opt), "cpu",
                             pass2, in_flight=depth)
    buf = io.StringIO()
    progress = []
    total, _ = st.run(iter(reads), buf, paired=paired,
                      progress=progress.append)
    assert total == len(reads) == progress[-1]
    assert progress == sorted(progress) and len(progress) >= 5
    return buf.getvalue(), st


def check_depths(db, reads, want, paired=False, **kw):
    for depth in DEPTHS:
        got, st = port_tsv(db, reads, depth, paired, **kw)
        assert got == want, depth
    return st


@pytest.mark.parametrize("paired", [False, True])
def test_dense_stream_depths_match_host(tmp_path, small_batches, paired):
    rng = np.random.default_rng(21)
    genomes = random_genomes(rng, 4, 30000)
    db = build_db(tmp_path, genomes)
    if paired:
        reads = paired_reads(rng, genomes, 1100)
        want = host_paired_tsv(db, reads)
    else:
        reads = mixed_reads(rng, genomes, 1100)
        want = stream_tsv(db, reads, "host")[0]
    st = check_depths(db, reads, want, paired)
    assert st.dev.n_blocks == 1 and want.count("\n") > 900


@pytest.mark.parametrize("paired,pass2", [(False, "pair"), (True, "gemm")])
def test_screened_stream_depths_match_host(tmp_path, small_batches, paired,
                                           pass2):
    rng = np.random.default_rng(22)
    genomes = uneven_genomes(rng, [30000, 42000, 36000, 30000])
    db = screened_db(tmp_path, genomes, 4)
    if paired:
        reads = paired_reads(rng, genomes, 1100)
        want = host_paired_tsv(db, reads)
    else:
        reads = mixed_reads(rng, genomes, 1100)
        want = stream_tsv(db, reads, "host")[0]
    st = check_depths(db, reads, want, paired, pass2=pass2)
    assert st.dev.n_blocks > 1 and st.dev.pass2 == pass2
    assert int(st.dev.tail_stats["pairs"]) > 500
    assert want.count("\n") > 900


def test_sketch_stream_depths_match_host(tmp_path, small_batches):
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher

    db, genomes, rng = sketch_db(tmp_path, "minimizer")
    reads = [(f"r{i}", r, None)
             for i, r in enumerate(sketch_reads(rng, genomes, 1100))]
    eng = SearchEngine([db], SearchOptions(backend="host",
                                           kmer_dedup_threshold=64))
    assert StreamSearcher.usable(eng)
    buf = io.StringIO()
    StreamSearcher(eng).run(iter(reads), buf)
    st = check_depths(db, reads, buf.getvalue(), kmer_dedup_threshold=64)
    assert st.dev.sketch == ("minimizer", 5) and st.slow_rows > 0


def test_overflow_retries_in_a_full_pipeline(tmp_path, small_batches,
                                            monkeypatch):
    """Eight near-identical genomes and a starting budget of 64 slots for
    256 reads: every batch overflows and re-runs with 4x the budget while
    the later batches are in flight; the bytes are --backend host's."""
    monkeypatch.setattr(stream_mod, "SLOTS_PER_READ", 0.25)
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
    reads = []
    for i in range(1100):
        p = int(rng.integers(0, len(base_seq) - 150))
        reads.append((f"r{i}", bytes(base_seq[p : p + 150]), None))
    want = stream_tsv(db, reads, "host")[0]
    for depth in (1, 4):
        got, st = port_tsv(db, reads, depth)
        assert got == want and st.retries >= 5


def test_row_range_raises_at_drain(tmp_path, small_batches, monkeypatch):
    """A location outside the DB's rows dispatches, and raises when the
    batch is drained, with check_rows's message; the streamer raises it
    from run."""
    rng = np.random.default_rng(23)
    genomes = random_genomes(rng, 3, 20000)
    db = build_db(tmp_path, genomes)
    reads = mixed_reads(rng, genomes, 300)
    opt = port_engine.SearchOptions(batch_size=256)
    st = TorchStreamSearcher(port_engine.SearchEngine([db], opt), "cpu")
    rows = st.dev.total_rows
    hash_loc = device_mod.hash_loc

    def bad_rows(*a, **kw):
        outs = hash_loc(*a, **kw)
        loc = outs[0].clone()
        loc[0, 0, 0] = rows + 5
        return (loc,) + outs[1:]

    monkeypatch.setattr(device_mod, "hash_loc", bad_rows)
    lens = np.full(256, 150)
    mat = np.full((256, 160), ord("A"), dtype=np.uint8)
    handle = st.dev.search_reads_async(torch.from_numpy(mat), lens, 512)
    msg = rf"loc holds rows \d+\.\.{rows + 5} outside 0\.\.{rows}"
    with pytest.raises(ValueError, match=msg):
        handle.result()
    with pytest.raises(ValueError, match="outside"):
        st.run(iter(reads), io.StringIO())
