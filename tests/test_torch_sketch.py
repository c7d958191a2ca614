"""Device sketch selection (ROADMAP A7) on the CPU: each function of
kmcp_tpu_torch/search/sketch_device.py equals its kmcp_tpu twin on random
value planes (values past 2^63, invalid zeros, ties, rows shorter than a
window), and a minimizer or closed-syncmer DB streams through the port
(K1' plain version with values, selection, the dense tail) to a TSV
byte-identical to ``kmcp_tpu search --backend host``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcp_tpu.commands.compute import ComputeOptions, run_compute
from kmcp_tpu.commands.search import run_search as run_search_host
from kmcp_tpu.index.build import run_index
from kmcp_tpu.search import sketch_device as jsk
from kmcp_tpu.search.engine import SearchOptions
from kmcp_tpu_torch.commands.search import run_search
from kmcp_tpu_torch.search import engine as port_engine
from kmcp_tpu_torch.search import sketch_device as tsk

torch.set_num_threads(1)

U64 = (1 << 64) - 1


def value_plane(rng, B: int, K: int) -> np.ndarray:
    """uint64 [B, K]: half the values past 2^63, one in eight invalid (0),
    and rows drawn from a pool of 5 values, so that minima tie."""
    v = rng.integers(1, 2**64, size=(B, K), dtype=np.uint64)
    v[rng.random((B, K)) < 0.125] = 0
    pool = rng.integers(1, 2**64, size=5, dtype=np.uint64)
    v[::3] = rng.choice(pool, size=(len(v[::3]), K))
    v[1] = pool[0]  # one row of a single repeated value
    return v


def read_lens(rng, B: int, k: int, K: int) -> np.ndarray:
    """Lengths giving 0, 1, a few and all K windows."""
    lens = rng.integers(k - 1, k - 1 + K + 1, size=B)
    lens[:4] = [0, k - 1, k, k + 2]
    lens[4] = k - 1 + K
    return lens.astype(np.int32)


def to_torch(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(v.view(np.int64).copy())


def to_jax(v: np.ndarray):
    """uint64 [B, K] -> the JAX package's (hi, lo) uint32 [K, B] planes."""
    return (jnp.asarray((v >> np.uint64(32)).astype(np.uint32).T),
            jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32).T))


def from_jax(hi, lo) -> np.ndarray:
    """(hi, lo) [K, B] -> uint64 [B, K]."""
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64)).T


@pytest.mark.parametrize("w", [1, 2, 5, 8, 40])
def test_window_lexmin_matches_jax(w):
    rng = np.random.default_rng(w)
    v = value_plane(rng, 24, 40)
    mk, mp = tsk._window_lexmin(tsk._mask_invalid(to_torch(v))[0], w)
    hi, lo = to_jax(v)
    jh, jl, _inv = jsk._mask_invalid(hi, lo)
    mh, ml, jp = jsk._window_lexmin(jh, jl, w)
    want = from_jax(mh, ml)
    got = mk.numpy().view(np.uint64) ^ np.uint64(1 << 63)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mp.numpy(), np.asarray(jp).T)


@pytest.mark.parametrize("k,w", [(21, 5), (21, 1), (15, 11), (31, 36)])
def test_minimizer_selected_matches_jax(k, w):
    rng = np.random.default_rng(k * 100 + w)
    B, K = 32, 36
    v = value_plane(rng, B, K)
    lens = read_lens(rng, B, k, K)
    got = tsk.minimizer_selected(to_torch(v), torch.from_numpy(lens), k, w)
    want = jsk.minimizer_selected(*to_jax(v), jnp.asarray(lens), k, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)
    assert got.any()


def test_minimizer_window_past_row_end():
    """w > K (a batch of short reads under a wide -W): kmcp_tpu's
    minimizer_selected raises there (its shifts outgrow the plane); the
    port selects as the JAX function does on the plane padded with invalid
    windows to w."""
    rng = np.random.default_rng(40)
    k, w, B, K = 21, 40, 32, 36
    v = value_plane(rng, B, K)
    lens = read_lens(rng, B, k, K)
    got = tsk.minimizer_selected(to_torch(v), torch.from_numpy(lens), k, w)
    padded = np.concatenate([v, np.zeros((B, w - K), np.uint64)], axis=1)
    want = jsk.minimizer_selected(*to_jax(padded), jnp.asarray(lens), k, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T[:, :K])
    assert got.any()


@pytest.mark.parametrize("k,s", [(21, 11), (21, 20), (15, 5), (21, 1)])
def test_syncmer_selected_matches_jax(k, s):
    rng = np.random.default_rng(k * 100 + s)
    B, lmax = 32, 64
    K, K_s = lmax - k + 1, lmax - s + 1
    v = value_plane(rng, B, K)
    sv = value_plane(rng, B, K_s)
    lens = read_lens(rng, B, k, K)
    got = tsk.syncmer_selected(to_torch(v), to_torch(sv),
                               torch.from_numpy(lens), k, s)
    want = jsk.syncmer_selected(*to_jax(v), *to_jax(sv), jnp.asarray(lens),
                                k, s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)
    assert got.any()


@pytest.mark.parametrize("kind,param,max_hash,h", [
    ("minimizer", 5, U64, 1), ("minimizer", 10, U64 // 3, 3),
    ("syncmer", 11, U64, 1), ("syncmer", 7, (U64 // 4) * 3, 2),
])
def test_sketch_transform_matches_jax(kind, param, max_hash, h):
    """sketch_transform (and apply_selection in it) against
    make_sketch_transform: locations, nk and the zeroed values."""
    rng = np.random.default_rng(param + h)
    k, B, lmax, S = 21, 32, 64, 977
    K = lmax - k + 1
    v = value_plane(rng, B, K)
    sv = value_plane(rng, B, lmax - param + 1) if kind == "syncmer" else None
    lens = read_lens(rng, B, k, K)
    loc = rng.integers(0, S, size=(B, K, h)).astype(np.int32)
    got_loc, got_nk, got_v = tsk.sketch_transform(
        kind, k, param, S, max_hash, torch.from_numpy(loc), to_torch(v),
        None if sv is None else to_torch(sv), torch.from_numpy(lens))
    fn = jsk.make_sketch_transform(kind, k, param, S, max_hash)
    hi, lo = to_jax(v)
    want_loc, want_nk, wh, wl = fn(
        tuple(jnp.asarray(loc[:, :, j].T) for j in range(h)), hi, lo,
        to_jax(sv) if sv is not None else (), jnp.asarray(lens))
    np.testing.assert_array_equal(
        got_loc.numpy(), np.stack([np.asarray(p).T for p in want_loc], 2))
    np.testing.assert_array_equal(got_nk.numpy(), np.asarray(want_nk)[0])
    np.testing.assert_array_equal(got_v.numpy().view(np.uint64),
                                  from_jax(wh, wl))
    assert 0 < int(got_nk.sum()) < int((v != 0).sum())


def sketch_db(tmp_path, sketch: str):
    """test_index_search.py:2287's DB: 3 genomes of 30 kb, 2 chunks each,
    k = 21, minimizer w = 5 or closed syncmer s = 11, one hash, FPR 0.3,
    --tpu-native."""
    rng = np.random.default_rng(31)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes, files = [], []
    for g in range(3):
        seq = rng.choice(bases, size=30000).tobytes()
        p = tmp_path / f"g{g}.fa"
        p.write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
        files.append(str(p))
    skw = dict(minimizer_w=5) if sketch == "minimizer" else dict(syncmer_s=11)
    run_compute(out_dir=str(tmp_path / "ks"), files=files,
                opt=ComputeOptions(ks=[21], split_number=2,
                                   split_overlap=100, **skw),
                force=True, verbose=False)
    run_index(in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
              num_hashes=1, fpr=0.3, force=True, tpu_native=True,
              verbose=False)
    return str(tmp_path / "db"), genomes, rng


def sketch_reads(rng, genomes, n: int = 256) -> list[bytes]:
    """test_index_search.py:2287's reads: 150 bp genome reads (some with an
    N), junk, too short, under one minimizer window; and a few 500 bp
    reads, whose sketches pass a k-mer dedup threshold of 64 (slow
    rows)."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    for i in range(n):
        g = genomes[int(rng.integers(0, 3))]
        if i % 6 == 5:
            reads.append(rng.choice(bases, size=150).tobytes())
        elif i % 17 == 16:
            reads.append(b"ACGTACGT")
        elif i % 11 == 10:
            p = int(rng.integers(0, len(g) - 24))
            reads.append(g[p : p + 24])
        else:
            ln = 500 if i % 50 == 7 else 150
            p = int(rng.integers(0, len(g) - ln))
            r = bytearray(g[p : p + ln])
            if i % 13 == 12:
                r[70] = ord("N")
            reads.append(bytes(r))
    return reads


@pytest.mark.parametrize("sketch", ["minimizer", "syncmer"])
def test_sketch_stream_matches_host(tmp_path, sketch):
    """The mirror of test_device_sketch_selection_matches_host: the port
    streams the sketch DB (route "stream", the long reads as slow rows
    through the object engine) to kmcp_tpu's --backend host TSV."""
    db, genomes, rng = sketch_db(tmp_path, sketch)
    reads = sketch_reads(rng, genomes)
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
    stats: dict = {}
    run_search(db, [str(fq)], out_file=str(tmp_path / "port.tsv"),
               device="cpu", verbose=False, stats=stats,
               opt=port_engine.SearchOptions(kmer_dedup_threshold=64))
    run_search_host(db, [str(fq)], out_file=str(tmp_path / "host.tsv"),
                    opt=SearchOptions(backend="host", kmer_dedup_threshold=64),
                    verbose=False)
    got = (tmp_path / "port.tsv").read_bytes()
    assert got == (tmp_path / "host.tsv").read_bytes()
    assert stats["route"] == "stream"
    assert stats["slow_rows"] == sum(len(r) == 500 for r in reads) > 0
    assert got.count(b"\n") > 150


@pytest.mark.parametrize("sketch", ["minimizer", "syncmer"])
def test_sketch_db_needs_k1_hash(tmp_path, monkeypatch, sketch):
    """Window selection rides K1''s value planes: with
    ``KMCP_TPU_DEVICE_HASH`` anything but "1" ("scan" or host hashing "0")
    the streamer declines a sketch DB, as kmcp_tpu's does
    (stream.py:221), and the object engine's TSV is kmcp_tpu's."""
    from kmcp_tpu_torch.search.stream import usable

    db, genomes, rng = sketch_db(tmp_path, sketch)
    reads = sketch_reads(rng, genomes, 96)
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
    opt = port_engine.SearchOptions()
    assert usable(port_engine.SearchEngine([db], opt))
    for value in ("scan", "0"):
        monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", value)
        assert not usable(port_engine.SearchEngine([db], opt))
    stats: dict = {}
    run_search(db, [str(fq)], out_file=str(tmp_path / "port.tsv"),
               device="cpu", verbose=False, stats=stats, opt=opt)
    run_search_host(db, [str(fq)], out_file=str(tmp_path / "jax.tsv"),
                    opt=SearchOptions(backend="numpy"), verbose=False)
    assert stats["route"] == "engine"
    got = (tmp_path / "port.tsv").read_bytes()
    assert got == (tmp_path / "jax.tsv").read_bytes()
    assert got.count(b"\n") > 40
