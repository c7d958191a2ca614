"""Slice 2 end to end on the CPU: the port's streaming search over
multi-block ``--block-screen --uniform-sigs`` DBs (the two-pass screened
tail, both pass-2 kernels' plain versions) must write a TSV byte-identical
to ``--backend host``; a TorchDeviceDB carried across from a JAX DeviceDB
with a screen must give the (meta, aux) of
``DeviceDB._search_reads_screened`` (interpret mode)."""

import io

import numpy as np
import pytest
import torch

from kmcp_tpu.kmer import native
from kmcp_tpu.search.device import DeviceDB
from kmcp_tpu.search.engine import SearchEngine, SearchOptions
from kmcp_tpu_torch.commands.search import run_search
from kmcp_tpu_torch.search import engine as port_engine
from kmcp_tpu_torch.search.device import TorchDeviceDB
from kmcp_tpu_torch.search.stream import TorchStreamSearcher

from .test_torch_stream import build_db, mixed_reads, stream_tsv

torch.set_num_threads(1)


def screened_db(tmp_path, genomes, block_targets, split_number=4):
    """test_index_search.py:979's recipe: tpu-native blocks of
    ``block_targets`` targets with union screens of one geometry."""
    return build_db(tmp_path, genomes, split_number=split_number,
                    native_block_targets=block_targets, block_screen=True,
                    uniform_sigs=True)


def uneven_genomes(rng, sizes):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [rng.choice(bases, size=n).tobytes() for n in sizes]


def screened_reads(rng, genomes, n=256):
    """Source reads, junk reads, too-short reads and reads with an N."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    for i in range(n):
        if i % 5 == 4:
            seq = rng.choice(bases, size=150).tobytes()
        elif i % 17 == 16:
            seq = b"ACGT"
        else:
            g = genomes[int(rng.integers(0, len(genomes)))]
            p = int(rng.integers(0, len(g) - 150))
            r = bytearray(g[p : p + 150])
            if i % 13 == 12:
                r[70] = ord("N")
            seq = bytes(r)
        reads.append((f"r{i}", seq, None))
    return reads


def port_tsv(db, reads, pass2, **opt_kw):
    opt = port_engine.SearchOptions(batch_size=128, **opt_kw)
    st = TorchStreamSearcher(port_engine.SearchEngine([db], opt), "cpu",
                             pass2)
    buf = io.StringIO()
    total, _ = st.run(iter(reads), buf)
    assert total == len(reads)
    return buf.getvalue(), st


@pytest.mark.parametrize("block_targets,n_words", [(4, 1), (64, 2)])
def test_screened_stream_matches_host(tmp_path, block_targets, n_words):
    """W_b = 1 (4-target blocks of 16 targets) and W_b = 2 (64-target
    blocks of 160 targets): both pass-2 kernels equal --backend host."""
    rng = np.random.default_rng(53)
    if block_targets == 4:
        genomes = uneven_genomes(rng, [30000, 42000, 36000, 30000])
        db = screened_db(tmp_path, genomes, 4)
    else:
        genomes = uneven_genomes(rng, [20000] * 16)
        db = screened_db(tmp_path, genomes, 64, split_number=10)
    reads = screened_reads(rng, genomes) + mixed_reads(rng, genomes, 60)
    want = stream_tsv(db, reads, "host")[0]
    for pass2 in ("pair", "gemm"):
        got, st = port_tsv(db, reads, pass2)
        assert st.dev.n_blocks > 1 and st.dev.w == n_words
        assert st.dev.pass2 == pass2
        assert got == want, pass2
    assert want.count("\n") > 150


@pytest.mark.parametrize("pass2", ["pair", "gemm"])
def test_screened_stream_budget_overflow_retry(tmp_path, pass2):
    """Eight near-identical genomes over 4-target blocks: every read
    matches 8+ targets in several blocks, past the 2-slots-per-read budget
    of a 16,384-read batch, so the batch re-runs with 4x the budget."""
    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base_seq = bytearray(rng.choice(bases, size=12000).tobytes())
    genomes = []
    for _ in range(8):
        seq = bytearray(base_seq)
        for pos in rng.integers(0, len(seq), size=5):
            seq[pos] = bases[int(rng.integers(0, 4))]
        genomes.append(bytes(seq))
    db = screened_db(tmp_path, genomes, 4, split_number=2)
    reads = []
    for i in range(4500):
        p = int(rng.integers(0, len(base_seq) - 150))
        reads.append((f"r{i}", bytes(base_seq[p : p + 150]), None))
    got, st = port_tsv(db, reads, pass2)
    assert st.retries >= 1 and st.dev.n_blocks == 4
    assert got == stream_tsv(db, reads, "host")[0]
    assert got.count("\n") >= 8 * len(reads)


def test_run_search_screened_stats(tmp_path):
    """The command entry point on a screened DB reports its blocks, union
    rows and pass-2 kernel; the FASTQ's TSV equals --backend host's."""
    from kmcp_tpu.commands.search import run_search as run_search_host

    rng = np.random.default_rng(5)
    genomes = uneven_genomes(rng, [30000, 30000, 30000])
    db = screened_db(tmp_path, genomes, 4)
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for rid, seq, _ in mixed_reads(rng, genomes, 100):
            f.write(f"@{rid}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
    stats = {}
    run_search(db, [str(fq)], out_file=str(tmp_path / "t.tsv"),
               device="cpu", verbose=False, stats=stats, pass2="gemm")
    run_search_host(db, [str(fq)], out_file=str(tmp_path / "h.tsv"),
                    opt=SearchOptions(backend="host"), verbose=False)
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "h.tsv").read_bytes()
    assert stats["n_blocks"] == 3 and stats["pass2"] == "gemm"
    assert stats["union_rows"] > 0 and stats["rows"] % 3 == 0
    with pytest.raises(ValueError, match="256"):
        run_search(db, [str(fq)],
                   opt=port_engine.SearchOptions(kmer_dedup_threshold=300),
                   device="cpu", verbose=False, pass2="gemm")


@pytest.mark.parametrize("pass2", ["pair", "gemm"])
def test_state_from_jax_screened_device_db(tmp_path, pass2):
    """TorchDeviceDB.from_numpy_state of a JAX DeviceDB with a screen gives
    the same (meta, aux) as DeviceDB._search_reads_screened with the
    Pallas hash in interpret mode and the XLA pass 2."""
    if native.get_lib() is None:
        pytest.skip("needs the native library")
    rng = np.random.default_rng(53)
    genomes = uneven_genomes(rng, [30000, 42000, 36000, 30000])
    db_dir = screened_db(tmp_path, genomes, 4)
    opt = SearchOptions(backend="jax", batch_size=256)
    db = SearchEngine([db_dir], opt).dbs[0]
    jdev = DeviceDB(db, opt)
    assert jdev.screen is not None and jdev.n_blocks == 4
    reads = [seq for _, seq, _ in screened_reads(rng, genomes)]
    lens = np.array([len(s) for s in reads], dtype=np.int64)
    lmax, budget = 160, 8 * len(reads)
    mat = native.pack_rows(reads, lens, lmax)
    want = jdev._search_reads_screened(mat, lens, budget, 21, lmax,
                                       (1 << 64) - 1, interpret=True)
    scr = jdev.screen
    state = {
        "bits_ext": np.asarray(jdev.bits_ext),
        "names": jdev.names,
        "indices": jdev.indices,
        "gsizes": jdev.gsizes,
        "sizes": jdev.sizes,
        "sizes_pos": jdev.sizes_pos_np,
        "tmin": jdev._tmin_np,
        "cmin": {n: np.asarray(t) for n, t in jdev._cmin_cache.items()},
        "k": 21,
        "num_hashes": 1,
        "max_hash": (1 << 64) - 1,
        "screen": {"u_ext": np.asarray(scr["u_ext"]), "fprs": scr["fprs"],
                   "num_bits": scr["num_bits"], "s_block": scr["s_block"]},
    }
    carried = TorchDeviceDB.from_numpy_state(state, opt, "cpu", db.query_fpr,
                                             pass2=pass2)
    built = TorchDeviceDB(db, opt, "cpu", pass2=pass2)
    np.testing.assert_array_equal(carried.screen["u_ext"].numpy(),
                                  built.screen["u_ext"].numpy())
    np.testing.assert_array_equal(carried.theta_for(140).numpy(),
                                  np.asarray(jdev._theta_for(140)))
    for dev in (carried, built):
        meta, aux = dev.search_reads(torch.from_numpy(mat), lens, budget)
        assert 0 < meta[0] <= budget
        np.testing.assert_array_equal(meta, np.asarray(want[0]))
        np.testing.assert_array_equal(aux, np.asarray(want[1]))
