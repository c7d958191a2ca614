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


class _OneRankMesh:
    """The face of a ("d", "t") DeviceMesh of one rank that
    ``TorchDeviceDB(mesh=...)`` reads before it opens anything."""

    mesh_dim_names = ("d", "t")

    def get_coordinate(self):
        return (0, 0)

    def size(self, dim):
        return 1


def no_screen_input(tmp_path):
    """The 4-block DB of test_screened_stream_matches_host[4-1] and 3,000
    random 150 bp reads, then 200 of ``screened_reads``, as a FASTQ: at
    -t 0.31 the screen's theta drops junk reads' false-positive hits."""
    rng = np.random.default_rng(53)
    genomes = uneven_genomes(rng, [30000, 42000, 36000, 30000])
    db = screened_db(tmp_path, genomes, 4)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = [(f"j{i}", rng.choice(bases, size=150).tobytes())
             for i in range(3000)]
    reads += [(rid, seq) for rid, seq, _ in screened_reads(rng, genomes, 200)]
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for rid, seq in reads:
            f.write(f"@{rid}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
    return db, str(fq)


def _rows_by_query(tsv: bytes) -> dict:
    rows: dict = {}
    for line in tsv.decode().splitlines():
        if not line.startswith("#"):
            rows.setdefault(line.split("\t")[0], []).append(line)
    return rows


def test_no_screen_takes_object_engine(tmp_path, monkeypatch):
    """``KMCP_TPU_NO_SCREEN`` turns the union screens off on every route,
    as in kmcp_tpu: the card's streamer declines the multi-block DB, so
    the object engine counts every block, byte-identical to kmcp_tpu's
    object engine (which its device route runs under the variable); the
    port's ``--backend host`` (HostDB without its unions) is
    byte-identical to kmcp_tpu's; a mesh and ``numpy_state`` refuse the DB
    with the JAX package's messages.  Without the variable the screened
    stream drops the junk reads' false-positive hits again."""
    import jax
    from jax.sharding import Mesh

    from kmcp_tpu.commands.search import run_search as run_search_jax
    from kmcp_tpu_torch.search.device import (
        MESH_SCREEN,
        check_mesh_db,
        numpy_state,
    )
    from kmcp_tpu_torch.search.stream import usable

    db, fq = no_screen_input(tmp_path)
    kw = dict(batch_size=128, min_query_cov=0.31)
    opt = port_engine.SearchOptions(**kw)

    def port(name, opt):
        stats: dict = {}
        out = tmp_path / name
        run_search(db, [fq], out_file=str(out), device="cpu", verbose=False,
                   stats=stats, opt=opt)
        return out.read_bytes(), stats

    def jax_package(name, backend):
        out = tmp_path / name
        run_search_jax(db, [fq], out_file=str(out), verbose=False,
                       opt=SearchOptions(backend=backend, **kw))
        return out.read_bytes()

    monkeypatch.setenv("KMCP_TPU_NO_SCREEN", "1")
    engine = port_engine.SearchEngine([db], opt)
    assert not usable(engine)
    got, stats = port("card.tsv", opt)
    assert stats["route"] == "engine"
    assert got == jax_package("jax_engine.tsv", "numpy")
    host, host_stats = port("host.tsv", port_engine.SearchOptions(
        backend="host", **kw))
    assert host_stats["route"] == "stream" and host_stats["union_rows"] == 0
    assert host == jax_package("jax_host.tsv", "host")
    assert got.count(b"\n") > 300
    # kmcp_tpu's streamer and its object engine part on one read: its
    # QueryFPRCache keys (n, k) as (n, min(k, n - k)), so r138's 82 of 130
    # k-mers in g3 chunk 2 read the FPR of a junk read's 48 (3.6478e-02,
    # over max_fpr 0.01); the engine drops that match, the streamer (cmin
    # passes 82) writes it with that FPR
    want, have = _rows_by_query(host), _rows_by_query(got)
    assert [q for q in want if want[q] != have.get(q)] == ["r138"]
    def no_hits(rows):  # column 4 is the query's hit count
        return {tuple(r.split("\t")[:4] + r.split("\t")[5:]) for r in rows}

    extra = no_hits(want["r138"]) - no_hits(have["r138"])
    assert [(r[4], r[5], r[3]) for r in extra] == [("g3", "2", "3.6478e-02")]

    pdb = engine.dbs[0]
    with pytest.raises(ValueError) as jerr:
        DeviceDB(SearchEngine([db], SearchOptions(backend="jax")).dbs[0],
                 SearchOptions(backend="jax"),
                 mesh=Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                           ("d", "t")))
    assert str(jerr.value) == MESH_SCREEN
    with pytest.raises(ValueError) as perr:
        check_mesh_db(pdb, 1)
    assert str(perr.value) == MESH_SCREEN
    with pytest.raises(ValueError) as perr:
        TorchDeviceDB(pdb, opt, "cpu", mesh=_OneRankMesh())
    assert str(perr.value) == MESH_SCREEN
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        numpy_state(pdb, opt)

    monkeypatch.delenv("KMCP_TPU_NO_SCREEN")
    assert usable(port_engine.SearchEngine([db], opt))
    screened, stats = port("screened.tsv", opt)
    assert stats["route"] == "stream" and stats["union_rows"] > 0
    assert screened.count(b"\n") < got.count(b"\n")
    check_mesh_db(pdb, 1)
    # kmcp_tpu's streamer takes a multi-block DB only on its device hash
    monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", "scan")
    assert not usable(port_engine.SearchEngine([db], opt))


@pytest.fixture(scope="module")
def screened4(tmp_path_factory):
    """test_screened_stream_matches_host[4-1]'s DB and reads, and the
    --backend host TSV of the reads."""
    rng = np.random.default_rng(53)
    genomes = uneven_genomes(rng, [30000, 42000, 36000, 30000])
    db = screened_db(tmp_path_factory.mktemp("screened4"), genomes, 4)
    reads = screened_reads(rng, genomes)
    return db, reads, stream_tsv(db, reads, "host")[0]


@pytest.mark.parametrize("pass2,dedup,env,want", [
    ("auto", 256, None, "pair"),
    ("auto", 300, None, "pair"),
    ("pair", 256, None, "pair"),
    ("gemm", 256, None, "gemm"),
    ("auto", 256, "1", "pair"),
    ("gemm", 300, None, "kmer_dedup_threshold <= 256"),
    ("xla", 256, None, "must be auto, pair or gemm"),
])
def test_pass2_argument(screened4, monkeypatch, pass2, dedup, env, want):
    """``pass2`` picks the pass-2 kernel of the screened tail: "auto" is
    ``pass2_kernel``'s measured rule (K5'), "pair" K5', "gemm" K6' while
    row multiplicities fit bf16; the TSV is --backend host's whichever
    kernel counts.  ``KMCP_TPU_GEMM_PAIR``, kmcp_tpu's TPU switch between
    its pass-2 kernels, is not read (ROADMAP A10)."""
    db, reads, host = screened4
    if env is not None:
        monkeypatch.setenv("KMCP_TPU_GEMM_PAIR", env)
    if pass2 == "xla" or dedup > 256 and pass2 == "gemm":
        with pytest.raises(ValueError, match=want):
            port_tsv(db, reads, pass2, kmer_dedup_threshold=dedup)
        return
    got, st = port_tsv(db, reads, pass2, kmer_dedup_threshold=dedup)
    assert st.dev.pass2 == want
    assert got == host
