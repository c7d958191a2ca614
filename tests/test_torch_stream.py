"""The slice end to end on the CPU: kmcp_tpu_torch's streaming search (the
kernels' plain versions) must write a TSV byte-identical to
``--backend host`` and to the JAX streamer on the CPU, on tiny DBs built
with the repo's own compute + index; searches outside the slice raise."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from kmcp_tpu.commands.compute import ComputeOptions, run_compute
from kmcp_tpu.commands.search import run_search as run_search_host
from kmcp_tpu.index.build import run_index
from kmcp_tpu.kmer import native
from kmcp_tpu.search.engine import SearchEngine, SearchOptions
from kmcp_tpu.search.stream import StreamSearcher
from kmcp_tpu_torch.commands.search import run_search
from kmcp_tpu_torch.search import engine as port_engine
from kmcp_tpu_torch.search.stream import TorchStreamSearcher, unsupported

torch.set_num_threads(1)


def build_db(tmp_path, genomes, num_hashes=1, split_number=3, **index_kw):
    """FASTA files -> compute (k=21 chunks) -> tpu-native index."""
    if native.get_lib() is None:
        pytest.skip("streaming needs the native library")
    tmp_path.mkdir(parents=True, exist_ok=True)
    files = []
    for g, seq in enumerate(genomes):
        p = tmp_path / f"g{g}.fa"
        p.write_text(f">g{g}\n{seq.decode()}\n")
        files.append(str(p))
    run_compute(
        out_dir=str(tmp_path / "ks"), files=files,
        opt=ComputeOptions(ks=[21], split_number=split_number,
                           split_overlap=100),
        force=True, verbose=False,
    )
    index_kw.setdefault("tpu_native", True)
    run_index(in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
              num_hashes=num_hashes, fpr=0.3, force=True, verbose=False,
              **index_kw)
    return str(tmp_path / "db")


def random_genomes(rng, n, length):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [rng.choice(bases, size=length).tobytes() for _ in range(n)]


def mixed_reads(rng, genomes, n=300):
    """test_index_search.py:340's read mix: 150 bp reads, some too short,
    some long enough to pass the k-mer dedup threshold."""
    reads = []
    for i in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        ln = 600 if i % 37 == 0 else 20 if i % 11 == 0 else 150
        p = int(rng.integers(0, len(g) - ln))
        reads.append((f"r{i}", g[p : p + ln], None))
    return reads


def stream_tsv(db, reads, backend=None, **opt_kw):
    """TSV body of one streaming run: the port (its own engine) on the CPU
    when backend is None, else kmcp_tpu's StreamSearcher with that
    backend."""
    buf = io.StringIO()
    if backend is None:
        opt = port_engine.SearchOptions(batch_size=128, **opt_kw)
        st = TorchStreamSearcher(port_engine.SearchEngine([db], opt), "cpu")
    else:
        opt = SearchOptions(backend=backend, batch_size=128, **opt_kw)
        eng = SearchEngine([db], opt)
        assert StreamSearcher.usable(eng)
        st = StreamSearcher(eng)
    total, _ = st.run(iter(reads), buf)
    assert total == len(reads)
    return buf.getvalue(), st


@pytest.mark.parametrize("num_hashes", [1, 3])
def test_stream_matches_host_and_jax(tmp_path, num_hashes):
    rng = np.random.default_rng(11)
    genomes = random_genomes(rng, 4, 30000)
    db = build_db(tmp_path, genomes, num_hashes=num_hashes)
    reads = mixed_reads(rng, genomes)
    got, st = stream_tsv(db, reads)
    assert got == stream_tsv(db, reads, "host")[0]
    assert got == stream_tsv(db, reads, "jax")[0]
    assert st.slow_rows == sum(len(r[1]) == 600 for r in reads) > 0
    assert got.count("\n") > 250


def test_stream_keep_top_scores_matches_host(tmp_path):
    """-n takes the Python row writer."""
    rng = np.random.default_rng(3)
    genomes = random_genomes(rng, 3, 20000)
    db = build_db(tmp_path, genomes)
    reads = mixed_reads(rng, genomes, 120)
    got, _ = stream_tsv(db, reads, keep_top_scores=1, keep_unmatched=True)
    assert got == stream_tsv(db, reads, "host", keep_top_scores=1,
                             keep_unmatched=True)[0]


def test_stream_budget_overflow_retry(tmp_path):
    """test_index_search.py:275's recipe at a full 16,384-read batch: eight
    near-identical genomes make every read match 8+ targets, past the
    2-slots-per-read budget, so the batch re-runs with 4x the budget."""
    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base_seq = bytearray(rng.choice(bases, size=20000).tobytes())
    genomes = []
    for _ in range(8):
        seq = bytearray(base_seq)
        for pos in rng.integers(0, len(seq), size=5):
            seq[pos] = bases[int(rng.integers(0, 4))]
        genomes.append(bytes(seq))
    db = build_db(tmp_path, genomes, split_number=2)
    reads = []
    for i in range(16384):
        p = int(rng.integers(0, len(base_seq) - 150))
        reads.append((f"r{i}", bytes(base_seq[p : p + 150]), None))
    got, st = stream_tsv(db, reads)
    assert st.retries >= 1
    assert got == stream_tsv(db, reads, "host")[0]
    assert got.count("\n") >= 8 * len(reads)


def test_run_search_file_matches_host(tmp_path):
    """The command entry point, reads from FASTQ, TSV to a file."""
    rng = np.random.default_rng(5)
    genomes = random_genomes(rng, 3, 20000)
    db = build_db(tmp_path, genomes)
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for rid, seq, _ in mixed_reads(rng, genomes, 100):
            f.write(f"@{rid}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
    stats = {}
    run_search(db, [str(fq)], out_file=str(tmp_path / "t.tsv"),
               device="cpu", verbose=False, stats=stats)
    run_search_host(db, [str(fq)], out_file=str(tmp_path / "h.tsv"),
                    opt=SearchOptions(backend="host"), verbose=False)
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "h.tsv").read_bytes()
    assert stats["slow_rows"] > 0 and stats["retries"] == 0


def test_min_target_cov_matches_numpy_engine(tmp_path):
    """-T on a DB with size-0 padding lanes: kmcp_tpu's streaming backends
    fail there (build_tmin_table divides by the size); the port matches
    the numpy object engine."""
    rng = np.random.default_rng(6)
    genomes = random_genomes(rng, 3, 20000)
    db = build_db(tmp_path, genomes)
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for rid, seq, _ in mixed_reads(rng, genomes, 100):
            f.write(f"@{rid}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
    run_search(db, [str(fq)], out_file=str(tmp_path / "t.tsv"),
               opt=port_engine.SearchOptions(min_target_cov=0.01),
               device="cpu", verbose=False)
    run_search_host(db, [str(fq)], out_file=str(tmp_path / "n.tsv"),
                    opt=SearchOptions(min_target_cov=0.01), verbose=False)
    got = (tmp_path / "t.tsv").read_bytes()
    assert got == (tmp_path / "n.tsv").read_bytes()
    assert got.count(b"\n") > 50


def test_unsupported_searches_raise(tmp_path, monkeypatch):
    """Outside the slice the port raises, naming the ROADMAP item; it never
    runs another engine in the slice's place."""
    rng = np.random.default_rng(9)
    genomes = random_genomes(rng, 3, 20000)
    db = build_db(tmp_path / "one", genomes)
    multi = build_db(tmp_path / "multi", genomes, tpu_native=False,
                     block_size=2)
    fa = tmp_path / "q.fa"
    fa.write_text(f">q\n{genomes[0][:300].decode()}\n")
    q = [str(fa)]
    # paired reads stream (A6), but not with --try-se (A8), nor on a
    # sketch DB (A7)
    with pytest.raises(NotImplementedError, match="A8"):
        run_search(db, read1=q[0], read2=q[0], device="cpu", verbose=False,
                   opt=port_engine.SearchOptions(try_se=True))
    with pytest.raises(NotImplementedError, match="A8"):
        run_search(db, q, whole_file=True, device="cpu", verbose=False)
    # a multi-block DB without union screens (no --block-screen)
    with pytest.raises(NotImplementedError,
                       match="--block-screen --uniform-sigs"):
        run_search(multi, q, device="cpu", verbose=False)
    with pytest.raises(NotImplementedError, match="A8"):
        run_search(db, q, opt=port_engine.SearchOptions(low_mem=True),
                   device="cpu", verbose=False)
    with pytest.raises(NotImplementedError, match="A8"):
        run_search(db, q, opt=port_engine.SearchOptions(sort_by="jacc"),
                   device="cpu", verbose=False)
    eng = port_engine.SearchEngine([db], port_engine.SearchOptions())
    assert unsupported(eng) is None
    eng.dbs[0].is_sketch = True
    assert "A7" in unsupported(eng)
    assert "A7" in unsupported(eng, paired=True)
    with pytest.raises(NotImplementedError, match="A7"):
        TorchStreamSearcher(eng, "cpu").run(iter([]), io.StringIO(),
                                            paired=True)
    eng.dbs[0].is_sketch = False
    eng.dbs[0].info = dataclasses.replace(eng.dbs[0].info, canonical=False)
    with pytest.raises(NotImplementedError, match="canonical"):
        TorchStreamSearcher(eng, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_search(db, q, device="cuda", verbose=False)
