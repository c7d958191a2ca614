"""The slice end to end on the CPU: kmcp_tpu_torch's streaming search (the
kernels' plain versions) must write a TSV byte-identical to
``--backend host`` and to the JAX streamer on the CPU, on tiny DBs built
with the repo's own compute + index; each search streams or runs the object
engine as the JAX streamer routes it."""

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
from kmcp_tpu_torch.search.stream import TorchStreamSearcher, usable

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
    """Routing: each search streams or runs the object engine as the JAX
    streamer decides (kmcp_tpu/search/stream.py:195-280), and nothing
    raises for a search the streamer turns down; the streamer itself
    refuses those, and a CUDA-less ``device="cuda"`` still raises."""
    rng = np.random.default_rng(9)
    genomes = random_genomes(rng, 3, 20000)
    db = build_db(tmp_path / "one", genomes)
    multi = build_db(tmp_path / "multi", genomes, tpu_native=False,
                     block_size=2)
    fa = tmp_path / "q.fa"
    fa.write_text(f">q\n{genomes[0][:300].decode()}\n")
    q = [str(fa)]

    def route(db_dir, **kw) -> str:
        stats: dict = {}
        run_search(db_dir, out_file=str(tmp_path / "out.tsv"), device="cpu",
                   verbose=False, stats=stats, **kw)
        assert (tmp_path / "out.tsv").read_text().count("\tg0\t") >= 1
        return stats["route"]

    opt = port_engine.SearchOptions
    assert route(db, files=q) == "stream"
    assert route(db, read1=q[0], read2=q[0]) == "stream"
    assert route(db, read1=q[0], read2=q[0], opt=opt(try_se=True)) == "engine"
    assert route(db, files=q, whole_file=True) == "engine"
    assert route(multi, files=q) == "engine"  # no union screens
    assert route(db, files=q, opt=opt(low_mem=True)) == "engine"
    assert route(db, files=q, opt=opt(sort_by="jacc")) == "engine"
    assert route(db, files=q, opt=opt(kmer_dedup_threshold=65535)) == "engine"

    eng = port_engine.SearchEngine([db], opt())
    assert usable(eng) and usable(eng, paired=True)
    assert not usable(port_engine.SearchEngine([db, db], opt()))
    info = eng.dbs[0].info
    # sketch DBs stream single-end over one block, with s < k for syncmers
    eng.dbs[0].is_sketch = True
    eng.dbs[0].info = dataclasses.replace(info, minimizer=True,
                                          minimizer_w=5)
    assert usable(eng) and not usable(eng, paired=True)
    with pytest.raises(ValueError, match="object engine"):
        TorchStreamSearcher(eng, "cpu").run(iter([]), io.StringIO(),
                                            paired=True)
    eng.dbs[0].info = dataclasses.replace(info, syncmer=True, syncmer_s=21)
    assert not usable(eng)
    eng.dbs[0].info = dataclasses.replace(info, syncmer=True, syncmer_s=11)
    assert usable(eng)
    eng.dbs[0].is_sketch = False
    eng.dbs[0].info = dataclasses.replace(info, canonical=False)
    assert not usable(eng)
    with pytest.raises(ValueError, match="object engine"):
        TorchStreamSearcher(eng, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_search(db, q, device="cuda", verbose=False)


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for rid, seq in reads:
            f.write(f"@{rid}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
    return str(path)


def _progress_part(err: str) -> list[str]:
    """stderr after the main-parameters block, numbers masked."""
    import re

    lines = err.split("\n")
    i = lines.index("[search] main parameters:") + 1
    while lines[i].startswith("  "):
        i += 1
    return [re.sub(r"\d+(\.\d+)?", "#", line) for line in lines[i:]]


@pytest.mark.parametrize("case", ["single", "paired", "engine"])
def test_verbose_stderr_matches_kmcp_tpu(tmp_path, capsys, case):
    """With ``verbose`` the port's stderr after the main-parameters block
    is kmcp_tpu's line for line, numbers masked: a line for each drained
    batch and the "(streaming)" summary on the streamer (single-end reads
    in two batches, and pairs), the carriage-return line for each object
    engine batch and the "queries matched" summary (``-g``, a query a
    file, 2 a batch).  The TSVs are the same bytes."""
    rng = np.random.default_rng(29)
    genomes = random_genomes(rng, 3, 20000)
    db = build_db(tmp_path, genomes)
    kw: dict = {}
    if case == "single":  # 17,000 reads: two 16,384-read batches
        reads = [(r[0], r[1]) for r in mixed_reads(rng, genomes, 17000)]
        kw["files"] = [_write_fastq(tmp_path / "r.fq", reads)]
    elif case == "paired":  # 300 fragments of 350 bp, mates of 150 bp
        at = [(genomes[i % 3], int(rng.integers(0, 19650)))
              for i in range(300)]
        for mate, off in (("read1", 0), ("read2", 200)):
            kw[mate] = _write_fastq(tmp_path / f"{mate}.fq", [
                (f"p{i}", g[p + off : p + off + 150])
                for i, (g, p) in enumerate(at)])
    else:  # five files of two 3 kb records of one genome each
        kw.update(whole_file=True, batch_queries=2, files=[
            _write_fastq(tmp_path / f"g{i}.fq", [
                (f"q{i}.{j}", genomes[i % 3][p : p + 3000])
                for j, p in enumerate(rng.integers(0, 17000, 2).tolist())])
            for i in range(5)])
    stats: dict = {}
    run_search(db, out_file=str(tmp_path / "port.tsv"), device="cpu",
               stats=stats, **kw)
    port_err = capsys.readouterr().err
    run_search_host(db, out_file=str(tmp_path / "jax.tsv"),
                    opt=SearchOptions(backend="host"), **kw)
    jax_err = capsys.readouterr().err
    assert stats["route"] == ("engine" if case == "engine" else "stream")
    assert ((tmp_path / "port.tsv").read_bytes()
            == (tmp_path / "jax.tsv").read_bytes())
    got, want = _progress_part(port_err), _progress_part(jax_err)
    assert got == want
    if case == "engine":
        n = [err.count("\rprocessed queries: ") for err in (port_err, jax_err)]
        assert n == [3, 3] and "(#/#) queries matched" in want[-2]
        assert "100.0000% (5/5)" in port_err
    else:
        n = [err.count(" queries done at ") for err in (port_err, jax_err)]
        assert n == ([2, 2] if case == "single" else [1, 1])
        assert "(streaming)" in want[-2]
