"""Reference-layout ``.kmcp`` DBs in the port (ROADMAP A12): the port's
index/uniki.py writes and reads the same bytes as kmcp_tpu's, and the port
searches an exported reference-layout DB to the TSV of kmcp_tpu's
``--backend host`` search of it and of the port's own layout.  The tests
of tests/test_uniki_interop.py that run without the reference checkout,
mirrored."""

import os

import numpy as np
import pytest
import torch

from kmcp_tpu.commands.search import run_search as run_search_host
from kmcp_tpu.index import uniki as jax_uniki
from kmcp_tpu.search.engine import SearchOptions
from kmcp_tpu_torch.commands.search import run_search
from kmcp_tpu_torch.index import uniki
from kmcp_tpu_torch.search import engine as port_engine

from .test_torch_engine import build_db, write_fastq
from .test_torch_stream import mixed_reads, random_genomes

torch.set_num_threads(1)


@pytest.mark.parametrize("num_targets", [1, 7, 8, 9, 31, 32, 33, 100])
def test_bit_layout_round_trip(num_targets):
    """MSB-first reference byte columns <-> LSB-first uint32 words, equal
    to kmcp_tpu's conversion."""
    rng = np.random.default_rng(3 + num_targets)
    rb = (num_targets + 7) // 8
    ref = rng.integers(0, 256, size=(50, rb), dtype=np.uint8)
    tail_bits = rb * 8 - num_targets
    if tail_bits:  # real targets occupy the top bits of the last byte
        ref[:, -1] &= np.uint8((0xFF << tail_bits) & 0xFF)
    words = uniki.ref_bytes_to_words(ref)
    np.testing.assert_array_equal(words, jax_uniki.ref_bytes_to_words(ref))
    for t in (0, num_targets - 1, num_targets // 2):
        col_w = (words[:, t >> 5] >> np.uint32(t & 31)) & np.uint32(1)
        col_r = (ref[:, t >> 3] >> np.uint8(7 - (t & 7))) & np.uint8(1)
        np.testing.assert_array_equal(col_w.astype(np.uint8), col_r)
    np.testing.assert_array_equal(uniki.words_to_ref_bytes(words,
                                                           num_targets), ref)


def test_db_yml_round_trip(tmp_path):
    fields = {
        "version": 4, "unikiVersion": 4, "alias": "demo", "k": 21,
        "ks": [21, 31], "hashed": True, "canonical": True,
        "scaled": False, "scale": 1, "minimizer": False,
        "minimizer-w": 0, "syncmer": False, "syncmer-s": 0,
        "split-seq": True, "split-size": 0, "split-num": 10,
        "split-overlap": 150, "compact-size": True, "hashes": 1,
        "fpr": 0.3, "numNameGroups": 15, "blocksize": 8,
        "totalKmers": 123456789,
        "files": ["_block001.uniki", "_block002.uniki"],
    }
    uniki.write_db_yml(str(tmp_path / "port.yml"), fields)
    jax_uniki.write_db_yml(str(tmp_path / "jax.yml"), fields)
    assert ((tmp_path / "port.yml").read_bytes()
            == (tmp_path / "jax.yml").read_bytes())
    assert uniki.read_db_yml(str(tmp_path / "port.yml")) == fields


def dir_bytes(path) -> dict:
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("tpu_native", [True, False])
def test_ref_layout_export_load_and_search(tmp_path, tpu_native):
    """export_ref_layout writes kmcp_tpu's bytes (one block, or the
    reference's partition into blocks of 2 targets); load_ref_db reads
    them back to the DB's own bits and metadata; the port's search of the
    reference layout (its parent directory or the R-dir) equals kmcp_tpu's
    --backend host search of it and the port's search of its own layout,
    for reads and for -g."""
    rng = np.random.default_rng(41)
    genomes = random_genomes(rng, 4, 20000)
    kw = dict(tpu_native=True) if tpu_native else dict(block_size=2, h=2)
    db = build_db(tmp_path / "src", genomes, fpr=0.1, **kw)
    rdir = uniki.export_ref_layout(db, str(tmp_path / "port" / "refdb"))
    want = jax_uniki.export_ref_layout(db, str(tmp_path / "jax" / "refdb"))
    assert dir_bytes(rdir) == dir_bytes(want)
    n_blocks = len([n for n in os.listdir(rdir) if n.endswith(".uniki")])
    assert n_blocks == (1 if tpu_native else 6)

    info, blocks = uniki.load_ref_db(rdir)
    jinfo, jblocks = jax_uniki.load_ref_db(want)
    assert vars(info) == vars(jinfo)
    own = port_engine.SearchDB(db, port_engine.SearchOptions())
    for (meta, bits), (jmeta, jbits), blk in zip(blocks, jblocks,
                                                  own.blocks):
        assert vars(meta) == vars(jmeta)
        np.testing.assert_array_equal(bits, jbits)
        np.testing.assert_array_equal(bits, np.asarray(blk.bits))
        assert meta.names[: meta.num_targets] == blk.meta.names[
            : meta.num_targets]

    fq = str(tmp_path / "reads.fq")
    write_fastq(fq, [(r[0], r[1]) for r in mixed_reads(rng, genomes, 60)])
    # -g: each of g1's three chunks holds a third of its k-mers
    for files, whole, qcov in (
            ([fq], False, 0.55),
            ([str(tmp_path / "src" / "g1.fa")], True, 0.25)):
        outs = {}
        for name, target in (("ref", str(tmp_path / "port" / "refdb")),
                             ("rdir", rdir), ("own", db)):
            out = tmp_path / f"{name}.tsv"
            run_search(target, files, out_file=str(out), whole_file=whole,
                       device="cpu", verbose=False,
                       opt=port_engine.SearchOptions(min_query_cov=qcov))
            outs[name] = out.read_bytes()
        run_search_host(rdir, files=files, whole_file=whole,
                        out_file=str(tmp_path / "host.tsv"),
                        opt=SearchOptions(backend="host",
                                          min_query_cov=qcov),
                        verbose=False)
        assert outs["ref"] == (tmp_path / "host.tsv").read_bytes()
        assert outs["ref"] == outs["rdir"] == outs["own"]
        assert outs["ref"].count(b"\tg1\t") >= 1
