"""The multi-block screened layout that a configuration may declare
(``block_screen``): the DB build's flags and cache key,
the plain reference's blocks and union screens against the index the port
builds and its rows against the port's ``--backend host`` on a tiny DB of
3 blocks, the screen's band, whole runs on the CPU with the route check,
and a new configuration and cell found by name."""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from conftest import CONFIG, manifest_copy, make_tree, tiny_config, \
    tiny_traffic
from test_bench_reference import host_rows

from harness import compare
from harness.dbcache import ensure_db, index_args, index_key
from harness.genomes import genome_codes
from harness.manifest import find_cell
from harness.reference import Reference, set_bits, union_bits, union_fpr
from harness.traffic import ACGT, Pool, make_pool, pool_size, write_fastq
from harness.window import run

NAME = "screened-tiny"
# 12 genomes x 8 chunks: 96 targets, 3 blocks of 32
SCREENED = {"block_screen": True, "block_targets": 32}
# Search options under which the screen decides rows.  At the
# configuration's own (min_query_cov 0.55, min_kmers 10) the count floor
# lies above the band at every read length the traffic sends, so no row
# turns on the screen there; with 5 k-mers a read, a floor of 3 and a
# union rate near 0.14, theta is 4.  min_query_cov stays at 0.5 or above:
# below it the program's query-FPR cache, like KMCP's, hands count c the
# value of n - c where that came first, which no reference can follow.
BAND = {"min_query_len": 20, "min_kmers": 3, "min_query_cov": 0.5,
        "max_fpr": 1.0}
SEED = 2**31 + 41


def screened_config(search: dict | None = None) -> dict:
    cfg = tiny_config(CONFIG)
    cfg.update(SCREENED)
    cfg["search"].update(search or {})
    return cfg


def add_cells(root: str, config: dict, cells: dict) -> None:
    """Add ``config`` as configuration NAME and ``cells`` ({cell:
    traffic}) to the tree at ``root``: one new file and new entries."""
    path = f"benchmark/configs/{NAME}.json"
    with open(os.path.join(root, path), "w") as f:
        json.dump(config, f)
    m = manifest_copy(root)
    m["configs"].append({"name": NAME, "source": "x", "file": path,
                         "reduced": [], "why": "x"})
    m["workloads"] += [{"name": c, "config": NAME, "traffic": t,
                        "chips": 1, "why": "x"} for c, t in cells.items()]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)


@pytest.fixture(scope="module")
def screened_root(tmp_path_factory):
    root = make_tree(str(tmp_path_factory.mktemp("screened")))
    add_cells(root, screened_config(), {"screened-se": "se",
                                        "screened-pe": "pe"})
    return root


@pytest.fixture(scope="module")
def screened_db(screened_root):
    db, _ = ensure_db(screened_config(),
                      os.path.join(screened_root, "benchmark", ".cache"))
    return db


def test_the_index_key_of_the_accepted_configuration_is_pinned():
    """gtdb-r202-256g's DB keeps its cache key, so no run rebuilds it."""
    from conftest import BENCH

    with open(os.path.join(BENCH, "configs", CONFIG + ".json")) as f:
        cfg = json.load(f)
    assert index_key(cfg) == "2beec2045c22"
    assert index_args(cfg) == ["-n", "1", "-f", "0.3", "--tpu-native",
                               "--native-block-targets", "131072"]
    off = dict(cfg, block_screen=False)
    assert index_key(off) == "2beec2045c22" and index_args(off) == \
        index_args(cfg)
    on = dict(cfg, block_screen=True)
    assert index_key(on) != "2beec2045c22"
    assert index_args(on)[-2:] == ["--block-screen", "--uniform-sigs"]


def test_a_new_configuration_file_and_entry_make_a_screened_cell(tmp_path):
    """A screened cell needs only a configuration file and an entry."""
    root = make_tree(str(tmp_path))
    add_cells(root, screened_config(), {"screened-half-se": "se"})
    cell = find_cell("screened-half-se", root)
    assert cell.config["name"] == NAME and cell.traffic["name"] == "se"
    assert cell.config["block_screen"]
    assert index_args(cell.config)[-2:] == ["--block-screen",
                                            "--uniform-sigs"]
    assert [m["name"] for m in cell.end_to_end] == [
        "device_ns_per_query", "setup_s"]


def test_union_sizing_is_the_index_s():
    from types import SimpleNamespace

    from kmcp_tpu_torch.index.build import (_union_screen_bits,
                                            _union_screen_fpr)

    for n in (0, 1, 17, 20_160, 162_000_000, 1_300_000_000):
        targets = [SimpleNamespace(kmers=n // 3), SimpleNamespace(
            kmers=n - n // 3)]
        m = _union_screen_bits(targets)
        assert union_bits(n) == m
        assert union_fpr(m, n) == _union_screen_fpr(m, targets)
    assert union_bits(1_300_000_000) == 2**33  # 4,096 GTDB targets


def test_set_bits_is_an_or():
    rng = np.random.default_rng(5)
    words = torch.zeros(64, dtype=torch.int32)
    want = np.zeros(64 * 32, dtype=bool)
    for _ in range(5):
        keys = rng.integers(0, 64 * 32, size=3000)
        want[keys] = True
        set_bits(words, torch.from_numpy(keys))
    got = np.unpackbits(words.numpy().view(np.uint8), bitorder="little")
    assert np.array_equal(got.astype(bool), want)


def test_reference_layout_equals_the_index(screened_db):
    """Blocks, lanes, rows, bits and union screens as ``index`` wrote
    them (the test reads the DB; the reference never does)."""
    from kmcp_tpu_torch.index.format import (read_block_bits,
                                             read_block_meta,
                                             read_block_union,
                                             read_db_info)

    cfg = screened_config()
    ref = Reference(cfg, genome_codes(cfg), "cpu")
    info = read_db_info(screened_db)
    assert len(info.blocks) == len(ref.blocks) == 3
    for b, blk in enumerate(ref.blocks):
        meta = read_block_meta(screened_db, b)
        assert meta.names == [f"g{g:05d}" for g in blk.genome]
        assert [i & 0xFFFF for i in meta.indices] == blk.chunk.tolist()
        assert meta.sizes == blk.sizes.tolist()
        bits = read_block_bits(screened_db, b, mmap=False)
        assert bits.shape == (ref.num_sigs, blk.words)
        assert np.array_equal(ref.table(blk).numpy().view(np.uint32),
                              bits.T)
        words, num_bits, fpr = read_block_union(screened_db, b)
        assert (num_bits, fpr) == (ref.union_bits, blk.fpr_u)
        u = ref.unions[blk.union_offset:blk.union_offset + num_bits // 32]
        assert np.array_equal(u.numpy().view(np.uint64), words)


@pytest.mark.parametrize("traffic", ["se", "pe", "host90-se"])
def test_screened_reference_rows_equal_the_host_backend(
        tmp_path, screened_db, traffic):
    cfg, tr = screened_config(), tiny_traffic(traffic)
    codes = genome_codes(cfg)
    pool = make_pool(tr, cfg, codes, 78, pool_size(tr, 0.125))
    paths = write_fastq(pool, str(tmp_path))
    got = host_rows(screened_db, paths, tr["paired"], str(tmp_path),
                    cfg["search"])
    queries = compare.sample_queries(pool, np.arange(pool.size))
    want = Reference(cfg, codes, "cpu").rows(queries)
    assert sum(len(r) for r in want) > pool.size // 20
    bad, examples = compare.mismatches(got, want, queries)
    assert bad == 0, examples


def band_pool(codes: np.ndarray, paired: bool) -> Pool:
    """25 bp reads whose first ``j`` bases, 21 to 25, come from a genome
    and the rest are random, so that the union hits of the genome's block
    fall below, at and above theta (pairs: a mate 2 of 20 random bases,
    which adds no k-mer)."""
    rng = np.random.default_rng(9)
    lengths = np.repeat(np.arange(21, 26), 200)
    n, rl = len(lengths), 25
    seq1 = rng.integers(0, 4, size=(n, rl), dtype=np.uint8)
    g = rng.integers(0, codes.shape[0], n)
    p = rng.integers(0, codes.shape[1] - rl, n)
    for i, (gi, pi, j) in enumerate(zip(g, p, lengths)):
        seq1[i, :j] = codes[gi, pi:pi + j]
    seq2 = rng.integers(0, 4, size=(n, 20), dtype=np.uint8) if paired \
        else None
    return Pool(ACGT[seq1], None if seq2 is None else ACGT[seq2],
                np.zeros(n, dtype=np.int8))


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_the_union_screen_decides_rows_at_its_band(tmp_path, screened_db,
                                                   paired):
    """Union hits at theta - 1, theta and theta + 1 for some block; rows
    equal to the host backend's, which they are not with the screens
    left out."""
    cfg = screened_config(BAND)
    codes = genome_codes(cfg)
    pool = band_pool(codes, paired)
    paths = write_fastq(pool, str(tmp_path))
    got = host_rows(screened_db, paths, paired, str(tmp_path),
                    cfg["search"])
    queries = compare.sample_queries(pool, np.arange(pool.size))
    ref = Reference(cfg, codes, "cpu")
    h, ok = ref._query_kmers(queries, True)
    n = ok.sum(1).numpy().astype(np.float64)
    over = set()
    for blk in ref.blocks:
        hits, theta = ref.screen(blk, h, ok, n)
        over |= set((hits - theta).astype(int).tolist())
    assert {-1, 0, 1} <= over
    want = ref.rows(queries)
    bad, examples = compare.mismatches(got, want, queries)
    assert bad == 0, examples
    ref.union_bits = 0
    unscreened, _ = compare.mismatches(got, ref.rows(queries), queries)
    assert unscreened > 0


def one_run(root, name, trace=False):
    return run(find_cell(name, root), SEED, 1.0, trace, "cpu",
               time.perf_counter())


@pytest.mark.parametrize("name", ["screened-se", "screened-pe"])
def test_a_screened_run_is_correct_on_the_screened_route(
        screened_root, screened_db, small_batches, name):
    out = one_run(screened_root, name)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["queries_differ"]["value"] == 0


def test_a_screened_run_traced_records_its_route(screened_root, screened_db,
                                                 small_batches, capsys,
                                                 monkeypatch):
    """A traced run logs the union table's packing and the window's
    route: every batch screened, and the active pairs of the window's
    batches alone, not of the warm-up's."""
    import ast
    import re

    from harness import window

    made = []
    searcher = window.TorchStreamSearcher
    monkeypatch.setattr(window, "TorchStreamSearcher", lambda *a: (
        made.append(searcher(*a)), made[-1])[1])
    out = one_run(screened_root, "screened-se", trace=True)
    assert out["correct"] is True
    err = capsys.readouterr().err
    pack = re.search(r"union table packed in ([0-9.]+) s", err)
    assert pack and float(pack.group(1)) > 0
    route = ast.literal_eval(re.search(r"\[bench\] route: (\{.*\})",
                                       err).group(1))
    assert route["screened_tail"] == route["batches"] > 0
    assert route["dense_tail"] == route["slow_rows"] == 0
    # the DB's counter also holds the warm-up's pairs
    assert 0 < route["active_pairs"] < int(made[0].dev.tail_stats["pairs"])


def test_a_db_without_union_screens_fails_the_route_check(tmp_path,
                                                          small_batches):
    """The screened configuration's DB built without --block-screen: the
    run raises before its window instead of measuring another route."""
    root = make_tree(str(tmp_path))
    cfg = screened_config()
    add_cells(root, cfg, {"screened-se": "se"})
    cache = os.path.join(root, "benchmark", ".cache")
    plain, _ = ensure_db(dict(cfg, block_screen=False), cache)
    shutil.move(plain, os.path.join(cache, "db-" + index_key(cfg)))
    with pytest.raises(RuntimeError, match="route check"):
        one_run(root, "screened-se")


def _pass2_counts_altered(monkeypatch):
    """K5' (its plain version) returns each count one higher."""
    from kmcp_tpu_torch.search import screen

    count = screen.pair_count

    def more(*args, **kwargs):
        counts, mask = count(*args, **kwargs)
        return counts + 1, mask
    monkeypatch.setattr(screen, "pair_count", more)


def _pass1_drops_a_block(monkeypatch):
    """Pass 1 lets no read through block 0's screen."""
    from kmcp_tpu_torch.search import screen

    mask = screen.active_mask

    def dropped(*args, **kwargs):
        active = mask(*args, **kwargs).clone()
        active[:, 0] = False
        return active
    monkeypatch.setattr(screen, "active_mask", dropped)


@pytest.mark.parametrize("fault", [_pass2_counts_altered,
                                   _pass1_drops_a_block])
def test_a_broken_screened_path_is_not_correct(screened_root, screened_db,
                                               small_batches, monkeypatch,
                                               fault):
    fault(monkeypatch)
    out = one_run(screened_root, "screened-se")
    assert out["correct"] is False
    assert out["checks"]["queries_differ"]["value"] > 0


@pytest.mark.parametrize("change,fault", [
    ({}, None),
    ({"on_card": False, "pass1_launches": 0, "pass2_launches": 0}, None),
    ({"screened_tail": 9}, "screened tails"),
    ({"dense_tail": 1}, "dense tails"),
    ({"slow_rows": 3}, "object engine"),
    ({"pass1_launches": 9}, "pass-1"),
    ({"pass2_launches": 0}, "pass-2")])
def test_the_route_check_after_the_window(change, fault):
    from harness.window import route_check

    route = {"batches": 10, "screened_tail": 10, "dense_tail": 0,
             "slow_rows": 0, "pass1_launches": 10, "pass2_launches": 12,
             "on_card": True}
    route.update(change)
    bad = route_check(route, route.pop("on_card"))
    assert (bad == []) if fault is None else (fault in "; ".join(bad))


@pytest.mark.parametrize("name,control", [
    ("screened-se", "forward_strand"), ("screened-pe", "forward_strand"),
    ("screened-pe", "counts_u8")])
def test_the_control_is_not_correct_on_a_screened_db(screened_root, name,
                                                      control):
    import limits

    for r in limits.readings(find_cell(name, screened_root), [3, 2**31 + 9],
                             [control], "cpu", 1.0):
        assert r["correct"] is False and r["queries_differ"] > 0
