"""Multi-device search (ROADMAP A9) on the CPU: the port's sharded steps on
gloo ranks (spawned processes, a file store in tmp_path) against the JAX
package's mesh steps on the conftest's virtual 8-device CPU mesh, on the
same seeded inputs, and against the port's own single-device tails.

Meshes (1, 2), (2, 2), (1, 4) and (4, 1): one spawn of 2 ranks and one of
4, each running every mesh of its world and several configurations a mesh
(``kmcp_tpu_torch.parallel.dryrun.mesh_jobs``):
- the dense loc step (host locations) at h = 1 and h = 3, B not divisible
  by d, and a budget of 8 that overflows;
- the fused step (K1''s plain version per rank), single-end and paired
  with the in-step dedup;
- the screened step on the recipe of test_index_search.py:1288 (4 blocks,
  B = 90) through K5' and K6' (plain versions);
- ``make_sharded_search_step`` with tied maxima across shards.
The JAX package's layout errors, ``make_mesh`` with too few cards and
nccl on the CPU are checked in process."""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kmcp_tpu.parallel.sharding import (
    make_sharded_search_step as jax_sharded_step,
)
from kmcp_tpu.search.device import DeviceDB
from kmcp_tpu.search.engine import SearchEngine, SearchOptions
from kmcp_tpu_torch.parallel import distributed as D
from kmcp_tpu_torch.parallel.dryrun import (
    host_loc,
    mesh_jobs,
    read_matrix,
    run_job,
    spawn,
)
from kmcp_tpu_torch.parallel.sharding import make_mesh
from kmcp_tpu_torch.search import engine as port_engine
from kmcp_tpu_torch.search.device import (
    TorchDeviceDB,
    check_mesh_db,
    numpy_state,
    pad_words,
)

from .test_torch_stream import build_db, random_genomes

torch.set_num_threads(1)

MESHES = [(1, 2), (2, 2), (1, 4), (4, 1)]
B_LOC = 93  # not divisible by d = 2 or 4
B_SCR = 90  # test_index_search.py:1288's batch


def _mesh(shape):
    d, t = shape
    return Mesh(np.array(jax.devices()[: d * t]).reshape(d, t), ("d", "t"))


def _reads(rng, genomes, n, length=150):
    out = []
    for i in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        if i % 13 == 4:
            out.append(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                  size=length).tobytes())  # junk
            continue
        p = int(rng.integers(0, len(g) - length))
        s = g[p : p + length]
        if i % 11 == 3:
            s = s[:70] + b"N" + s[71:]
        out.append(s)
    return out


def _pairs(rng, genomes, n):
    """Joined rows seq1 + N + seq2, mate 2 overlapping mate 1 in every
    third pair (over 256 windows with duplicates: the in-step dedup)."""
    rows, lens = [], []
    for i in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        p1 = int(rng.integers(0, len(g) - 400))
        p2 = p1 + 40 if i % 3 == 0 else int(rng.integers(0, len(g) - 150))
        m1, m2 = g[p1 : p1 + 150], g[p2 : p2 + 150]
        rows.append(m1 + b"N" + m2)
        lens.append(150)
    mat, _ = read_matrix(rows)
    return mat, np.array(lens, dtype=np.int64)


def _step_inputs(rng, t):
    """Bits [S, 8] with word 1 copied to word 5 (the same targets in shard
    0 and in shard 1 at t = 2, shard 2 at t = 4): tied maxima across
    shards."""
    S, W, B, K = 509, 8, 64, 90
    bits = (rng.integers(0, 2**32, (S, W), dtype=np.uint32)
            | rng.integers(0, 2**32, (S, W), dtype=np.uint32))
    bits[:, 5] = bits[:, 1]
    loc = rng.integers(0, S, (B, K, 1)).astype(np.int32)
    mask = rng.random((B, K)) < 0.9
    return bits, loc, mask


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """DBs, inputs, the JAX results on every mesh and the port's ranks'."""
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(29)
    genomes = random_genomes(rng, 10, 20000)
    dbs = {
        "a": build_db(tmp / "a", genomes, split_number=4),  # 40 targets
        "b": build_db(tmp / "b", genomes[:6], num_hashes=3, split_number=4),
    }
    sizes = [30000, 42000, 36000, 30000]
    sgen = [rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n).tobytes()
            for n in sizes]
    dbs["s"] = build_db(tmp / "s", sgen, split_number=4,
                        native_block_targets=4, block_screen=True,
                        uniform_sigs=True)
    opt = SearchOptions(backend="jax")
    jdb = {k: SearchEngine([p], opt).dbs[0] for k, p in dbs.items()}
    popt = port_engine.SearchOptions()
    pdb = {k: port_engine.SearchEngine([p], popt).dbs[0]
           for k, p in dbs.items()}
    states = {k: numpy_state(db, popt) for k, db in pdb.items()}
    S = {k: states[k]["bits_ext"].shape[0] - 1 for k in ("a", "b")}
    s_block = states["s"]["screen"]["s_block"]
    nbits = states["s"]["screen"]["num_bits"]

    jobs, jax_out, inputs = {}, {}, {}
    for shape in MESHES:
        mesh = _mesh(shape)
        J = {}
        seqs = _reads(rng, genomes, B_LOC)
        loc1, nk1 = host_loc(seqs, 1, S["a"])
        loc3, nk3 = host_loc(_reads(rng, genomes[:6], B_LOC), 3, S["b"])
        mat, lens = read_matrix(seqs)
        pmat, plens = _pairs(rng, genomes, 41)
        sseq = _reads(rng, sgen, B_SCR)
        kmax = max(len(s) for s in sseq) - 20
        sloc, snk = host_loc(sseq, 1, s_block, kmax)
        sloc_u, _ = host_loc(sseq, 1, nbits, kmax)
        slens = np.array([len(s) for s in sseq], dtype=np.int64)
        step_in = _step_inputs(rng, shape[1])
        jobs[shape] = [
            ("h1", "a", "auto", "loc", (loc1, nk1, 16 * B_LOC)),
            ("h3", "b", "auto", "loc", (loc3, nk3, 16 * B_LOC)),
            ("over", "a", "auto", "loc", (loc1, nk1, 8)),
            ("fused", "a", "auto", "reads", (mat, lens, 16 * B_LOC, False)),
            ("paired", "a", "auto", "reads", (pmat, plens, 16 * 41, True)),
            ("scr_pair", "s", "pair", "screened",
             (sloc[..., 0], sloc_u[..., 0], snk, slens, 8 * B_SCR)),
            ("scr_gemm", "s", "gemm", "screened",
             (sloc[..., 0], sloc_u[..., 0], snk, slens, 8 * B_SCR)),
            ("step", None, None, "step", step_in),
        ]
        dev = {k: DeviceDB(jdb[k], opt, mesh=mesh) for k in jdb}
        J["h1"] = np.asarray(dev["a"].search_async(loc1, nk1, 16 * B_LOC))
        J["h3"] = np.asarray(dev["b"].search_async(
            loc3.reshape(B_LOC, -1, 3), nk3, 16 * B_LOC))
        J["over"] = np.asarray(dev["a"].search_async(loc1, nk1, 8))
        J["scr"] = np.asarray(dev["s"].search_screened_sharded(
            sloc[..., 0], sloc_u[..., 0], snk, slens, 8 * B_SCR))
        if shape in ((1, 2), (2, 2)):  # the XLA hash step compiles slowly
            J["fused"] = np.asarray(dev["a"].search_reads_async(
                mat, lens, 16 * B_LOC))
            J["paired"] = np.asarray(dev["a"].search_reads_async(
                pmat, plens, 16 * 41, paired_dedup=True))
        bits, loc, mask = step_in
        J["step"] = [np.asarray(x) for x in jax_sharded_step(mesh, 1)(
            bits, loc, mask)]
        jax_out[shape] = J
        inputs[shape] = {name: (key, pass2, kind, args)
                         for name, key, pass2, kind, args in jobs[shape]}

    ranks = {}
    for world_size in (2, 4):
        plan = [(s, jobs[s]) for s in MESHES if s[0] * s[1] == world_size]
        res = spawn(mesh_jobs, world_size, (dbs, plan), "cpu", "gloo",
                    timeout_s=240)
        for shape, _ in plan:
            ranks[shape] = [{name: r[shape, name] for name in inputs[shape]}
                            for r in res]
    return {"states": states, "pdb": pdb, "popt": popt, "jax": jax_out,
            "ranks": ranks, "inputs": inputs, "dbs": dbs}


def _single(world, key, t, pass2="auto"):
    """The port's single-device DB in the layout of t target shards."""
    state = world["states"][key]
    if key != "s":
        state = pad_words(state, t)
    return TorchDeviceDB.from_numpy_state(
        state, world["popt"], "cpu", world["pdb"][key].query_fpr, pass2)


def _same_on_every_rank(world, shape, name, want):
    for r, got in enumerate(world["ranks"][shape]):
        g = got[name]
        assert np.array_equal(g["meta"], want["meta"]), (r, name)
        assert np.array_equal(g["aux"], want["aux"]), (r, name)
        assert g["first_total"] == want["first_total"], (r, name)


def _legacy(arr, budget):
    """JAX's [n, idx * C, cnt * C, (nk...)] -> (n, idx[:n], cnt[:n], nk)."""
    n = int(arr[0])
    return (n, arr[1 : 1 + n], arr[1 + budget : 1 + budget + n],
            arr[1 + 2 * budget :])


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_dense_loc_matches_jax(world, shape):
    """h = 1 and h = 3: JAX's candidates and counts, and the port's
    single-device count_tail byte for byte, on every rank."""
    for name in ("h1", "h3"):
        key, _p, kind, args = world["inputs"][shape][name]
        want = run_job(_single(world, key, shape[1]), kind, args)
        _same_on_every_rank(world, shape, name, want)
        budget = args[-1]
        n, idx, cnt, _nk = _legacy(world["jax"][shape][name], budget)
        meta, aux = want["meta"], want["aux"]
        assert n == int(meta[0]) > 0 and n <= budget
        np.testing.assert_array_equal(meta[1 : 1 + n], idx)
        np.testing.assert_array_equal(aux[:n], cnt)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_budget_overflow_reports_jax_total(world, shape):
    key, _p, kind, args = world["inputs"][shape]["over"]
    got = world["ranks"][shape][0]["over"]
    jax_total = int(world["jax"][shape]["over"][0])
    assert got["first_total"] == jax_total > 8
    want = run_job(_single(world, key, shape[1]), kind, args)
    _same_on_every_rank(world, shape, "over", want)
    h1 = world["ranks"][shape][0]["h1"]  # the retry lands on h1's bytes
    n = int(h1["meta"][0])
    np.testing.assert_array_equal(got["meta"][1 : 1 + n],
                                  h1["meta"][1 : 1 + n])


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_screened_matches_jax(world, shape):
    """K5' and K6' routes: JAX's candidates, counts and nk, and the port's
    single-device screened_tail byte for byte."""
    T = world["states"]["s"]["bits_ext"].shape[1] * 32 * 4
    for name, pass2 in (("scr_pair", "pair"), ("scr_gemm", "gemm")):
        key, _p, kind, args = world["inputs"][shape][name]
        want = run_job(_single(world, key, 1, pass2), kind, args)
        _same_on_every_rank(world, shape, name, want)
        budget = args[-1]
        n, idx, cnt, nk = _legacy(world["jax"][shape]["scr"], budget)
        meta, aux = want["meta"], want["aux"]
        assert n == int(meta[0]) > 0 and n <= budget
        flat = (meta[1 : 1 + n].astype(np.int64) * T
                + meta[1 + budget : 1 + budget + n])
        np.testing.assert_array_equal(flat, idx)
        np.testing.assert_array_equal(aux[:n], cnt)
        np.testing.assert_array_equal(aux[budget:], nk[:B_SCR])


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_fused_matches_jax(world, shape):
    """K1' on each rank's d slice, single-end and paired (in-step dedup):
    the port's single-device search_reads byte for byte, and JAX's
    candidates, counts and nk where the JAX step ran."""
    for name in ("fused", "paired"):
        key, _p, kind, args = world["inputs"][shape][name]
        want = run_job(_single(world, key, shape[1]), kind, args)
        _same_on_every_rank(world, shape, name, want)
        assert int(want["meta"][0]) > 0
        if name not in world["jax"][shape]:
            continue
        budget, B = args[2], args[0].shape[0]
        n, idx, cnt, nk = _legacy(world["jax"][shape][name], budget)
        meta, aux = want["meta"], want["aux"]
        assert n == int(meta[0]) and n <= budget
        np.testing.assert_array_equal(meta[1 : 1 + n], idx)
        np.testing.assert_array_equal(aux[:n], cnt)
        np.testing.assert_array_equal(aux[budget:], nk[:B])
    # rows of 260 windows: overlapping mates uniqued to 170, the others
    # over the threshold with none to drop
    paired = world["ranks"][shape][0]["paired"]
    nk_p = paired["aux"][paired["budget"]:].astype(np.int64)
    assert (nk_p == 170).any() and (nk_p == 260).any()


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_sharded_search_step_matches_jax(world, shape):
    counts, n_matched, best = world["jax"][shape]["step"]
    for got in world["ranks"][shape]:
        g = got["step"]
        np.testing.assert_array_equal(g["counts"], counts)
        np.testing.assert_array_equal(g["n_matched"], n_matched)
        np.testing.assert_array_equal(g["best"], best)
    # the seeded inputs hold reads whose maximum ties across shards
    W_t = 8 // shape[1]
    w_best = best // 32
    twin = np.where(w_best == 1, best + 4 * 32, best)
    tied = (w_best == 1) & (counts[np.arange(len(best)), twin]
                            == counts.max(axis=1))
    if shape[1] > 1 and 5 // W_t != 1 // W_t:
        assert tied.any()


def test_mesh_layout_errors_match_jax(tmp_path):
    """The JAX messages: blocks of unequal geometry, blocks that do not
    divide t, a multi-block DB without the screen."""
    rng = np.random.default_rng(5)
    genomes = [rng.choice(np.frombuffer(b"ACGT", np.uint8),
                          size=n).tobytes() for n in (20000, 60000, 30000,
                                                      45000)]
    cases = {
        "geometry": (build_db(tmp_path / "g", genomes, split_number=4,
                              native_block_targets=4), 2),
        "divide": (build_db(tmp_path / "d", genomes, split_number=4,
                            native_block_targets=4, block_screen=True,
                            uniform_sigs=True), 3),
        "screen": (build_db(tmp_path / "s", genomes, split_number=4,
                            native_block_targets=4, uniform_sigs=True), 2),
    }
    opt = SearchOptions(backend="jax")
    for name, (path, t) in cases.items():
        db = SearchEngine([path], opt).dbs[0]
        pdb = port_engine.SearchEngine([path],
                                       port_engine.SearchOptions()).dbs[0]
        assert len(db.blocks) == 4, name
        with pytest.raises(ValueError) as jerr:
            DeviceDB(db, opt, mesh=_mesh((1, t)))
        with pytest.raises(ValueError) as perr:
            check_mesh_db(pdb, t)
        assert str(perr.value) == str(jerr.value), name


def test_make_mesh_and_backend_refusals(tmp_path):
    """make_mesh without a card a rank raises (no CPU fall-back); nccl on
    the CPU raises before any rendezvous."""
    with pytest.raises(ValueError, match="nccl"):
        D.init_distributed(f"file://{tmp_path}/nccl", 1, 0, "nccl", "cpu")
    D.init_distributed(f"file://{tmp_path}/gloo", 1, 0, "gloo", "cpu")
    try:
        if torch.cuda.device_count() == 0:
            with pytest.raises(RuntimeError, match="CUDA cards"):
                make_mesh()
        mesh = make_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("d", "t")
    finally:
        torch.distributed.destroy_process_group()
    assert not os.path.exists(f"{tmp_path}/nccl")
