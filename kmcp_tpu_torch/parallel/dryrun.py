"""Multi-rank dry run of the sharded search, held against the single-device
port and the host oracle.

Port of ``__graft_entry__.py`` ``dryrun_multichip`` (:217, with
``_build_db``, ``_make_reads``, ``_oracle_candidates``, ``_run_loc_config``,
``_run_fused_config`` and ``_run_screened_config``, :37-214).  The JAX dry
run is one process over a virtual device mesh; here every rank is a process
(``spawn``: ``torch.multiprocessing`` with the spawn start method, since a
CUDA process cannot fork), and the ranks join one process group.

For each mesh shape, (1, n), the default of ``sharding.make_mesh`` and
(4, n/4), the configurations of the JAX dry run run on every rank:

- se:    single-end reads, one hash, host locations (the "loc" step), from
         a budget of 8 that must overflow and retry at 4x;
- pe:    read pairs joined as one row (seq1 + N + seq2), one hash;
- h3:    a three-hash DB;
- fused: K1' hashes each rank's ``d`` slice on its device (reads with an N);
- scr:   the two-pass screened step on an 8-block ``--block-screen
         --uniform-sigs`` DB, host locations (where t divides 8).

Every rank's (meta, aux) must be byte-identical to the single-device
``TorchDeviceDB`` on the same batch, and its candidates equal to the host
oracle's (the numpy object engine).  One line a mesh is printed, in the
form of the JAX dry run's.

Usage (one process a rank; on the card, or ``--device cpu``):
    python -m kmcp_tpu_torch.parallel.dryrun --ranks 4 --device cuda \\
        --backend gloo
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

K = 21


# ------------------------------------------------------------ spawning

def spawn(fn, n_ranks: int, args=(), device=None, backend: str = "nccl",
          timeout_s: float = 600.0) -> list:
    """fn(rank, n_ranks, device, *args) in ``n_ranks`` spawned processes
    that have joined one process group (``init_distributed`` over a file
    store in a fresh directory); returns each rank's result, in rank
    order.  ``device`` is every rank's device (None: a card a rank).  The
    kernels are built here first, so the ranks do not race to build them.
    Raises if a rank fails, dies or does not finish within ``timeout_s``;
    every rank still running is then killed."""
    if device is None or torch.device(device).type == "cuda":
        from ..kernels._build import get_lib

        get_lib()
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="kmcp_ranks_")
    init = "file://" + os.path.join(tmp, "store")
    # the work goes through a file: a start() whose arguments overflow the
    # pipe would wait for that child to import torch before the next
    # child starts
    work = os.path.join(tmp, "work.pkl")
    with open(work, "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_ranks, init, backend, device, timeout_s,
                               work, q))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    results: dict = {}
    done = False
    try:
        deadline = time.time() + timeout_s
        while len(results) < n_ranks:
            try:
                rank, ok, out = q.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"ranks died: {dead}") from None
                if time.time() > deadline:
                    raise TimeoutError(
                        f"{n_ranks - len(results)} of {n_ranks} ranks did "
                        f"not finish within {timeout_s:.0f} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
        done = True
    finally:
        for p in procs:
            p.join(timeout=30 if done else 0)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(n_ranks)]


def _rank_main(rank, n_ranks, init, backend, device, timeout_s, work, q):
    import torch.distributed as dist

    from .distributed import init_distributed, rank_device

    try:
        with open(work, "rb") as f:
            fn, args = pickle.load(f)  # written by spawn() for this run
        init_distributed(init, n_ranks, rank, backend, device, timeout_s)
        q.put((rank, True, fn(rank, n_ranks, rank_device(device, rank),
                              *args)))
    except Exception:  # the parent reports it and stops the other ranks
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------------- rank work

def kernel_wrappers() -> dict:
    """The six kernel wrappers by name; each counts its own launches."""
    from ..search.count import count_mask
    from ..search.dedup import dedup_planes
    from ..search.device_step import DenseCompaction
    from ..search.group_count import group_count
    from ..search.hash_loc import hash_loc
    from ..search.pair_count import pair_count

    return {"hash_loc": hash_loc, "count_mask": count_mask,
            "pair_count": pair_count, "group_count": group_count,
            "compact": DenseCompaction, "dedup": dedup_planes}


@contextlib.contextmanager
def event_timed(acc: dict):
    """Bind the search path's kernel calls (K1' in device.py, K2' in the
    dense tail and screened pass 1, K5' and K6' in pass 2) to wrappers
    that record a CUDA event before and after each call; ``acc[name]``
    collects the (start, end) pairs."""
    from ..search import device, device_step, screen

    binds = [(device, "hash_loc"), (device_step, "count_mask"),
             (screen, "count_mask"), (screen, "pair_count"),
             (screen, "group_count")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in binds]

    def timed(name, fn):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            acc.setdefault(name, []).append((start, end))
            return out
        return call

    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_job(dev, kind: str, args: tuple) -> dict:
    """One search on a TorchDeviceDB, on a mesh or off one, with the
    streamer's 4x budget retry: "loc" (loc, nk, budget) ->
    ``search_async``, "reads" (reads uint8 [B, L], lens, budget, dedup) ->
    ``search_reads``, "screened" (loc, loc_u, nk, lens, budget) ->
    ``search_screened_sharded``.  Returns the last (meta, aux), the total
    the first call reported and the budget that held."""
    if kind == "reads":
        reads = torch.from_numpy(args[0]).to(dev.device)
        *rest, budget, dedup = args[1:]

        def call(b):
            return dev.search_reads(reads, rest[0], b, dedup)
    elif kind == "loc":
        *rest, budget = args

        def call(b):
            return dev.search_async(*rest, b).result()
    elif kind == "screened":
        *rest, budget = args

        def call(b):
            return dev.search_screened_sharded(*rest, b)
    else:
        raise ValueError(f"unknown job kind {kind!r}")
    meta, aux = call(budget)
    first = int(meta[0])
    while int(meta[0]) > budget:
        budget *= 4
        meta, aux = call(budget)
    return {"meta": meta, "aux": aux, "first_total": first,
            "budget": budget}


def step_job(mesh, device, bits: np.ndarray, loc: np.ndarray,
             mask: np.ndarray) -> dict:
    """``make_sharded_search_step`` on the rank's word shard of bits
    uint32 [S, W] (t | W) and its ``d`` slice of loc [B, K, h] / mask
    [B, K] -> the whole counts [B, 32 W] (``allgather_counts``),
    n_matched and best [B]."""
    from ..search.device_step import mesh_place
    from .distributed import allgather_counts, bits_to_global, \
        reads_to_global
    from .sharding import make_sharded_search_step

    _d, t_size, _di, t_index = mesh_place(mesh)
    W_t = bits.shape[1] // t_size
    shard = bits[:, t_index * W_t : (t_index + 1) * W_t]
    step = make_sharded_search_step(mesh, loc.shape[2])
    counts, n_matched, best = step(bits_to_global(shard, device),
                                   *reads_to_global(mesh, loc, mask, device))
    return {"counts": allgather_counts(counts, mesh),
            "n_matched": n_matched.cpu().numpy(),
            "best": best.cpu().numpy()}


def mesh_jobs(rank: int, world: int, device, dbs: dict, plan: list,
              timed: bool = False) -> dict:
    """A rank's part of a dry run: for each (mesh shape, jobs) of ``plan``
    a (d, t) mesh of the world, and each job (name, db key, pass2, kind,
    args) run through ``run_job`` on the rank's shard of ``dbs[key]``, or
    for kind "step" (db key None) through ``step_job``.  Returns
    {(shape, name): result} with, per job, the wall seconds, the kernels'
    launches and, with ``timed`` (a CUDA device), their summed CUDA-event
    milliseconds."""
    from ..search.device import TorchDeviceDB, numpy_state
    from ..search.engine import SearchEngine, SearchOptions
    from .sharding import make_mesh

    opt = SearchOptions()
    opened: dict = {}
    out: dict = {}
    kernels = kernel_wrappers()
    for shape, jobs in plan:
        mesh = make_mesh(world, shape[0], device=device)
        if tuple(mesh.shape) != tuple(shape):
            raise ValueError(f"mesh {tuple(mesh.shape)} is not {shape}")
        shards: dict = {}
        for name, key, pass2, kind, args in jobs:
            if kind == "step":
                out[tuple(shape), name] = step_job(mesh, device, *args)
                continue
            if key not in opened:
                db = SearchEngine([dbs[key]], opt).dbs[0]
                opened[key] = (numpy_state(db, opt), db.query_fpr)
            if (key, pass2) not in shards:
                state, fpr = opened[key]
                shards[key, pass2] = TorchDeviceDB.from_numpy_state(
                    state, opt, device, fpr, pass2, mesh=mesh)
            for k in kernels.values():
                k.launches = 0
            acc: dict = {}
            t0 = time.time()
            with event_timed(acc) if timed else contextlib.nullcontext():
                res = run_job(shards[key, pass2], kind, args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            res["wall"] = time.time() - t0
            res["launches"] = {n: k.launches for n, k in kernels.items()}
            res["kernel_ms"] = {
                n: sum(s.elapsed_time(e) for s, e in pairs)
                for n, pairs in acc.items()}
            out[tuple(shape), name] = res
    return out


# ------------------------------------------------------------ the dry run

def _build_db(tmp, rng, n_genomes, num_hashes, fpr, tag):
    """Tiny DB: n_genomes x 4 chunks (n_genomes*4 targets)."""
    from ..commands.compute import ComputeOptions, run_compute
    from ..index.build import run_index

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    files = []
    for g in range(n_genomes):
        seq = rng.choice(bases, size=20000).tobytes()
        path = os.path.join(tmp, f"{tag}_g{g}.fa")
        with open(path, "w") as f:
            f.write(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
        files.append(path)
    run_compute(out_dir=os.path.join(tmp, f"{tag}_ks"), files=files,
                opt=ComputeOptions(ks=[K], split_number=4,
                                   split_overlap=150),
                force=True, verbose=False)
    run_index(in_dir=os.path.join(tmp, f"{tag}_ks"),
              out_dir=os.path.join(tmp, f"{tag}_db"), num_hashes=num_hashes,
              fpr=fpr, force=True, tpu_native=True, verbose=False)
    return os.path.join(tmp, f"{tag}_db"), genomes


def _make_reads(rng, genomes, n, paired):
    """Mixed batch: normal reads, a too-short read, one with an N."""
    reads = []
    for i in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        if paired:
            p1 = int(rng.integers(0, len(g) - 150))
            p2 = int(rng.integers(0, len(g) - 150))
            reads.append((f"r{i}", g[p1 : p1 + 150], g[p2 : p2 + 150]))
        elif i % 29 == 7:
            reads.append((f"r{i}", g[:20], None))  # below min-query-len
        elif i % 31 == 3:
            p = int(rng.integers(0, len(g) - 150))
            s = bytearray(g[p : p + 150])
            s[75] = ord("N")  # breaks the rolling window mid-read
            reads.append((f"r{i}", bytes(s), None))
        else:
            p = int(rng.integers(0, len(g) - 150))
            reads.append((f"r{i}", g[p : p + 150], None))
    return reads


def _fused_reads(rng, genomes, n):
    reads = []
    for i in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        p = int(rng.integers(0, len(g) - 150))
        s = g[p : p + 150]
        if i % 17 == 5:  # an N the device hash itself must handle
            s = s[:40] + b"N" + s[41:]
        reads.append((f"f{i}", s, None))
    return reads


def host_loc(seqs, num_hashes: int, num_sigs: int, kmax: int = 0):
    """Reads hashed on the host -> (Bloom rows int32 [B, K, h], invalid
    windows at the sentinel num_sigs; valid k-mers [B])."""
    from ..kmer.nthash import hash_reads_batch
    from ..search.kernel import derive_locations

    H, M, counts = hash_reads_batch(seqs, K, k_max_pad=kmax)
    loc = derive_locations(H, num_hashes, num_sigs).astype(np.int32)
    loc[~M] = num_sigs
    return loc, counts


def read_matrix(seqs) -> tuple[np.ndarray, np.ndarray]:
    """Zero-padded ASCII rows uint8 [B, L] (L a multiple of 32, >= k + 31)
    and the lengths."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    L = max(-(-int(lens.max()) // 32) * 32, K + 31)
    mat = np.zeros((len(seqs), L), dtype=np.uint8)
    for i, s in enumerate(seqs):
        mat[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    return mat, lens


def candidates(res: dict, T: int) -> set:
    """(read, flat id read*T + target) of a (meta, aux) result, either
    layout."""
    meta = res["meta"]
    n = int(meta[0])
    budget = res["budget"]
    if meta.shape[0] == 1 + 2 * budget:
        q = meta[1 : 1 + n].astype(np.int64)
        t = meta[1 + budget : 1 + budget + n].astype(np.int64)
        return {(int(a), int(a * T + b)) for a, b in zip(q, t)}
    return {(int(i) // T, int(i)) for i in meta[1 : 1 + n]}


def oracle_candidates(engine, dev, reads) -> set:
    """The host engine's matches as (read, flat id) pairs."""
    name_to_t = {}
    for ti, (nm, ix) in enumerate(zip(dev.names, dev.indices)):
        if nm:
            name_to_t[(nm, int(ix) & 0xFFFF)] = ti
    T = dev.t_per_block * dev.n_blocks
    return {(qi, qi * T + name_to_t[(m.target, m.chunk_idx)])
            for qi, qr in enumerate(engine.search_batch(reads))
            for m in qr.matches}


def _plan(rng, genomes1, genomes3, n_ranks, s_geom):
    """Per mesh shape, the JAX dry run's jobs and the reads behind them."""
    base = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    shapes = {(1, n_ranks), (base, n_ranks // base)}
    if n_ranks % 4 == 0:
        shapes.add((4, n_ranks // 4))
    plan, reads_of = [], {}
    for d, t in sorted(shapes):
        B = max(64 * d, 128)  # hundreds of reads
        S1, S3, s_block, nbits = s_geom
        jobs = []
        se = _make_reads(rng, genomes1, B, paired=False)
        jobs.append(("se", "a", "auto", "loc",
                     (*host_loc([r[1] for r in se], 1, S1), 8)))
        pe = _make_reads(rng, genomes1, B // 2, paired=True)
        jobs.append(("pe", "a", "auto", "loc",
                     (*host_loc([r[1] + b"N" + r[2] for r in pe], 1, S1),
                      16 * (B // 2))))
        h3 = _make_reads(rng, genomes3, B, paired=False)
        jobs.append(("h3", "b", "auto", "loc",
                     (*host_loc([r[1] for r in h3], 3, S3), 16 * B)))
        fu = _fused_reads(rng, genomes1, B)
        jobs.append(("fused", "a", "auto", "reads",
                     (*read_matrix([r[1] for r in fu]), 16 * B, False)))
        reads_of.update({((d, t), "se"): se, ((d, t), "pe"): pe,
                         ((d, t), "h3"): h3, ((d, t), "fused"): fu})
        if 8 % t == 0:
            sc = _make_reads(rng, genomes1, B, paired=False)
            seqs = [r[1] for r in sc]
            kmax = max(len(s) for s in seqs) - K + 1
            loc, nk = host_loc(seqs, 1, s_block, kmax)
            loc_u, _ = host_loc(seqs, 1, nbits, kmax)
            lens = np.array([len(s) for s in seqs], dtype=np.int64)
            jobs.append(("scr", "s", "auto", "screened",
                         (loc[..., 0], loc_u[..., 0], nk, lens, 16 * B)))
            reads_of[(d, t), "scr"] = sc
        plan.append(((d, t), jobs))
    return plan, reads_of


def dryrun_multichip(n_ranks: int = 4, device=None, backend: str = "nccl",
                     timeout_s: float = 900.0, seed: int = 3) -> list[str]:
    """The dry run: DBs and reads made here from ``seed``, the ranks
    spawned (``device`` and ``backend`` as ``spawn`` takes them), every
    rank's result held against the single-device port on this process's
    ``device`` and against the host oracle.  Returns the lines printed."""
    from ..index.build import run_index
    from ..index.format import read_block_union
    from ..search.device import TorchDeviceDB, numpy_state, pad_words
    from ..search.engine import SearchEngine, SearchOptions
    from .distributed import rank_device

    rng = np.random.default_rng(seed)
    tmp = tempfile.mkdtemp(prefix="kmcp_dryrun_")
    try:
        # DB a: 10 genomes x 4 chunks = 40 targets, 2 words: t = 4 pads
        # the word axis 2 -> 4
        db1, genomes1 = _build_db(tmp, rng, 10, 1, 0.3, "a")
        db3, genomes3 = _build_db(tmp, rng, 6, 3, 0.01, "b")
        # DB s: a's 40 targets as 8 screened blocks of 5 (t = 1, 2, 4, 8)
        dbs_dir = os.path.join(tmp, "a_db_screened")
        run_index(in_dir=os.path.join(tmp, "a_ks"), out_dir=dbs_dir,
                  num_hashes=1, fpr=0.3, force=True, tpu_native=True,
                  native_block_targets=5, block_screen=True,
                  uniform_sigs=True, verbose=False)
        dbs = {"a": db1, "b": db3, "s": dbs_dir}
        opt = SearchOptions()
        engines = {k: SearchEngine([p], opt) for k, p in dbs.items()}
        here = rank_device(device, 0)
        states = {k: numpy_state(e.dbs[0], opt) for k, e in engines.items()}
        single: dict = {}

        def single_dev(key, t):
            """The single-device DB in the layout of t target shards."""
            if (key, t) not in single:
                single[key, t] = TorchDeviceDB.from_numpy_state(
                    pad_words(states[key], t) if key != "s" else states[key],
                    opt, here, engines[key].dbs[0].query_fpr)
            return single[key, t]

        geom = (single_dev("a", 1).total_rows, single_dev("b", 1).total_rows,
                single_dev("s", 1).s_block,
                int(read_block_union(dbs_dir, 0)[1]))
        plan, reads_of = _plan(rng, genomes1, genomes3, n_ranks, geom)
        ranks = spawn(mesh_jobs, n_ranks, (dbs, plan), device, backend,
                      timeout_s)
        lines = []
        for shape, jobs in plan:
            n_cand = {}
            for name, key, _pass2, kind, args in jobs:
                dev = single_dev(key, shape[1])
                want = run_job(dev, kind, args)
                for r, got in enumerate(ranks):
                    g = got[shape, name]
                    same = (np.array_equal(g["meta"], want["meta"])
                            and np.array_equal(g["aux"], want["aux"])
                            and g["first_total"] == want["first_total"])
                    if not same:
                        raise AssertionError(
                            f"mesh{shape} {name}: rank {r}'s (meta, aux) "
                            "differs from the single-device run")
                T = dev.t_per_block * dev.n_blocks
                got = candidates(ranks[0][shape, name], T)
                oracle = oracle_candidates(engines[key], dev,
                                           reads_of[shape, name])
                if got != oracle:
                    raise AssertionError(
                        f"mesh{shape} {name}: {len(got)} candidates, the "
                        f"host oracle {len(oracle)}")
                n_cand[name] = int(ranks[0][shape, name]["meta"][0])
            if ranks[0][shape, "se"]["first_total"] <= 8:
                raise AssertionError("the budget overflow was not exercised")
            d, t = shape
            lines.append(
                f"mesh(d={d},t={t}): se={n_cand['se']} pe={n_cand['pe']} "
                f"h3={n_cand['h3']} fused={n_cand['fused']} "
                f"scr={n_cand.get('scr', -1)}")
            print(lines[-1], flush=True)
        print(f"dryrun_multichip OK ({n_ranks} ranks, {backend}, "
              f"ranks on {device or 'a card each'})", flush=True)
        return lines
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="every rank's device (default: a card a rank)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--timeout", type=float, default=900.0)
    a = ap.parse_args(argv)
    dryrun_multichip(a.ranks, a.device, a.backend, a.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
