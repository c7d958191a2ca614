#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kmcp_tpu_torch) on one GPU.

Drives the port's main paths, single-end streaming search over a
single-block DB and over a multi-block ``--block-screen --uniform-sigs`` DB
(the two-pass screened search), read pairs, sketch DBs and the searches
the object engine runs, through the entry points a user calls
(``python -m kmcp_tpu_torch compute / index`` to build the DBs, then
``kmcp_tpu_torch.commands.search.run_search``), and the search TSVs
through ``merge`` and ``profile``.  Every input is made here
from fixed seeds; nothing outside the checkout is read, and nothing of JAX
or of the JAX package is imported here.

Phases (each prints its status lines and its wall seconds; any failure
raises, exit non-zero):
  1. device: a CUDA card, its name and power limit (nvidia-smi);
  2. build: nvcc builds the CUDA kernels from kmcp_tpu_torch/csrc/;
  3. kernels: K1' hash_loc (also with the screen plane, and at the paired
     shape with the screen and value planes) and K2' count_mask on the card
     at the main paths' shapes (wide, narrow, and screened pass 1 over a
     2^25-row union table), and the screened pass-2 kernels K5' pair_count
     and K6' group_count at 32 and 128 blocks of 4,096 targets (random bits,
     3,578 rows per block, 20,480 and 36,864 pairs of a 16,384-read batch),
     each exactly equal to its plain PyTorch version (K6' also to K5''s
     counts and mask); CUDA event times, median of 5 after a warm-up, of the
     kernels (their block sort included), the plain versions and each
     pass-2 route as the tail runs it (kernel + compaction); each kernel's
     bound (``bound``) from this run's inputs; and for K6' the one PyTorch
     call that computes the same grouped product (``torch._grouped_mm`` in
     bf16), timed as a yardstick and used nowhere in the port;
  4. main path: a 131,072-target single-block wide DB (2,048 synthetic
     genomes x 64 chunks, k=21, one hash, FPR 0.3; the recipe of
     tools/bench_large_t.py) and 65,536 150 bp reads (40 source genomes,
     10% random junk).  The TSV of the port on the card must be
     byte-identical to the same path run with the kernels bound to their
     plain PyTorch versions on the card (the CPU run of the plain versions
     would take about half an hour at this width), both kernels must have
     launched, and every read drawn from a DB genome must have that genome
     as its best hit; then a rerun with stage timers (a synchronised host
     clock) gives the time by stage and the steady rate;
  5. the same on a narrow-row DB (150 targets of 680 kb, W = 5 words,
     three hashes, about 1.85 M Bloom rows: the demo DB's shape), held
     byte for byte against the port's ``--device cpu`` run, which the CPU
     tests hold byte-identical to ``kmcp_tpu search --backend host``;
  6. the screened main path: phase 4's 2,048 x 64 chunks indexed again with
     ``--tpu-native --block-screen --uniform-sigs`` (32 blocks of 4,096
     targets with union screens), the same 65,536 reads searched on the
     card with pass2="gemm", "pair" and "auto" (``screen.pass2_kernel``);
     every TSV byte-identical to the run with the kernels bound to their
     plain versions on the card (pass2="pair"), every source read best-hits
     its genome, hash_loc and count_mask (pass 1) launch in every run,
     group_count only where the run's pass-2 kernel is "gemm" and
     pair_count only where it is "pair", and no read takes the object
     engine; then a rerun of the gemm and pair runs with stage timers (a
     synchronised host clock) gives the time by stage;
  7. paired reads: 65,536 pairs from phase 4's 40 source genomes (mate 1
     150 bp of a genome chunk, mate 2 the reverse complement of the 150 bp
     starting 200 bp downstream, in the same chunk; 10% of the pairs with a
     random junk mate 2), searched with ``run_search(read1=, read2=)`` on
     phase 4's one-block DB (the dense tail: K1' with the value plane, the
     in-step dedup of the 260-window joined rows, K2') and on phase 6's
     screened DB with pass2="auto" (K1' with the screen and value planes,
     the dedup, K2' pass 1, K5'); each TSV byte-identical to the run with
     the kernels bound to their plain versions on the card, every source
     pair best-hits its genome, K1' and K2' launch in both runs, K5' in the
     screened run only, no pair takes the object engine; then a stage-timed
     rerun of each gives the steady pairs/s, the dedup as a stage of its
     own;
  8. device sketch selection: a minimizer (``compute -W 5``) and a
     closed-syncmer (``-S 11``) DB of 256 of phase 4's genome files (its 40
     source genomes among them) x 64 chunks, k = 21, one block of 16,384
     targets (``-n 1 -f 0.3 --tpu-native``); phase 4's reads stream
     through K1' at k with the value plane (and at k = s for syncmers), the
     window selection and the dense tail; each TSV byte-identical to the
     run with the kernels bound to their plain versions on the card, K1'
     launched once a batch (twice for syncmers; 4 batches, and once more
     for each batch the 4x candidate-budget retry re-runs), K2' launched,
     no read through the object engine; the share of source reads that
     best-hit their genome is printed, not gated; then a stage-timed
     rerun;
  9. the object engine on the card (its counter launches K2'): ``-g -t
     0.15 -s jacc`` on a DB of 256 of phase 4's genomes, one target each
     (``-n 3 -f 0.01``), six queries of one genome (each best-hits itself
     with jacc 1.0000) and two of five genomes (past 262,144 k-mers);
     4,096 of phase 4's reads with ``-s jacc`` on phase 4's DB, the same
     reads on phase 4's and phase 6's DBs at once (a directory of links to
     both), and 4,096 of phase 7's pairs with ``--try-se`` on phase 4's
     DB; each TSV byte-identical to the run with the kernels bound to their
     plain versions on the card, the route "engine", K2' launched; then a
     stage-timed rerun of each (host hashing, locations, K2', the D2H of
     the counts, host extraction, writer);
 10. the pipeline from the card's TSVs: phase 4's single-end TSV and phase
     7's paired dense TSV through the port's ``profile`` and ``merge`` (the
     command line's entry point, in process), with a taxdump written here
     (256 genera of 8 species, one species per genome) and its taxid.map:
     (a) ``profile -m 1 -T -X -C -M -B`` of each TSV: all 40 source genomes
     in the profile, genomes outside them at most 0.1% in all, the CAMI
     report's percentages at most 100.01 at every rank with the genus total
     equal to the species total within 0.01, at least 99% of the source
     reads binned to their genome's taxid and at most 1% of the junk reads
     binned at all (of the junk pairs, whose mate 1 is from a source
     genome, at most 1% binned outside the 40 source genomes) (mode 1, KMCP's "higher recall" preset: phase 4 gives a
     genome ~23 reads a chunk, under mode 3's 50); (b) ``--low-mem`` with
     KMCP_TPU_PARSE_CHUNK = 1 MiB, its reports byte-identical to (a)'s;
     (c) phase 4's TSV split into two shard TSVs by target (g00000-g01023
     and g01024-g02047, each with its own '#' stat lines), merged back by
     ``merge``: the rows of the unsplit TSV as a multiset (hits included),
     descending qCov within each query, and the merged TSV's profile,
     reports and binning byte-identical to (a)'s; host seconds by stage
     (parse, profile stages 1-3, the four stages + EM, writers, binning,
     merge), with the card's name and power limit.  Phase 10 launches no
     kernel.
Every main-path run sets all four kernels' launch counts to 0 just before
it and reads them just after.
Then one JSON line of kernel results, the card's name and power limit, and
the last line ``{"ok": true, "device": {...}}``.

Usage (from the repository root; one CUDA card):  python3 chip_smoke.py
Scratch data goes to .smoke/ under the checkout (gitignored).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, ".smoke")
K = 21
READ_LEN = 150
N_READS = 65_536
WIDE_GENOMES, WIDE_CHUNKS = 2048, 64  # 131,072 targets of ~1 kb
NARROW_GENOMES, NARROW_CHUNKS = 15, 10  # 150 targets of 680 kb
SCREEN_SIGS = 1 << 25  # a union screen's rows in phase 3 (phase 6's DB has as many)
PASS2_CASES = ((32, 20_480), (128, 36_864))  # (blocks, pairs) in phase 3
BLOCK_TARGETS = 4096  # targets per block of phase 6's screened DB
SKETCH_GENOMES = 256  # phase 8: 16,384 targets, K2''s wide-row variant
GENOME_DB_GENOMES = 256  # phase 9's -g DB, one target a genome
ENGINE_READS = 4096  # phase 9's reads and pairs through the object engine
GENOME_KMERS = 262_144  # the JAX package's genome-scale query threshold


# One NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): HBM rate and
# the tensor-core rates in bf16 and int8.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12


def log(msg: str):
    print(f"[smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 5) -> float:
    """Median CUDA-event time of fn() after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(torch, fn, n: int = 20, reps: int = 5) -> float:
    """Device ms per launch of fn(): n calls captured in a CUDA graph (after
    one call outside it), replayed between CUDA events, median of reps.  For
    a kernel of tens of microseconds the time of one call (``time_ms``)
    also holds the host's enqueue of the launch, while the card waits."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return time_ms(torch, g.replay, reps) / n


def bound(nbytes: float, flops: float = 0.0,
          rate: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for work
    that moves ``nbytes`` (each input read once, each output written once)
    and does ``flops`` tensor-core operations at ``rate`` a second; the
    larger of the two times, and which of them it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_err(torch, got, want) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{got.shape}/{got.dtype} vs {want.shape}/"
                             f"{want.dtype}")
    return int((got.long() - want.long()).abs().max())


def random_reads(rng, n: int, lmax: int) -> np.ndarray:
    """[n, lmax] zero-padded ASCII reads: ACGT with lowercase and N, one in
    eight shorter than 150 bp."""
    alphabet = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
    p = [0.125] * 4 + [0.1235] * 4 + [0.006]
    mat = rng.choice(alphabet, size=(n, lmax), p=p).astype(np.uint8)
    lens = np.where(rng.random(n) < 0.125, rng.integers(0, READ_LEN, n),
                    READ_LEN)
    mat[np.arange(lmax)[None, :] >= lens[:, None]] = 0
    return mat


def random_pairs(rng, n: int, lmax: int) -> np.ndarray:
    """[n, lmax] zero-padded joined pair rows mate1 + N + mate2, the mates
    as ``random_reads`` makes them (one in eight mates shorter)."""
    m1, m2 = random_reads(rng, n, READ_LEN), random_reads(rng, n, READ_LEN)
    out = np.zeros((n, lmax), dtype=np.uint8)
    for i in range(n):
        a = m1[i][m1[i] != 0].tobytes()
        b = m2[i][m2[i] != 0].tobytes()
        row = a + b"N" + b if b else a
        out[i, : len(row)] = np.frombuffer(row, np.uint8)
    return out


def random_bits(rng, rows: int, words: int, ands: int, ors: int):
    """[rows + 1, words] uint32 Bloom rows with a zero sentinel row last;
    density set by ANDing / ORing uniform words."""
    out = rng.integers(0, 2**32, (rows + 1, words), dtype=np.uint32)
    for _ in range(ands):
        out &= rng.integers(0, 2**32, (rows + 1, words), dtype=np.uint32)
    for _ in range(ors):
        out |= rng.integers(0, 2**32, (rows + 1, words), dtype=np.uint32)
    out[-1] = 0
    return out


def phase_kernels(torch, dev) -> dict:
    """Phase 3: each kernel against its plain version, at the shapes the
    main path gives it (a 16,384-read batch of 150 bp reads in lmax=160
    rows; K2' gets the read chunk the count tail launches it on, and pass
    1's batch over the union table).  The bounds count only the Bloom rows
    this run's locations touch."""
    from kmcp_tpu_torch.search.device_step import COUNTS_BYTES, FLOOR_NEVER
    from kmcp_tpu_torch.search.hash_loc import hash_loc, hash_loc_plain

    rng = np.random.default_rng(2024)
    B, lmax = 16_384, 160
    reads = torch.from_numpy(random_reads(rng, B, lmax)).to(dev)
    full = (1 << 64) - 1
    res = {"hash_loc": [], "count_mask": []}
    cases = [
        # (label, S, h, W, bits density ANDs/ORs, floor base)
        ("wide S=3578 h=1 W=4096", 3578, 1, 4096, (1, 0), 38),
        ("narrow S=1850000 h=3 W=5", 1_850_000, 3, 5, (0, 1), 45),
    ]
    for label, S, h, W, (ands, ors), base in cases:
        loc, nk = hash_loc(reads, K, S, full, h)
        loc_p, nk_p = hash_loc_plain(reads, K, S, full, h)
        torch.cuda.synchronize()
        err = max(max_abs_err(torch, loc, loc_p), max_abs_err(torch, nk, nk_p))
        if err:
            raise AssertionError(f"hash_loc {label}: max abs err {err}")
        res["hash_loc"].append(time_hash_loc(
            torch, label, (reads, K, S, full, h), (loc, nk)))

        T = 32 * W
        Bc = min(B, max(1, COUNTS_BYTES // (4 * T)))
        bits = torch.from_numpy(
            random_bits(rng, S, W, ands, ors).view(np.int32)
        ).to(dev)
        thr_np = rng.integers(1, 10, T).astype(np.int32)
        thr_np[-7:] = FLOOR_NEVER  # padding lanes
        thr = torch.from_numpy(thr_np).to(dev)
        cthr = (base + nk[:Bc] % 24).to(torch.int32)
        cthr[::97] = FLOOR_NEVER  # excluded reads
        res["count_mask"].append(check_count_mask(
            torch, label, bits, loc[:Bc].contiguous(), cthr, thr))
        del bits

    # the screened path's hash: the block-row plane and the union screen
    # plane (h = 1) in one launch
    S, N = 3578, SCREEN_SIGS
    got = hash_loc(reads, K, S, full, 1, screen_sigs=N)
    want = hash_loc_plain(reads, K, S, full, 1, screen_sigs=N)
    torch.cuda.synchronize()
    err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    if err:
        raise AssertionError(f"hash_loc screen plane: max abs err {err}")
    res["hash_loc"].append(time_hash_loc(
        torch, f"screen S={S} N={N} h=1", (reads, K, S, full, 1, N), got))

    # the paired path's hash: 150 + N + 150 bp joined rows in lmax = 320,
    # the block-row, screen and value planes in one launch
    pairs = torch.from_numpy(random_pairs(rng, B, 320)).to(dev)
    args = (pairs, K, S, full, 1, N, True)
    got_p = hash_loc(*args)
    want_p = hash_loc_plain(*args)
    torch.cuda.synchronize()
    err = max(max_abs_err(torch, g, w) for g, w in zip(got_p, want_p))
    if err:
        raise AssertionError(f"hash_loc paired: max abs err {err}")
    res["hash_loc"].append(time_hash_loc(
        torch, f"paired S={S} N={N} h=1 values", args, got_p))
    del pairs, got_p, want_p

    # screened pass 1: K2' over the packed union table of 32 blocks (one
    # word a row, N rows), every read of the batch, floors 0
    union = torch.from_numpy(random_bits(rng, N, 1, 1, 0).view(np.int32)).to(dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    res["count_mask"].append(check_count_mask(
        torch, f"pass1 S={N} h=1 W=1", union, got[2].unsqueeze(2).contiguous(),
        zeros, zeros[:32]))
    return res


def time_hash_loc(torch, label, args, outs) -> tuple:
    """K1' on hash_loc(*args), already held exact against its plain
    version -> (label, 0, device ms a launch, plain ms, bound, ms of one
    call): the bound counts the reads read once and every output plane
    written once."""
    from kmcp_tpu_torch.search.hash_loc import hash_loc, hash_loc_plain

    ms = graph_ms(torch, lambda: hash_loc(*args))
    call = time_ms(torch, lambda: hash_loc(*args))
    ms_p = time_ms(torch, lambda: hash_loc_plain(*args))
    bd = bound(nbytes(args[0], *outs))
    B, lmax = args[0].shape
    log(f"phase 3 hash_loc [{label}] B={B} lmax={lmax}: exact (max abs err "
        f"0); kernel {ms:.4f} ms a launch on the card (CUDA graph), "
        f"{call:.4f} ms one call, plain {ms_p:.3f} ms, bound {bd[0]:.4f} ms "
        f"({bd[1]})")
    return label, 0, ms, ms_p, bd, call


def check_count_mask(torch, label, bits, loc, cthr, thr) -> tuple:
    """K2' against its plain version on these inputs -> (label, max abs
    err, ms, plain ms, bound); raises unless they are equal."""
    from kmcp_tpu_torch.search.count import count_mask, count_mask_plain

    counts, mask = count_mask(bits, loc, cthr, thr)
    counts_p, mask_p = count_mask_plain(bits, loc, cthr, thr)
    torch.cuda.synchronize()
    err = max(max_abs_err(torch, counts, counts_p),
              max_abs_err(torch, mask, mask_p))
    if err:
        raise AssertionError(f"count_mask {label}: max abs err {err}")
    n_set = int(torch.count_nonzero(mask))
    del counts_p, mask_p
    ms = time_ms(torch, lambda: count_mask(bits, loc, cthr, thr))
    ms_p = time_ms(torch, lambda: count_mask_plain(bits, loc, cthr, thr))
    rows = torch.unique(loc).numel()  # the Bloom rows this run reads
    bd = bound(rows * bits.shape[1] * 4 + nbytes(loc, cthr, thr, counts, mask))
    B, K = loc.shape[:2]
    log(f"phase 3 count_mask [{label}] B={B} K={K}: exact (max abs err 0, "
        f"{n_set} mask words set); kernel {ms:.3f} ms, plain {ms_p:.3f} ms, "
        f"bound {bd[0]:.4f} ms ({bd[1]}, {rows} rows touched)")
    return label, err, ms, ms_p, bd


def phase_pass2(torch, dev) -> dict:
    """Phase 3, screened pass 2: K5' pair_count and K6' group_count against
    their plain versions at 32 and 128 blocks of 4,096 targets (s_block =
    3,578 rows of random bits, 140 windows per read, 5% of them invalid),
    on 20,480 and 36,864 read-major pairs of a 16,384-read batch (bits of
    density 1/4, so a pair's counts sit near 33); K6' (the same pairs, the
    same floors) must also equal K5''s counts and mask.  Each pass-2 route
    is also timed whole, as the tail runs it."""
    from kmcp_tpu_torch.search import screen
    from kmcp_tpu_torch.search.device_step import FLOOR_NEVER
    from kmcp_tpu_torch.search.group_count import (
        gemm_slabs, group_count, group_count_plain, s_pad_for,
    )
    from kmcp_tpu_torch.search.pair_count import pair_count, pair_count_plain

    rng = np.random.default_rng(2025)
    B, s_block, W = 16_384, 3_578, 128
    Kw = 160 - K + 1  # windows of a read in the batch's lmax = 160 rows
    S_pad = s_pad_for(s_block)
    res = {"pair_count": [], "group_count": []}
    for nb, P in PASS2_CASES:
        as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        bits = as_dev(random_bits(rng, nb * s_block, W, 1, 0).view(np.int32))
        loc_np = rng.integers(0, s_block, (B, Kw)).astype(np.int32)
        loc_np[rng.random((B, Kw)) < 0.05] = s_block  # invalid windows
        loc = as_dev(loc_np)
        flat = np.sort(rng.choice(B * nb, size=P, replace=False))
        pb = as_dev((flat // nb).astype(np.int32))
        pg = as_dev((flat % nb).astype(np.int32))
        # floors as the main path sets them (a 150 bp read needs ~72 of
        # its windows); one read in 500 gets a low floor, so that about
        # half its pairs' targets pass and the mask is not empty
        cthr_np = np.full(B, 72, dtype=np.int32)
        cthr_np[rng.random(B) < 0.002] = 33
        cthr = as_dev(cthr_np)
        thr_np = rng.integers(1, 10, (nb, 32 * W)).astype(np.int32)
        thr_np[:, -7:] = FLOOR_NEVER  # padding lanes
        thr = as_dev(thr_np)
        label = f"nb={nb} P={P}"
        chunk = screen.pass2_chunk(32 * W)

        args = (bits, loc, pb, pg, cthr, thr)
        counts, mask = pair_count(*args)
        counts_p, mask_p = pair_count_plain(*args)
        torch.cuda.synchronize()
        err = max(max_abs_err(torch, counts, counts_p),
                  max_abs_err(torch, mask, mask_p))
        if err:
            raise AssertionError(f"pair_count {label}: max abs err {err}")
        n_set = int(torch.count_nonzero(mask))
        del counts_p, mask_p
        ms = time_ms(torch, lambda: pair_count(*args, rows_checked=True))
        ms_p = time_ms(torch, lambda: pair_count_plain(*args))
        route = time_ms(torch, lambda: screen._pass2_pair(
            bits, loc, pb, pg, cthr, thr, chunk))
        # each pair reads its read's locations and the block rows they hit
        reads_used = torch.unique(pb).numel()
        blocks_used = torch.unique(pg).numel()
        rows = torch.unique(pg.long()[:, None] * (s_block + 1)
                            + loc[pb.long()]).numel()
        bd = bound(rows * W * 4 + reads_used * (Kw + 1) * 4
                   + blocks_used * 32 * W * 4 + nbytes(pb, pg, counts, mask))
        log(f"phase 3 pair_count [{label}] s_block={s_block} W={W} K={Kw}: "
            f"exact (max abs err 0, {n_set} mask words set); kernel "
            f"{ms:.3f} ms (block sort included), plain {ms_p:.3f} ms, bound "
            f"{bd[0]:.4f} ms ({bd[1]}); route (K5' + compaction) "
            f"{route:.3f} ms")
        res["pair_count"].append((label, err, ms, ms_p, bd, route))

        bits01 = gemm_slabs(bits, nb, s_block, S_pad)
        args6 = (bits01, loc, pb, pg, cthr, thr, s_block)
        got = group_count(*args6)
        want = group_count_plain(*args6)
        torch.cuda.synchronize()
        err6 = max(max_abs_err(torch, got[0], want[0]),
                   max_abs_err(torch, got[1], want[1]),
                   max_abs_err(torch, got[0], counts),
                   max_abs_err(torch, got[1], mask))
        if err6:
            raise AssertionError(f"group_count {label}: max abs err {err6}")
        del want
        ms6 = time_ms(torch, lambda: group_count(*args6, rows_checked=True))
        ms6_p = time_ms(torch, lambda: group_count_plain(*args6))
        route6 = time_ms(torch, lambda: screen._pass2_gemm(
            bits01, loc, pb, pg, cthr, thr, s_block, chunk))
        # the dense product of the real pairs, whatever pads them
        flops = 2.0 * P * S_pad * 32 * W  # u8 x u8 -> s32 operations
        slab = S_pad * 32 * W  # u8 bytes of one block's slab
        bd = bound(blocks_used * slab + reads_used * Kw * 4
                   + nbytes(pb, pg, cthr, thr, *got), flops, INT8_OP_PER_S)
        lib_ms, lib_err = grouped_mm_yardstick(torch, bits01, loc, pb, pg,
                                               S_pad, got[0])
        log(f"phase 3 group_count [{label}] S_pad={S_pad} "
            f"T={32 * W}: exact (max abs err 0 vs plain and vs pair_count); "
            f"kernel {ms6:.3f} ms ({flops / ms6 / 1e9:.1f} TOP/s; block "
            f"sort included), plain {ms6_p:.3f} ms, bound {bd[0]:.4f} ms "
            f"({bd[1]}), torch._grouped_mm bf16 {lib_ms:.3f} ms (max abs "
            f"err {lib_err} vs K6'); route (K6' + compaction) "
            f"{route6:.3f} ms")
        res["group_count"].append((label, err6, ms6, ms6_p, bd, route6,
                                   lib_ms))
        del bits, bits01, got, counts, mask
        torch.cuda.empty_cache()
    return res


def grouped_mm_yardstick(torch, bits01, loc, pb, pg, S_pad, want
                         ) -> tuple[float, int]:
    """The one PyTorch call that computes K6''s grouped product on the same
    inputs: ``torch._grouped_mm`` of U bf16 [P_pad, S_pad] (the pairs'
    rows grouped by block, each block padded to whole tiles of 128) by the
    0/1 slabs in bf16 [nb, S_pad, T] (column-major), with the per-block
    row ends as offsets.  Its bf16 output holds the counts exactly (< 256).
    Returns (median ms, max abs err against K6''s counts)."""
    from kmcp_tpu_torch.search.group_count import TILE, build_u, slab_dense
    from kmcp_tpu_torch.search.pair_count import block_order

    nb = bits01.shape[0]
    T = want.shape[1]
    order, seg = block_order(pg, nb)
    cnt = (seg[1:] - seg[:-1]).long()
    padded = (cnt + TILE - 1) // TILE * TILE
    base = torch.cumsum(padded, 0) - padded  # each block's first row
    g_s = pg[order.long()].long()
    slot = base[g_s] + torch.arange(order.shape[0], device=pg.device) - (
        seg[:-1].long()[g_s])
    rows = torch.full((int(padded.sum()),), loc.shape[0], dtype=torch.long,
                      device=pg.device)
    rows[slot] = pb.long()[order.long()]
    loc_ext = torch.cat([loc, loc.new_full((1, loc.shape[1]), S_pad - 1)])
    u = build_u(loc_ext[rows], S_pad)
    # [nb, T, S_pad] contiguous, seen as [nb, S_pad, T]: the column-major
    # right operand the grouped GEMM takes
    slabs = torch.stack([slab_dense(bits01, g)[:S_pad, :T].t().to(
        torch.bfloat16) for g in range(nb)]).transpose(1, 2)
    offs = torch.cumsum(padded, 0).to(torch.int32)
    out = torch._grouped_mm(u, slabs, offs=offs)
    torch.cuda.synchronize()
    err = max_abs_err(torch, out[slot].to(torch.int32), want[order.long()])
    ms = time_ms(torch, lambda: torch._grouped_mm(u, slabs, offs=offs))
    del slabs, out, u
    return ms, err


def write_genomes(gdir: str, n: int, glen: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    os.makedirs(gdir, exist_ok=True)
    seqs = []
    for g in range(n):
        seq = rng.choice(bases, size=glen).tobytes()
        with open(os.path.join(gdir, f"g{g:05d}.fa"), "w") as f:
            f.write(f">g{g:05d}\n{seq.decode()}\n")
        seqs.append(seq)
    return seqs


def build_db(name: str, n_genomes: int, chunks: int, chunk_bp: int,
             num_hashes: int, seed: int):
    """Synthetic genomes -> compute (k=21 chunks) -> one-block index, through
    the port's command line."""
    from kmcp_tpu_torch.cli import main as cli

    root = os.path.join(SCRATCH, name)
    shutil.rmtree(root, ignore_errors=True)
    glen = chunk_bp * chunks + READ_LEN * (chunks - 1)
    gdir = os.path.join(root, "genomes")
    seqs = write_genomes(gdir, n_genomes, glen, seed)
    ks, db = os.path.join(root, "ks"), os.path.join(root, "db")
    if cli(["-q", "compute", "-I", gdir, "-O", ks, "-k", str(K),
            "-n", str(chunks), "-l", str(READ_LEN), "--force"]):
        raise RuntimeError(f"compute of the {name} DB failed")
    if cli(["-q", "index", "-I", ks, "-O", db, "-n", str(num_hashes),
            "-f", "0.3", "--tpu-native", "--native-block-targets",
            str(n_genomes * chunks), "--force"]):
        raise RuntimeError(f"index of the {name} DB failed")
    return db, seqs


def write_reads(path: str, genomes: list[bytes], seed: int
                ) -> tuple[int, np.ndarray]:
    """N_READS 150 bp reads as FASTQ: 90% from 40 source genomes, named
    r<i>.<genome>, and 10% random junk, named j<i>
    (tools/bench_large_t.py:104-128).  Returns the number of source reads
    and the source genomes' indices."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pool = rng.choice(len(genomes), size=min(40, len(genomes)),
                      replace=False)
    n_junk = N_READS // 10
    qual = "I" * READ_LEN
    with open(path, "w") as f:
        for i in range(N_READS - n_junk):
            gi = int(pool[rng.integers(0, len(pool))])
            g = genomes[gi]
            p = int(rng.integers(0, len(g) - READ_LEN))
            f.write(f"@r{i}.g{gi:05d}\n{g[p:p + READ_LEN].decode()}\n+\n"
                    f"{qual}\n")
        for i in range(n_junk):
            seq = rng.choice(bases, size=READ_LEN).tobytes().decode()
            f.write(f"@j{i}\n{seq}\n+\n{qual}\n")
    return N_READS - n_junk, pool


def write_pairs(path1: str, path2: str, genomes: list[bytes], seed: int,
                chunks: int) -> int:
    """N_READS read pairs as two FASTQ files, from the 40 source genomes
    write_reads(seed) draws: mate 1 is 150 bp of a genome, mate 2 the
    reverse complement of the 150 bp starting 200 bp downstream, the
    350 bp fragment inside one of the genome's ``chunks`` compute chunks
    (so that one target holds all of the pair's k-mers); pairs named
    r<i>.<genome>.  10% of the pairs, named j<i>, have a random junk mate 2
    instead.  Returns the number of source pairs."""
    from kmcp_tpu_torch.seqio.fastx import split_chunk_size

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pool = rng.choice(len(genomes), size=min(40, len(genomes)),
                      replace=False)
    glen = len(genomes[0])
    size, step = split_chunk_size(glen, chunks, READ_LEN, circular=False)
    frag = 200 + READ_LEN
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    n_junk = N_READS // 10
    qual = "I" * READ_LEN
    with open(path1, "w") as f1, open(path2, "w") as f2:
        for i in range(N_READS):
            gi = int(pool[rng.integers(0, len(pool))])
            g = genomes[gi]
            c = int(rng.integers(0, chunks))
            end = min(c * step + size, glen)
            p = c * step + int(rng.integers(0, end - c * step - frag + 1))
            m1 = g[p : p + READ_LEN].decode()
            if i < N_READS - n_junk:
                name = f"r{i}.g{gi:05d}"
                m2 = g[p + 200 : p + frag].translate(rc)[::-1].decode()
            else:
                name = f"j{i}"
                m2 = rng.choice(bases, size=READ_LEN).tobytes().decode()
            f1.write(f"@{name}\n{m1}\n+\n{qual}\n")
            f2.write(f"@{name}\n{m2}\n+\n{qual}\n")
    return N_READS - n_junk


def first_rows(path: str) -> dict:
    """A TSV's first (best) row of each query, split into its columns."""
    first = {}
    with open(path) as f:
        for line in f:
            if not line.startswith("#"):
                cols = line.rstrip("\n").split("\t")
                first.setdefault(cols[0], cols)
    return first


def source_best_hits(path: str) -> tuple[dict, list]:
    """(source read r<i>.<genome> -> its best hit's target, the reads whose
    best hit is another genome)."""
    src = {q: cols[5] for q, cols in first_rows(path).items()
           if q.startswith("r")}
    return src, [q for q, t in src.items() if q.split(".", 1)[1] != t]


def check_best_hits(path: str, n_source: int) -> None:
    """Every source read r<i>.<genome> must have <genome> as its first (best)
    hit: its own chunk covers all its k-mers, and another genome's chunk
    would have to share all 130 of them by Bloom false positives."""
    src, wrong = source_best_hits(path)
    if len(src) != n_source or wrong:
        raise AssertionError(
            f"{path}: {n_source - len(src)} source reads unmatched, "
            f"{len(wrong)} with another genome first (e.g. {wrong[:3]})"
        )


def kernel_wrappers() -> dict:
    """The four kernel wrappers by name; each counts its own launches."""
    from kmcp_tpu_torch.search.count import count_mask
    from kmcp_tpu_torch.search.group_count import group_count
    from kmcp_tpu_torch.search.hash_loc import hash_loc
    from kmcp_tpu_torch.search.pair_count import pair_count

    return {"hash_loc": hash_loc, "count_mask": count_mask,
            "pair_count": pair_count, "group_count": group_count}


def counted_run(fn, *args, **kwargs):
    """fn(*args, **kwargs) with every kernel's launch count set to 0 just
    before it -> (its result, the launches it made, its wall seconds)."""
    kernels = kernel_wrappers()
    for k in kernels.values():
        k.launches = 0
    t0 = time.time()
    out = fn(*args, **kwargs)
    wall = time.time() - t0
    return out, {n: k.launches for n, k in kernels.items()}, wall


def searched(db: str, out: str, **kwargs) -> dict:
    """run_search(db, out_file=out, **kwargs) as counted_run runs it ->
    its TSV bytes, ``out``, stats, wall seconds, (total, matched) and
    launches."""
    from kmcp_tpu_torch.commands.search import run_search

    stats: dict = {}
    totals, launches, wall = counted_run(run_search, db, out_file=out,
                                         verbose=False, stats=stats, **kwargs)
    with open(out, "rb") as f:
        tsv = f.read()
    return {"tsv": tsv, "out": out, "stats": stats, "wall": wall,
            "totals": totals, "launches": launches}


@contextlib.contextmanager
def plain_kernels():
    """Bind the main paths' kernel calls (K1' of every device search, the
    sketch branch's included; K2' in the dense tail, in screened pass 1
    and in the object engine's counter; K5' and K6' in pass 2) to their
    plain PyTorch versions, so the same paths run without the CUDA
    kernels."""
    from kmcp_tpu_torch.search import device, device_step, kernel, screen
    from kmcp_tpu_torch.search.count import count_mask_plain
    from kmcp_tpu_torch.search.group_count import group_count_plain
    from kmcp_tpu_torch.search.hash_loc import hash_loc_plain
    from kmcp_tpu_torch.search.pair_count import pair_count_plain

    def count(bits, loc, cthr, thr, rows_checked=False):
        return count_mask_plain(bits, loc, cthr, thr)

    def pair(bits, loc, pb, pg, cthr, thr, rows_checked=False):
        return pair_count_plain(bits, loc, pb, pg, cthr, thr)

    def group(bits01, loc, pb, pg, cthr, thr, s_block, rows_checked=False):
        return group_count_plain(bits01, loc, pb, pg, cthr, thr, s_block)

    binds = [(device, "hash_loc", hash_loc_plain),
             (device_step, "count_mask", count), (screen, "count_mask", count),
             (kernel, "count_mask", count),
             (screen, "pair_count", pair), (screen, "group_count", group)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in binds]
    for obj, name, fn in binds:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def phase_main_path(torch, dev, label: str, db: str, reads: str,
                    n_source: int, reference: str, timed: bool = False
                    ) -> dict:
    """The port on ``dev`` against a reference run of the same reads:
    ``plain`` (the same path on ``dev`` with the plain versions) or
    ``cpu`` (the port's CPU run).  The TSVs must be byte-identical.
    ``timed``: then a rerun with stage timers gives the time by stage and
    the steady rate (the wall without the engine open and streamer
    set-up)."""
    from kmcp_tpu_torch.commands.search import run_search

    out_dev = os.path.join(SCRATCH, f"{label}.{dev.type}.tsv")
    out_ref = os.path.join(SCRATCH, f"{label}.{reference}.tsv")
    stats: dict = {}
    (total, matched), launches, dev_s = counted_run(
        run_search, db, [reads], out_file=out_dev, device=dev, verbose=False,
        stats=stats)

    ref_stats: dict = {}
    if reference == "plain":
        with plain_kernels():
            ref, ref_launches, ref_s = counted_run(
                run_search, db, [reads], out_file=out_ref, device=dev,
                verbose=False, stats=ref_stats)
    else:
        ref, ref_launches, ref_s = counted_run(
            run_search, db, [reads], out_file=out_ref, device="cpu",
            verbose=False, stats=ref_stats)
    if any(ref_launches.values()):
        raise AssertionError(f"{label}: the reference run launched a kernel")

    with open(out_ref, "rb") as f:
        want = f.read()
    with open(out_dev, "rb") as f:
        got = f.read()
    if got != want:
        raise AssertionError(f"{label}: TSV differs from the {reference} run")
    if (total, matched) != ref or total != N_READS:
        raise AssertionError(f"{label}: totals {total, matched} vs {ref}")
    check_best_hits(out_dev, n_source)
    # the dense one-block path runs K1' and K2' (CPU tensors take the plain
    # versions), and neither pass-2 kernel
    launched = min(launches["hash_loc"], launches["count_mask"]) > 0
    if ((dev.type == "cuda" and not launched) or launches["pair_count"]
            or launches["group_count"]):
        raise AssertionError(f"{label}: launches {launches}")
    if stats["slow_rows"]:
        raise AssertionError(f"{label}: {stats['slow_rows']} reads took the "
                             "object engine")
    log(f"{label}: DB {stats['rows']} Bloom rows x {stats['words']} words "
        f"({32 * stats['words']} target lanes); TSV byte-identical to the "
        f"{reference} run ({len(got)} bytes, {matched}/{total} reads "
        f"matched, all {n_source} source reads best-hit their genome); "
        f"{dev} {total / dev_s:.1f} reads/s, {reference} run "
        f"{total / ref_s:.1f} reads/s (run_search wall incl. DB load); 4x "
        f"retries {stats['retries']}, slow rows {stats['slow_rows']}, "
        f"launches {launches}")
    if timed:
        acc: dict = {}
        with stage_timers(torch, acc):
            _, _, wall = counted_run(run_search, db, [reads], out_file=out_dev,
                                     device=dev, verbose=False)
        with open(out_dev, "rb") as f:
            if f.read() != want:
                raise AssertionError(f"{label} timed: TSV differs")
        steady = wall - sum(acc.get(k, 0.0) for k in (
            "engine_open", "engine_check", "streamer_setup"))
        log(f"{label} stages (synchronised host clock, s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
            + f"; run_search wall {wall:.3f}; steady {total / steady:.1f} "
            "reads/s (without engine open and streamer set-up)")
    return {"launches": launches, "device_rps": total / dev_s,
            "retries": stats["retries"], "out": out_dev}


@contextlib.contextmanager
def stage_timers(torch, acc: dict):
    """Time a search's stages on a synchronised host clock, by wrapping
    the functions it calls: the DB set-up (host arrays, of which the union
    screens' packing, then the upload; the engine's open and check before
    it, and the streamer set-up around it), the device hash, a sketch
    DB's window selection, the paired
    mode's dedup, the dense tail and its K2' launches, or the screened
    pass 1, pass-2 kernels,
    whole pass-2 routes and packing with its D2H copy, and the TSV writer;
    on the object engine's route its host hashing and uniquing, the
    counter (location derivation and padding; the device part, its K2'
    launches among it; the rest of the call, the D2H copy of the counts),
    host extraction and the TSV writer.  Seconds accumulate in ``acc``."""
    from kmcp_tpu_torch.commands import search as command
    from kmcp_tpu_torch.search import (device, device_step, engine, kernel,
                                       screen)
    from kmcp_tpu_torch.search.stream import TorchStreamSearcher

    counter = kernel.TorchBlockCounter
    targets = [(command, "SearchEngine", "engine_open"),
               (command, "usable", "engine_check"),
               (command, "TorchStreamSearcher", "streamer_setup"),
               (device, "numpy_state", "db_state"),
               (device, "build_packed_union", "db_state_union_pack"),
               (device.TorchDeviceDB, "_init", "db_upload"),
               (device, "hash_loc", "hash"),
               (device, "sketch_transform", "sketch_select"),
               (device, "count_tail", "dense_tail"),
               (device_step, "count_mask", "dense_count_kernel"),
               (device_step, "dedup_planes", "dedup"),
               (screen, "dedup_planes", "dedup"),
               (screen, "active_pairs", "pass1"),
               (screen, "pair_count", "pass2_kernel"),
               (screen, "group_count", "pass2_kernel"),
               (screen, "_pass2_pair", "pass2_route"),
               (screen, "_pass2_gemm", "pass2_route"),
               (screen, "pack_result_split", "pack_d2h"),
               (TorchStreamSearcher, "_write_native", "writer"),
               (engine, "hash_reads_batch", "engine_hash"),
               (engine, "unique_sorted", "engine_unique"),
               (counter, "__call__", "engine_counter"),
               (counter, "rows", "engine_locations"),
               (counter, "count_rows", "engine_count"),
               (kernel, "count_mask", "engine_count_kernel"),
               (engine.SearchEngine, "_extract_matches", "engine_extract"),
               (command, "write_results", "engine_writer")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]

    def timed(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    for (obj, name, key), (_, _, fn) in zip(targets, saved):
        setattr(obj, name, timed(fn, key))
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def phase_screened(torch, dev, ks: str, reads: str, n_source: int) -> dict:
    """Phase 6: the screened main path on a 32-block DB of phase 4's
    chunks, pass2="gemm", "pair" and "auto" on the card against the same
    path with the kernels bound to their plain versions on the card
    (pass2="pair"); then a stage-timed run of the gemm and pair routes."""
    from kmcp_tpu_torch.cli import main as cli
    from kmcp_tpu_torch.search.engine import SearchOptions
    from kmcp_tpu_torch.search.screen import pass2_kernel

    db = os.path.join(SCRATCH, "screened", "db")
    t0 = time.time()
    if cli(["-q", "index", "-I", ks, "-O", db, "-n", "1", "-f", "0.3",
            "--tpu-native", "--native-block-targets", str(BLOCK_TARGETS),
            "--block-screen", "--uniform-sigs", "--force"]):
        raise RuntimeError("index of the screened DB failed")
    index_s = time.time() - t0

    def search(pass2: str, tag: str) -> dict:
        return searched(db, os.path.join(SCRATCH, f"screened.{tag}.tsv"),
                        files=[reads], device=dev, pass2=pass2)

    runs = {p: search(p, p) for p in ("gemm", "pair", "auto")}
    with plain_kernels():
        ref = search("pair", "plain.pair")
    if any(ref["launches"].values()):
        raise AssertionError("phase 6: the plain run launched a kernel")
    st = ref["stats"]
    if st["n_blocks"] < 2 or st["pass2"] != "pair":
        raise AssertionError(f"phase 6: not a screened run: {st}")
    rows_per_block = st["rows"] // st["n_blocks"]
    auto = pass2_kernel(st["n_blocks"], st["words"], rows_per_block,
                        SearchOptions().kmer_dedup_threshold)
    for p2, run in runs.items():
        tag = f"phase 6 screened {p2}"
        want = auto if p2 == "auto" else p2
        if run["tsv"] != ref["tsv"]:
            raise AssertionError(f"{tag}: TSV differs from the plain run")
        if run["totals"] != ref["totals"] or run["totals"][0] != N_READS:
            raise AssertionError(f"{tag}: totals {run['totals']} vs "
                                 f"{ref['totals']}")
        check_best_hits(run["out"], n_source)
        if run["stats"]["pass2"] != want or run["stats"]["slow_rows"]:
            raise AssertionError(f"{tag}: stats {run['stats']}")
        other = "pair_count" if want == "gemm" else "group_count"
        mine = "group_count" if want == "gemm" else "pair_count"
        la = run["launches"]
        launched = min(la["hash_loc"], la["count_mask"], la[mine]) > 0
        if (dev.type == "cuda" and not launched) or la[other]:
            raise AssertionError(f"{tag}: launches {la}")
    log(f"phase 6 DB: {st['n_blocks']} blocks x {rows_per_block} Bloom rows "
        f"x {st['words']} words ({32 * st['words']} targets a block), union "
        f"screen {st['union_rows']} rows; indexed in {index_s:.1f} s")
    for p2, run in runs.items():
        log(f"phase 6 screened {p2}: TSV byte-identical to the plain run "
            f"({len(run['tsv'])} bytes, {run['totals'][1]}/{run['totals'][0]}"
            f" reads matched, all {n_source} source reads best-hit their "
            f"genome); {N_READS / run['wall']:.1f} reads/s (run_search wall "
            f"incl. DB load), plain run {N_READS / ref['wall']:.1f} reads/s; "
            f"{run['stats']['pairs']} active pairs, 4x retries "
            f"{run['stats']['retries']}, slow rows 0, launches "
            f"{run['launches']}")

    breakdown = {}
    for p2 in ("gemm", "pair"):
        acc: dict = {}
        with stage_timers(torch, acc):
            run = search(p2, f"{p2}.timed")
        if run["tsv"] != ref["tsv"]:
            raise AssertionError(f"phase 6 timed {p2}: TSV differs")
        acc["compaction"] = (acc.pop("pass2_route")
                             - acc.get("pass2_kernel", 0.0))
        breakdown[p2] = acc
        log(f"phase 6 stages {p2} (synchronised host clock, s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
            + f"; run_search wall {run['wall']:.3f}")
    return {"launches": {p: r["launches"] for p, r in runs.items()},
            "breakdown": breakdown, "db": db}


def phase_paired(torch, dev, label: str, db: str, r1: str, r2: str,
                 n_source: int, screened: bool) -> dict:
    """Phase 7 on one DB: the paired search on the card against the same
    path with the kernels bound to their plain versions on the card (TSVs
    byte-identical), its launches and best hits checked; then a
    stage-timed rerun.  ``screened``: the DB is phase 6's (pass2="auto",
    which picks K5'), else phase 4's one-block DB (the dense tail)."""
    def search(tag: str) -> dict:
        return searched(db, os.path.join(SCRATCH, f"paired.{label}.{tag}.tsv"),
                        read1=r1, read2=r2, device=dev, pass2="auto")

    run = search("cuda")
    with plain_kernels():
        ref = search("plain")
    tag = f"phase 7 paired {label}"
    if any(ref["launches"].values()):
        raise AssertionError(f"{tag}: the plain run launched a kernel")
    if run["tsv"] != ref["tsv"]:
        raise AssertionError(f"{tag}: TSV differs from the plain run")
    if run["totals"] != ref["totals"] or run["totals"][0] != N_READS:
        raise AssertionError(f"{tag}: totals {run['totals']} vs "
                             f"{ref['totals']}")
    check_best_hits(run["out"], n_source)
    la, st = run["launches"], run["stats"]
    want = ["hash_loc", "count_mask"] + (["pair_count"] if screened else [])
    if (min(la[n] for n in want) == 0
            or any(la[n] for n in la if n not in want)):
        raise AssertionError(f"{tag}: launches {la}")
    if st["slow_rows"] or (st["n_blocks"] > 1) != screened:
        raise AssertionError(f"{tag}: stats {st}")
    log(f"{tag}: TSV byte-identical to the plain run ({len(run['tsv'])} "
        f"bytes, {run['totals'][1]}/{run['totals'][0]} pairs matched, all "
        f"{n_source} source pairs best-hit their genome); "
        f"{N_READS / run['wall']:.1f} pairs/s (run_search wall incl. DB "
        f"load), plain run {N_READS / ref['wall']:.1f} pairs/s; "
        f"{st['pairs']} active (read, block) pairs, 4x retries "
        f"{st['retries']}, slow rows 0, launches {la}")
    acc: dict = {}
    with stage_timers(torch, acc):
        timed = search("cuda.timed")
    if timed["tsv"] != ref["tsv"]:
        raise AssertionError(f"{tag} timed: TSV differs")
    if "pass2_route" in acc:
        acc["compaction"] = acc.pop("pass2_route") - acc.get("pass2_kernel",
                                                             0.0)
    steady = timed["wall"] - sum(acc.get(k, 0.0) for k in (
        "engine_open", "engine_check", "streamer_setup"))
    log(f"{tag} stages (synchronised host clock, s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
        + f"; run_search wall {timed['wall']:.3f}; steady "
        f"{N_READS / steady:.1f} pairs/s (without engine open and streamer "
        "set-up)")
    return {"launches": la, "breakdown": acc, "out": run["out"]}


def link_genomes(gdir: str, src: str, indices) -> str:
    """A directory of symlinks to the genome files ``indices`` of ``src``
    (phase 4's genomes), the input of a ``compute -I``."""
    shutil.rmtree(gdir, ignore_errors=True)
    os.makedirs(gdir)
    for g in sorted(int(i) for i in indices):
        name = f"g{g:05d}.fa"
        os.symlink(os.path.join(src, name), os.path.join(gdir, name))
    return gdir


def genome_subset(pool, n: int) -> list[int]:
    """n of phase 4's genome indices: the reads' source genomes ``pool``,
    then the lowest others."""
    others = [g for g in range(WIDE_GENOMES) if g not in set(pool.tolist())]
    return sorted(list(pool) + others[: n - len(pool)])


def check_plain(tag: str, run: dict, ref: dict, route: str,
                want: tuple, dev) -> None:
    """A run on the card against its plain_kernels() run: TSV and totals
    equal, the route taken, the kernels of ``want`` launched (on a CUDA
    device) and no other, none in the plain run."""
    if any(ref["launches"].values()):
        raise AssertionError(f"{tag}: the plain run launched a kernel")
    if run["tsv"] != ref["tsv"]:
        raise AssertionError(f"{tag}: TSV differs from the plain run")
    if run["totals"] != ref["totals"]:
        raise AssertionError(f"{tag}: totals {run['totals']} vs "
                             f"{ref['totals']}")
    if run["stats"]["route"] != route:
        raise AssertionError(f"{tag}: route {run['stats']['route']}")
    la = run["launches"]
    if ((dev.type == "cuda" and min(la[n] for n in want) == 0)
            or any(la[n] for n in la if n not in want)):
        raise AssertionError(f"{tag}: launches {la}")


def phase_sketch(torch, dev, genome_src: str, pool, reads: str,
                 n_source: int) -> dict:
    """Phase 8: a minimizer (compute -W 5) and a closed-syncmer (-S 11) DB
    of SKETCH_GENOMES of phase 4's genomes (its 40 source genomes among
    them) x 64 chunks, k = 21, one block (-n 1 -f 0.3 --tpu-native);
    phase 4's reads streamed on the card (K1' at k with values, at k = s
    for syncmers, the window selection, the dense tail) against the same
    path with the kernels bound to their plain versions on the card; then
    a stage-timed rerun."""
    from kmcp_tpu_torch.cli import main as cli

    gdir = link_genomes(os.path.join(SCRATCH, "sketch", "genomes"),
                        genome_src, genome_subset(pool, SKETCH_GENOMES))
    out = {"launches": {}, "breakdown": {}}
    for kind, flag in (("minimizer", ["-W", "5"]), ("syncmer", ["-S", "11"])):
        t0 = time.time()
        ks = os.path.join(SCRATCH, "sketch", kind, "ks")
        db = os.path.join(SCRATCH, "sketch", kind, "db")
        if cli(["-q", "compute", "-I", gdir, "-O", ks, "-k", str(K), *flag,
                "-n", str(WIDE_CHUNKS), "-l", str(READ_LEN), "--force"]):
            raise RuntimeError(f"compute of the {kind} DB failed")
        if cli(["-q", "index", "-I", ks, "-O", db, "-n", "1", "-f", "0.3",
                "--tpu-native", "--native-block-targets",
                str(SKETCH_GENOMES * WIDE_CHUNKS), "--force"]):
            raise RuntimeError(f"index of the {kind} DB failed")
        build_s = time.time() - t0

        def search(tag: str) -> dict:
            return searched(db, os.path.join(SCRATCH, f"sketch.{kind}.{tag}"
                                             ".tsv"), files=[reads],
                            device=dev)

        run = search("cuda")
        with plain_kernels():
            ref = search("plain")
        tag = f"phase 8 {kind}"
        check_plain(tag, run, ref, "stream", ("hash_loc", "count_mask"), dev)
        st, la = run["stats"], run["launches"]
        # K1' once a batch of 16,384 reads (twice for syncmers), and again
        # for every batch the 4x candidate-budget retry re-runs
        batches = -(-N_READS // 16_384) + st["retries"]
        n_hash = (2 if kind == "syncmer" else 1) * batches
        if (dev.type == "cuda" and la["hash_loc"] != n_hash) or (
                st["slow_rows"] or st["n_blocks"] != 1):
            raise AssertionError(f"{tag}: launches {la}, stats {st}")
        src, wrong = source_best_hits(run["out"])
        share = (len(src) - len(wrong)) / n_source
        log(f"{tag}: DB {SKETCH_GENOMES * WIDE_CHUNKS} targets, "
            f"{st['rows']} Bloom rows x {st['words']} words, built in "
            f"{build_s:.1f} s; TSV byte-identical to the plain run "
            f"({len(run['tsv'])} bytes, {run['totals'][1]}/"
            f"{run['totals'][0]} reads matched); {share:.4f} of the "
            f"{n_source} source reads best-hit their genome (not gated); "
            f"{N_READS / run['wall']:.1f} reads/s (run_search wall incl. DB "
            f"load), plain run {N_READS / ref['wall']:.1f} reads/s; 4x "
            f"retries {st['retries']}, slow rows 0, launches {la}")
        acc: dict = {}
        with stage_timers(torch, acc):
            timed = search("cuda.timed")
        if timed["tsv"] != ref["tsv"]:
            raise AssertionError(f"{tag} timed: TSV differs")
        steady = timed["wall"] - sum(acc.get(k, 0.0) for k in (
            "engine_open", "engine_check", "streamer_setup"))
        log(f"{tag} stages (synchronised host clock, s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
            + f"; run_search wall {timed['wall']:.3f}; steady "
            f"{N_READS / steady:.1f} reads/s (without engine open and "
            "streamer set-up)")
        out["launches"][kind] = la
        out["breakdown"][kind] = acc
    return out


def fastq_every(src: str, dst: str, every: int) -> None:
    """Every ``every``-th record of a FASTQ file, the first one included."""
    with open(src) as f, open(dst, "w") as g:
        for i, line in enumerate(f):
            if (i // 4) % every == 0:
                g.write(line)


def phase_engine(torch, dev, genome_src: str, pool, wide_db: str,
                 screened_db: str, reads: str, pair_files) -> dict:
    """Phase 9: searches the streamer turns down, on the object engine
    (its blocks count with K2' on the card), each against the same search
    with the kernels bound to their plain versions on the card:
    - ``-g -t 0.15 -s jacc`` on a DB of GENOME_DB_GENOMES of phase 4's
      genomes, one target each (no -n), indexed -n 3 -f 0.01: six queries
      of one genome file each (each must best-hit its genome with jacc
      1.0000) and two of five genomes (~320k k-mers, past the JAX
      package's 262,144 genome threshold);
    - ENGINE_READS of phase 4's reads with ``-s jacc`` on phase 4's wide
      DB; the same reads on the wide and screened DBs at once (a
      directory of links to both: the multi-DB intersection);
    - ENGINE_READS of phase 7's pairs with ``--try-se`` on the wide DB;
    then a stage-timed rerun of each."""
    from kmcp_tpu_torch.cli import main as cli
    from kmcp_tpu_torch.search.engine import SearchOptions

    root = os.path.join(SCRATCH, "engine")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.time()
    chosen = genome_subset(pool, GENOME_DB_GENOMES)
    gdir = link_genomes(os.path.join(root, "genomes"), genome_src, chosen)
    gks, gdb = os.path.join(root, "ks"), os.path.join(root, "db")
    if cli(["-q", "compute", "-I", gdir, "-O", gks, "-k", str(K),
            "--force"]):
        raise RuntimeError("compute of the -g DB failed")
    if cli(["-q", "index", "-I", gks, "-O", gdb, "-n", "3", "-f", "0.01",
            "--force"]):
        raise RuntimeError("index of the -g DB failed")
    build_s = time.time() - t0
    singles = [os.path.join(gdir, f"g{g:05d}.fa") for g in chosen[:6]]
    multis = []
    for j in range(2):
        path = os.path.join(root, f"five{j}.fa")
        with open(path, "w") as f:
            for g in chosen[6 + 5 * j : 11 + 5 * j]:
                with open(os.path.join(gdir, f"g{g:05d}.fa")) as src:
                    f.write(src.read())
        multis.append(path)
    few = os.path.join(root, "reads.fq")
    fastq_every(reads, few, N_READS // ENGINE_READS)
    p1, p2 = (os.path.join(root, "r1.fq"), os.path.join(root, "r2.fq"))
    fastq_every(pair_files[0], p1, N_READS // ENGINE_READS)
    fastq_every(pair_files[1], p2, N_READS // ENGINE_READS)
    both = os.path.join(root, "both")
    os.makedirs(both)
    os.symlink(wide_db, os.path.join(both, "wide"))
    os.symlink(screened_db, os.path.join(both, "screened"))
    log(f"phase 9 -g DB: {GENOME_DB_GENOMES} targets built in "
        f"{build_s:.1f} s")

    cases = {
        "-g": dict(db=gdb, files=singles + multis, whole_file=True,
                   opt=SearchOptions(min_query_cov=0.15, sort_by="jacc")),
        "jacc": dict(db=wide_db, files=[few],
                     opt=SearchOptions(sort_by="jacc")),
        "multi-db": dict(db=both, files=[few], opt=SearchOptions()),
        "try-se": dict(db=wide_db, read1=p1, read2=p2,
                       opt=SearchOptions(try_se=True)),
    }
    out = {"launches": {}, "breakdown": {}}
    for name, kw in cases.items():
        kw = dict(kw)
        db = kw.pop("db")

        def search(tag: str) -> dict:
            return searched(db, os.path.join(root, f"{name}.{tag}.tsv"),
                            device=dev, **kw)

        run = search("cuda")
        with plain_kernels():
            ref = search("plain")
        tag = f"phase 9 {name}"
        check_plain(tag, run, ref, "engine", ("count_mask",), dev)
        if name == "-g":
            first = first_rows(run["out"])
            for path in singles:
                g = os.path.basename(path)[:-3]
                row = first.get(g)
                if row is None or row[5] != g or row[13] != "1.0000":
                    raise AssertionError(f"{tag}: query {g} first row {row}")
            nk = [int(first[f"g{chosen[6 + 5 * j]:05d}"][2])
                  for j in range(2)]
            if min(nk) < GENOME_KMERS:
                raise AssertionError(f"{tag}: five-genome queries of {nk} "
                                     "k-mers")
        la = run["launches"]
        log(f"{tag}: TSV byte-identical to the plain run ({len(run['tsv'])}"
            f" bytes, {run['totals'][1]}/{run['totals'][0]} queries "
            "matched" + ("; each single-genome query best-hits its genome "
                         f"with jacc 1.0000; five-genome queries of {nk} "
                         "k-mers" if name == "-g" else "")
            + f"); wall {run['wall']:.3f} s, plain run {ref['wall']:.3f} s; "
            f"launches {la}")
        acc: dict = {}
        with stage_timers(torch, acc):
            timed = search("cuda.timed")
        if timed["tsv"] != ref["tsv"]:
            raise AssertionError(f"{tag} timed: TSV differs")
        acc["engine_d2h"] = (acc.get("engine_counter", 0.0)
                             - acc.get("engine_locations", 0.0)
                             - acc.get("engine_count", 0.0))
        log(f"{tag} stages (synchronised host clock, s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
            + f"; run_search wall {timed['wall']:.3f}")
        out["launches"][name] = la
        out["breakdown"][name] = acc
    return out


# ------------------------------------------------------------- phase 10
PROFILE_MODE = "1"  # KMCP's "higher recall" preset: >= 5 reads in 60% of chunks
GENERA = 256  # phase 10's taxdump: 256 genera of 8 species, one per genome
MIN_OWN_SHARE = 0.99  # of source reads binned to their own genome's taxid
MAX_JUNK_SHARE = 0.01  # of junk reads binned at all
MAX_OTHER_PCT = 0.1  # profile percentage of all genomes outside the 40
LOW_MEM_CHUNK = 1 << 20  # KMCP_TPU_PARSE_CHUNK of the --low-mem run


def write_taxdump(root: str, n_genomes: int) -> tuple[str, str]:
    """A taxdump for phase 4's genomes: root, superkingdom, phylum, class,
    order, family, GENERA genera, then one species per genome g<i>; and
    the taxid.map of the genome names.  Returns (taxdump dir, map)."""
    tax = os.path.join(root, "taxdump")
    os.makedirs(tax, exist_ok=True)
    nodes = [(1, 1, "no rank", "root"), (2, 1, "superkingdom", "Bacteria"),
             (3, 2, "phylum", "Phylum S"), (4, 3, "class", "Class S"),
             (5, 4, "order", "Order S"), (6, 5, "family", "Family S")]
    per_genus = n_genomes // GENERA
    nodes += [(1000 + g, 6, "genus", f"Genus {g}") for g in range(GENERA)]
    nodes += [(100_000 + i, 1000 + i // per_genus, "species", f"Species {i}")
              for i in range(n_genomes)]
    with open(os.path.join(tax, "nodes.dmp"), "w") as f:
        f.writelines(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r, _ in nodes)
    with open(os.path.join(tax, "names.dmp"), "w") as f:
        f.writelines(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
                     for t, _, _, n in nodes)
    tmap = os.path.join(root, "taxid.map")
    with open(tmap, "w") as f:
        f.writelines(f"g{i:05d}\t{100_000 + i}\n" for i in range(n_genomes))
    return tax, tmap


@contextlib.contextmanager
def host_stage_timers(acc: dict):
    """Time the profile and merge commands' stages on the host clock, by
    wrapping the functions they call: the parse (in-memory and
    ``--low-mem``), profile stage 1, stage 2 (pairwise ambiguity), stage 3
    (disambiguation), the whole four stages + EM (``run``, and
    ``run_spilled``), each report writer, and merge's k-way merge.
    Seconds accumulate in ``acc``.  (The binning is a generator that the
    command drains as it writes, so it is timed as the rest of the
    wall.)"""
    from kmcp_tpu_torch.commands import profile as command
    from kmcp_tpu_torch.merge import merge
    from kmcp_tpu_torch.profile import fast, spill

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[key] = acc.get(key, 0.0) + time.time() - t0
        return wrapper

    binds = [(fast, "flat_from_files", "parse"),
             (spill, "spill_from_files", "parse_low_mem"),
             (fast.FastProfiler, "_accumulate_stage1", "stage1"),
             (fast.FastProfiler, "_count_amb", "stage2"),
             (fast.FastProfiler, "_megapath_deletions", "stage3"),
             (fast.FastProfiler, "run", "stages_and_em"),
             (spill, "run_spilled", "stages_and_em_low_mem"),
             (command, "write_kmcp_profile", "write_profile"),
             (command, "write_cami_profile", "write_cami"),
             (command, "write_metaphlan_profile", "write_metaphlan"),
             (merge, "_run_merge_native", "merge")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in binds]
    for obj, name, key in binds:
        setattr(obj, name, timed(key, getattr(obj, name)))
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def read_text(path: str) -> str:
    import gzip

    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        return f.read()


def tsv_rows(path: str) -> list[str]:
    return [ln for ln in read_text(path).splitlines()
            if ln and not ln.startswith("#")]


def split_by_target(tsv: str, out_dir: str, n_first: int) -> list[str]:
    """Phase 4's TSV split into two shard TSVs by target: g<i> with
    i < n_first, and the rest; each keeps the header and writes its own
    '#' stat lines (hits rewritten per shard), as searches of two DB shards
    would return them."""
    text = read_text(tsv)
    lines = text.splitlines()
    total = int(text.split("# input queries: ")[1].split("\n")[0])
    rows = [ln.split("\t") for ln in lines if ln and not ln.startswith("#")]
    paths = []
    for h in range(2):
        part = [c for c in rows if (int(c[5][1:]) < n_first) == (h == 0)]
        hits: dict = {}
        for c in part:
            hits[c[14]] = hits.get(c[14], 0) + 1
        path = os.path.join(out_dir, f"shard{h}.tsv")
        with open(path, "w") as f:
            f.write(lines[0] + "\n")
            for c in part:
                c = list(c)
                c[4] = str(hits[c[14]])
                f.write("\t".join(c) + "\n")
            pct = len(hits) / total * 100 if total else 0.0
            f.write(f"# input queries: {total}\n# matched queries: "
                    f"{len(hits)}\n# matched percentage: {pct:.4f}%\n")
        paths.append(path)
    return paths


def check_profile(tag: str, out: dict, pool, tax: str, tmap: str,
                  tsv: str, paired: bool) -> dict:
    """Phase 10 (a)'s checks of one profile run's files (``out``: the
    profile, CAMI and binning paths, and the reads).  A junk read j<i> is
    random; a junk pair j<i> has a random mate 2 but mate 1 from one of
    the 40 source genomes, so it may bin to that genome: ``paired`` allows
    any of the 40 source genomes' taxids for them, and no other."""
    from kmcp_tpu_torch.cli import main as cli

    rows = [ln.split("\t") for ln in read_text(out["profile"]).splitlines()[1:]]
    pct = {r[0]: float(r[1]) for r in rows}
    source = {f"g{int(g):05d}" for g in pool}
    missing = sorted(source - set(pct))
    if missing:
        # why: the reference engine's --debug trace of the missing genomes
        dbg = os.path.join(os.path.dirname(out["profile"]), "debug.txt")
        cli(["-q", "profile", "-m", PROFILE_MODE, "-T", tmap, "-X", tax,
             tsv, "-o", os.devnull, "--debug", dbg])
        why = [ln for ln in read_text(dbg).splitlines()
               if any(g in ln for g in missing)]
        raise AssertionError(f"{tag}: {len(missing)} source genomes not in "
                             f"the profile: {missing[:5]}; {why[:5]}")
    other = sum(v for g, v in pct.items() if g not in source)
    if other > MAX_OTHER_PCT:
        raise AssertionError(f"{tag}: genomes outside the 40 hold {other}%")
    by_rank: dict = {}
    for ln in read_text(out["cami"]).splitlines():
        if ln and not ln.startswith("@"):
            c = ln.split("\t")
            by_rank[c[1]] = by_rank.get(c[1], 0.0) + float(c[4])
    if (max(by_rank.values()) > 100.01
            or abs(by_rank["genus"] - by_rank["species"]) > 0.01):
        raise AssertionError(f"{tag}: CAMI rank sums {by_rank}")
    bins = {}
    for ln in read_text(out["binning"]).splitlines():
        if ln and not ln.startswith(("#", "@")):
            q, t = ln.split("\t")
            bins[q] = int(t)
    queries = [ln[1:].split()[0] for ln in read_text(out["reads"]).splitlines()
               [::4]]
    src = [q for q in queries if q.startswith("r")]
    junk = [q for q in queries if q.startswith("j")]
    own = sum(bins.get(q) == 100_000 + int(q.split(".g")[1]) for q in src)
    junk_in = sum(q in bins for q in junk)
    source_taxa = {100_000 + int(g) for g in pool}
    junk_bad = (sum(q in bins and bins[q] not in source_taxa for q in junk)
                if paired else junk_in)
    if (own < MIN_OWN_SHARE * len(src)
            or junk_bad > MAX_JUNK_SHARE * len(junk)):
        raise AssertionError(
            f"{tag}: {own}/{len(src)} source reads binned to their genome, "
            f"{junk_in}/{len(junk)} junk reads binned, {junk_bad} of them "
            f"{'outside the 40 source genomes' if paired else 'at all'}")
    log(f"{tag}: all 40 source genomes profiled ({len(pct)} references, "
        f"{other:.6f}% outside the 40); CAMI rank sums "
        f"{min(by_rank.values()):.6f}-{max(by_rank.values()):.6f}%, genus "
        f"{by_rank['genus']:.6f} = species {by_rank['species']:.6f}; binning: "
        f"{own}/{len(src)} source reads to their genome's taxid, "
        f"{junk_in}/{len(junk)} junk {'pairs' if paired else 'reads'} "
        f"binned"
        + (f", {junk_bad} outside the 40 source genomes" if paired else ""))
    return {"references": len(pct), "own": own / len(src),
            "junk": junk_in / len(junk) if junk else 0.0}


def phase_pipeline(single_tsv: str, single_reads: str, paired_tsv: str,
                   paired_reads: str, pool, n_genomes: int,
                   smi: str) -> dict:
    """Phase 10: the TSVs that phases 4 and 7 wrote on the card through the
    port's ``merge`` and ``profile`` (python -m kmcp_tpu_torch's entry
    point, in process): (a) ``profile -T -X -C -M -B`` of each; (b)
    ``--low-mem`` with a small parse chunk, byte-identical to (a); (c)
    phase 4's TSV split into two shards by target, merged back: the same
    rows (hits included), descending score within each query, and the
    profile of (a) byte for byte.  Prints the host seconds by stage."""
    from kmcp_tpu_torch.cli import main as cli

    root = os.path.join(SCRATCH, "pipeline")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    tax, tmap = write_taxdump(root, n_genomes)
    common = ["-q", "profile", "-m", PROFILE_MODE, "-T", tmap, "-X", tax]
    reports = ("profile", "cami.profile", "metaphlan.profile")
    times: dict = {}

    def profile(name: str, tsv: str, binning: bool = True,
                extra=()) -> dict:
        d = os.path.join(root, name)
        os.makedirs(d)
        out = {k: os.path.join(d, k) for k in reports}
        args = [*common, *extra, tsv, "-o", out["profile"],
                "-C", out["cami.profile"], "-M", out["metaphlan.profile"]]
        if binning:
            out["binning"] = os.path.join(d, "b.binning.gz")
            args += ["-B", out["binning"]]
        acc: dict = {}
        t0 = time.time()
        with host_stage_timers(acc):
            if cli(args):
                raise RuntimeError(f"phase 10 profile {name} failed")
        acc["wall"] = time.time() - t0
        acc["binning_and_rest"] = acc["wall"] - sum(
            v for k, v in acc.items()
            if k.startswith(("parse", "stages_", "write_")))
        times[name] = acc
        out["cami"] = out["cami.profile"]
        return out

    def same_reports(tag: str, a: dict, b: dict):
        for k in reports:
            if read_text(a[k]) != read_text(b[k]):
                raise AssertionError(f"phase 10 {tag}: {k} differs")

    stats = {}
    for name, tsv, reads in (("single", single_tsv, single_reads),
                             ("paired", paired_tsv, paired_reads)):
        out = profile(name, tsv)
        out["reads"] = reads
        stats[name] = check_profile(f"phase 10 (a) {name}", out, pool, tax,
                                    tmap, tsv, paired=name == "paired")
        os.environ["KMCP_TPU_PARSE_CHUNK"] = str(LOW_MEM_CHUNK)
        try:
            low = profile(f"{name}.low_mem", tsv, binning=False,
                          extra=["--low-mem"])
        finally:
            del os.environ["KMCP_TPU_PARSE_CHUNK"]
        same_reports(f"(b) {name} --low-mem", out, low)
        stats[name]["out"] = out
    log(f"phase 10 (b): --low-mem (KMCP_TPU_PARSE_CHUNK={LOW_MEM_CHUNK}) "
        "profiles byte-identical to (a), single-end and paired")

    shards = split_by_target(single_tsv, root, n_genomes // 2)
    merged = os.path.join(root, "merged.tsv")
    acc: dict = {}
    t0 = time.time()
    with host_stage_timers(acc):
        if cli(["-q", "merge", *shards, "-o", merged]):
            raise RuntimeError("phase 10 merge failed")
    acc["wall"] = time.time() - t0
    times["merge"] = acc
    rows, unsplit = tsv_rows(merged), tsv_rows(single_tsv)
    if sorted(rows) != sorted(unsplit):
        raise AssertionError("phase 10 (c): merged rows differ from the "
                             "unsplit TSV's")
    prev = None
    for r in rows:
        c = r.split("\t")
        if prev is not None and prev[0] == c[14] and float(c[11]) > prev[1]:
            raise AssertionError(f"phase 10 (c): query {c[0]} not in "
                                 "descending qCov")
        prev = (c[14], float(c[11]))
    m = profile("merged", merged)
    same_reports("(c) merged", stats["single"]["out"], m)
    if read_text(m["binning"]) != read_text(stats["single"]["out"]["binning"]):
        raise AssertionError("phase 10 (c): binning differs")
    log(f"phase 10 (c): 2 shards ({len(tsv_rows(shards[0]))} + "
        f"{len(tsv_rows(shards[1]))} rows) merged back to the {len(rows)} "
        "rows of phase 4's TSV (hits included), descending qCov within each "
        "query; its profile, CAMI, MetaPhlAn and binning byte-identical to "
        "(a)'s")
    for name, acc in times.items():
        log(f"phase 10 {name} stages (host clock, s; {smi}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in acc.items()))
    return {"times": times,
            "stats": {k: {a: b for a, b in v.items() if a != "out"}
                      for k, v in stats.items()}}


def main() -> int:
    t_start = time.time()
    import torch

    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: this test needs one card",
              file=sys.stderr)
        return 1
    smi = nvidia_smi()
    log(f"phase 1 device: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda", 0)

    sys.path.insert(0, ROOT)
    from kmcp_tpu_torch.kernels import _build

    t0 = time.time()
    _build.get_lib()
    ptxas = [line.strip() for line in _build.build_log.splitlines()
             if "registers" in line or "spill" in line]
    log(f"phase 2 build: {time.time() - t0:.1f} s (nvcc "
        f"{_build.build_seconds if _build.build_seconds is not None else 0:.1f}"
        f" s); ptxas: {' | '.join(ptxas)}")

    walls: dict = {}
    t0 = time.time()
    kern = phase_kernels(torch, dev)
    kern.update(phase_pass2(torch, dev))
    walls["3 kernels"] = time.time() - t0

    os.makedirs(SCRATCH, exist_ok=True)
    t0 = time.time()
    wide_db, genomes = build_db("wide", WIDE_GENOMES, WIDE_CHUNKS, 1000, 1, 42)
    build_s = time.time() - t0
    wide_reads = os.path.join(SCRATCH, "wide.reads.fq")
    wide_source, pool = write_reads(wide_reads, genomes, 7)
    pair_files = (os.path.join(SCRATCH, "pairs.r1.fq"),
                  os.path.join(SCRATCH, "pairs.r2.fq"))
    pair_source = write_pairs(*pair_files, genomes, 7, WIDE_CHUNKS)
    del genomes
    log(f"phase 4 DB: {WIDE_GENOMES * WIDE_CHUNKS} targets built in "
        f"{build_s:.1f} s")
    wide = phase_main_path(torch, dev, "phase 4 wide", wide_db, wide_reads,
                           wide_source, "plain", timed=True)
    walls["4 wide"] = time.time() - t0

    t0 = time.time()
    narrow_db, genomes = build_db("narrow", NARROW_GENOMES, NARROW_CHUNKS,
                                  680_000, 3, 43)
    reads = os.path.join(SCRATCH, "narrow.reads.fq")
    n_source, _ = write_reads(reads, genomes, 8)
    del genomes
    log(f"phase 5 DB: {NARROW_GENOMES * NARROW_CHUNKS} targets, 3 hashes, "
        f"built in {time.time() - t0:.1f} s")
    narrow = phase_main_path(torch, dev, "phase 5 narrow", narrow_db, reads,
                             n_source, "cpu")
    walls["5 narrow"] = time.time() - t0

    t0 = time.time()
    screened = phase_screened(torch, dev, os.path.join(SCRATCH, "wide", "ks"),
                              wide_reads, wide_source)
    walls["6 screened"] = time.time() - t0

    t0 = time.time()
    paired = {
        "dense": phase_paired(torch, dev, "dense", wide_db, *pair_files,
                              pair_source, screened=False),
        "screened": phase_paired(torch, dev, "screened", screened["db"],
                                 *pair_files, pair_source, screened=True),
    }
    walls["7 paired"] = time.time() - t0

    genome_src = os.path.join(SCRATCH, "wide", "genomes")
    t0 = time.time()
    sketch = phase_sketch(torch, dev, genome_src, pool, wide_reads,
                          wide_source)
    walls["8 sketch"] = time.time() - t0
    t0 = time.time()
    engine = phase_engine(torch, dev, genome_src, pool, wide_db,
                          screened["db"], wide_reads, pair_files)
    walls["9 engine"] = time.time() - t0
    t0 = time.time()
    phase_pipeline(wide["out"], wide_reads, paired["dense"]["out"],
                   pair_files[0], pool, WIDE_GENOMES, smi)
    walls["10 pipeline"] = time.time() - t0
    for name, w in walls.items():
        log(f"phase {name}: {w:.1f} s")

    sources = {
        "hash_loc": ("kmcp_tpu_torch/csrc/hash_loc.cu",
                     "kmcp_tpu/search/pallas_hash.py:36"),
        "count_mask": ("kmcp_tpu_torch/csrc/count_mask.cu",
                       "kmcp_tpu/search/pallas_count.py:146,363,488"),
        "pair_count": ("kmcp_tpu_torch/csrc/pair_count.cu",
                       "kmcp_tpu/search/pallas_count.py:658"),
        "group_count": ("kmcp_tpu_torch/csrc/group_count.cu",
                        "kmcp_tpu/search/pallas_count.py:823"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        rows = kern[name]
        by_path = {"phase 4 wide": wide["launches"][name],
                   "phase 5 narrow": narrow["launches"][name],
                   **{f"phase 6 {p}": n[name]
                      for p, n in screened["launches"].items()},
                   **{f"phase 7 {p}": r["launches"][name]
                      for p, r in paired.items()},
                   **{f"phase 8 {p}": n[name]
                      for p, n in sketch["launches"].items()},
                   **{f"phase 9 {p}": n[name]
                      for p, n in engine["launches"].items()}}

        def timed(r) -> dict:
            # only K6' has a one-call library counterpart; K1''s ms is the
            # device time a launch, with the time of one call beside it
            out = {"shape": r[0], "ms": r[2], "plain_ms": r[3],
                   "bound_ms": r[4][0], "bound_by": r[4][1],
                   "library_ms": r[6] if len(r) > 6 else None}
            if name == "hash_loc":
                out["call_ms"] = r[5]
            return out

        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r[1] for r in rows), **timed(rows[0]),
        }
        if name in ("pair_count", "group_count"):  # the whole route too
            entry["route_ms"] = rows[0][5]
        entry["more"] = [timed(r) for r in rows[1:]]
        kernels.append(entry)
    log(f"smoke wall {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
