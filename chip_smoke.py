#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kmcp_tpu_torch) on one GPU.

Drives the port's main paths, single-end streaming search over a
single-block DB and over a multi-block ``--block-screen --uniform-sigs`` DB
(the two-pass screened search), read pairs, sketch DBs, the searches
the object engine runs, the host backend and host hashing, through the
entry points a user calls
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
     2^25-row union table, single-end; and the paired dense tail's read
     chunk of 300-window joined rows over the wide rows, on bits whose
     counts pass 255, and paired pass 1: the 9-plane counter), and the
     screened pass-2 kernels K5' pair_count and K6' group_count at 32 and
     128 blocks of 4,096 targets (random bits, 3,578 rows per block, 20,480
     and 36,864 pairs of a 16,384-read batch, 140 and 300 windows a read),
     each exactly equal to its plain PyTorch version (K6' also to K5''s
     counts and mask); CUDA event times, median of 5 after a warm-up, of the
     kernels (their block sort included), the plain versions and each
     pass-2 route as the tail runs it (kernel + compaction); each kernel's
     bound (``bound``) from this run's inputs; and for K6' the one PyTorch
     call that computes the same grouped product (``torch._grouped_mm`` in
     bf16), timed as a yardstick and used nowhere in the port; and K2' and
     K5' at a real KMCP DB's row count (2^20 rows, GTDB r202's mean chunk
     at ``index -f 0.3``, and 16,000: kmcp_tpu_torch/tools/tall_ab.py's
     shapes, bits made on the card), each with the variant it ran, its
     bound over the rows its locations touch and the ratio;
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
     the counts, host extraction, writer); and the 4,096 reads on phase
     6's DB with ``KMCP_TPU_NO_SCREEN=1``: the streamer declines it, the
     object engine counts every block (K2' only, no union packing), the
     TSV byte-identical to ``--backend host``'s (HostDB without unions);
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
     kernel;
 11. multi-device search (kmcp_tpu_torch.parallel): ranks spawned on the
     card, (a) a world of one on nccl, mesh (1, 1): the fused dense search
     (K1' + K2') on phase 4's DB and the screened search (K1' + K2' pass 1
     + K5') on phase 6's DB, phase 4's reads in the streamer's 16,384-read
     batches; (b) four ranks sharing cuda:0 over gloo, meshes (1, 4), (2,
     2) and (4, 1): the same searches, at (1, 4) also K6' as pass 2, the
     host-location step on phase 5's DB (5 words padded to 8) and one of
     its batches from a budget of 8 that must overflow and retry; every
     rank's (meta, aux) byte-identical to the single-device TorchDeviceDB
     on the same batch, every rank's launches of each kernel of its path
     above 0; each configuration's walls, launches and summed CUDA-event
     kernel times by rank (not scale-out numbers: the ranks share one
     card).
 12. batches in flight (the streamer's flush/drain pipeline, no DB built):
     (a) wide-131k, screened-131k with pass2 "auto" and "gemm",
     paired-131k, paired-screened-131k and sketch-minimizer-16k (phases 4,
     6, 7 and 8's DBs and reads) through ``run_search`` at ``in_flight`` 1
     and 4, each TSV byte-identical to the other depth's and to its
     phase's plain-version run, every kernel of its path launched; the
     untimed walls, e2e rates and peak device memory
     (``max_memory_allocated``) at both depths, in this call; (b) the
     first 16,384-query batch of every tail (dense, narrow 3-hash, paired
     dense, screened on K5' and on K6', paired screened, minimizer)
     flushed under ``torch.cuda.set_sync_debug_mode("error")`` (none may
     make the host wait), then drained; (c) wide-131k from a candidate
     budget of 8 with 4 batches in flight: the plain run's bytes, each
     batch retried at 4x; (d) the card's busy share (the union of its
     kernel and copy intervals over the wall) in one ``torch.profiler``
     run of wide-131k at depth 4.
 13. the host backend and host hashing on the card: (a) ``run_search`` with
     ``SearchOptions(backend="host")`` (``HostDB``, the C++ counters) on
     phase 4's, phase 5's, phase 6's and phase 7's DBs and reads, each TSV
     byte-identical to that phase's card TSV, no kernel launched and no
     tensor left on the card; (b) a multi-block DB without union screens,
     2 hashes (phase 4's k-mer sets of 256 genomes indexed into 4 blocks
     of 4,096 targets) and 4,096 of phase 4's reads: the host streamer and
     the host engine's ``--low-mem`` row seek each byte-identical to the
     card's object engine (K2'); (c) phase 8's minimizer DB and 4,096 of
     phase 7's pairs: the host streamer (mates hashed as separate rows)
     byte-identical to the card's object engine; (d) with
     ``KMCP_TPU_DEVICE_HASH=0`` (the C++ hashes, K2' counts) phase 4's and
     phase 5's searches at depths 1 and 4, in turns with the device-hash
     run: every TSV the phase's card TSV, K1' launched by the device-hash
     runs only, K2' by all; walls and rates beside the card's name and
     power limit and the host's cores and OpenMP threads.
 14. tall rows: phase 4's k-mer files indexed again at ``-f 0.01`` (about
     127k rows a block, built beside phase 6's DB) as one block and as 32
     screened blocks; 16,384 of phase 4's reads and of phase 7's pairs
     searched on each, stage-timed, each TSV byte-identical to the
     plain-kernel run on the card and to ``--backend host``, K2' and K5'
     on the row ring (launches by variant; the gather only for pass 1's
     one-word union rows), their launches' summed bounds, and a
     ``pass2="gemm"`` search at these rows.
Phase 3 also times K5' and K6' at the screened tail's padded pair budget
(a 16,384-read batch's slots, padding pairs of block nb), exact against
their plain versions there.  The stage-timed reruns of phases 4-8
synchronise around every stage, which serialises the batches in flight;
their e2e rates come from the untimed runs.
Every main-path run sets all four kernels' launch counts (and K2''s and
K5''s by variant) to 0 just before it and reads them just after (phase
11: every job on every rank; phase 12: every run of (a); phases 13 and
14: every run).  The DBs that phases 6, 8 and 14 build from the same
inputs are built at once, by one ``python -m kmcp_tpu_torch`` process
each.
Then one JSON line of kernel results, the card's name and power limit, and
the last line ``{"ok": true, "device": {...}}``.

Usage (from the repository root; one CUDA card):  python3 chip_smoke.py
Scratch data goes to .smoke/ under the checkout (gitignored).
"""

from __future__ import annotations

import contextlib
import dataclasses
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


# how the stage-timed reruns' numbers read: each wrapped call is
# synchronised, which serialises the streamer's batches in flight
STAGES = ("synchronised host clock around each stage, which serialises the "
          "batches in flight; s")
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
    rows, and of pairs in lmax=320 rows; K2' gets the read chunk the count
    tail launches it on, and pass 1's batch over the union table).  The
    bounds count only the Bloom rows this run's locations touch."""
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
    loc_p, nk_p, loc_up = got_p[:3]
    del pairs, got_p, want_p

    # screened pass 1: K2' over the packed union table of 32 blocks (one
    # word a row, N rows), every read of the batch, floors 0
    union = torch.from_numpy(random_bits(rng, N, 1, 1, 0).view(np.int32)).to(dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    res["count_mask"].append(check_count_mask(
        torch, f"pass1 S={N} h=1 W=1", union, got[2].unsqueeze(2).contiguous(),
        zeros, zeros[:32]))

    # paired rows (K = 300 windows, the 9-plane counter): the dense tail's
    # read chunk over wide-131k's rows, on bits dense enough (7/8) that
    # counts pass 255, with floors on both sides of it; and pass 1 over
    # the union table on the paired screen plane
    W = 4096
    T = 32 * W
    Bc = COUNTS_BYTES // (4 * T)
    bits = torch.from_numpy(
        random_bits(rng, S, W, 0, 2).view(np.int32)).to(dev)
    thr_np = rng.integers(180, 280, T).astype(np.int32)
    thr_np[-7:] = FLOOR_NEVER
    cthr = (200 + nk_p[:Bc] % 64).to(torch.int32)
    cthr[::97] = FLOOR_NEVER
    res["count_mask"].append(check_count_mask(
        torch, f"paired S={S} h=1 W={W}", bits, loc_p[:Bc].contiguous(), cthr,
        torch.from_numpy(thr_np).to(dev)))
    del bits
    res["count_mask"].append(check_count_mask(
        torch, f"pass1 paired S={N} h=1 W=1", union,
        loc_up.unsqueeze(2).contiguous(), zeros, zeros[:32]))
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


# The variant each phase-3 case ran, by its label (the kernels line's
# "variant").
VARIANT_OF: dict = {}


def check_count_mask(torch, label, bits, loc, cthr, thr,
                     plain_reps: int = 5) -> tuple:
    """K2' against its plain version on these inputs -> (label, max abs
    err, ms, plain ms (median of ``plain_reps``), bound); raises unless
    they are equal."""
    from kmcp_tpu_torch.search.count import (
        count_mask, count_mask_plain, count_mask_variant,
    )

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
    ms_p = time_ms(torch, lambda: count_mask_plain(bits, loc, cthr, thr),
                   plain_reps)
    rows = torch.unique(loc).numel()  # the Bloom rows this run reads
    bd = bound(rows * bits.shape[1] * 4 + nbytes(loc, cthr, thr, counts, mask))
    B, K, h = loc.shape
    VARIANT_OF[label] = count_mask_variant(bits.shape[1], bits.shape[0], h)
    log(f"phase 3 count_mask [{label}] B={B} K={K}: exact (max abs err 0, "
        f"{n_set} mask words set); kernel {ms:.3f} ms ({VARIANT_OF[label]} "
        f"variant), plain {ms_p:.3f} ms, bound {bd[0]:.4f} ms ({bd[1]}, "
        f"{rows} rows touched), kernel / bound {ms / bd[0]:.2f}")
    return label, err, ms, ms_p, bd


# K2' and K5' at a real KMCP DB's row count (GTDB r202's mean chunk at
# ``index -f 0.3 -n 1``: about 2^20 rows; tools/gtdb_rehearsal.py) and in
# the range of the TPU's resident row groups (16,000 rows); the shapes of
# kmcp_tpu_torch/tools/tall_ab.py: (id, rows S, words W, hashes h, reads
# B, windows K, density as random_words takes it)
TALL_COUNT_CASES = (
    ("a", 1 << 20, 4096, 1, 2048, 140, -1),
    ("b", 1 << 20, 4096, 1, 2048, 300, 2),
    ("c", 1 << 20, 1024, 3, 8192, 140, 1),
    ("d", 16_000, 4096, 1, 2048, 140, -1),
)
TALL_PAIR_CASES = ((16_000, 140), (16_000, 300), (1 << 20, 140),
                   (1 << 20, 300))  # (s_block, K): 32 blocks, 20,480 pairs


def phase_tall_kernels(torch, dev) -> dict:
    """Phase 3 at tall rows: K2' at cases (a)-(d) and K5' at 32 blocks of
    4,096 targets, 20,480 pairs of a 16,384-read batch, s_block 16,000 and
    2^20, each exact against its plain version, its ms, bound (the rows the
    locations touch), ratio and variant (the plain versions, 0.1-0.7 s a
    call, timed over 2 calls).  Bits, locations and pairs are
    made on the card from a seeded generator (17.2 GB of bits at 2^20
    rows), as tools/tall_ab.py makes them."""
    from kmcp_tpu_torch.search.device_step import FLOOR_NEVER
    from kmcp_tpu_torch.search.pair_count import (
        block_order, pair_count, pair_count_plain, pair_count_variant,
    )
    from kmcp_tpu_torch.tools.tall_ab import (
        PAIR_B, PAIR_BLOCKS, PAIR_P, PAIR_W, floors_near, random_loc,
        random_words,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(2027)
    res = {"count_mask": [], "pair_count": []}
    for cid, S, W, h, B, Kw, dens in TALL_COUNT_CASES:
        bits = random_words(gen, S, W, dens)
        loc = random_loc(gen, (B, Kw, h), S)
        p = 0.5 ** (abs(dens) + 1)
        lo = int(0.95 * Kw * (p if dens < 0 else 1 - p) ** h)
        thr = floors_near(gen, 32 * W, lo, 10)
        thr[-7:] = FLOOR_NEVER
        cthr = floors_near(gen, B, lo, 20)
        cthr[::97] = FLOOR_NEVER
        res["count_mask"].append(check_count_mask(
            torch, f"tall ({cid}) S={S} h={h} W={W}", bits, loc, cthr, thr,
            plain_reps=2))
        del bits, loc
        torch.cuda.empty_cache()
    nb, W, P, B = PAIR_BLOCKS, PAIR_W, PAIR_P, PAIR_B
    for s_block, Kw in TALL_PAIR_CASES:
        bits = random_words(gen, nb * s_block, W, -1 if Kw < 256 else 2)
        loc = random_loc(gen, (B, Kw), s_block)
        flat = torch.randperm(B * nb, device=dev, generator=gen)[:P].sort()[0]
        pb, pg = (flat // nb).to(torch.int32), (flat % nb).to(torch.int32)
        need = Kw // 2 + 2 if Kw < 256 else Kw * 85 // 100
        cthr = torch.full((B,), need, dtype=torch.int32, device=dev)
        cthr[::500] = need // 4
        thr = torch.randint(1, 10, (nb, 32 * W), dtype=torch.int32,
                            device=dev, generator=gen)
        thr[:, -7:] = FLOOR_NEVER
        args = (bits, loc, pb, pg, cthr, thr)
        label = f"tall nb={nb} P={P} s_block={s_block} K={Kw}"
        counts, mask = pair_count(*args)
        want = pair_count_plain(*args)
        torch.cuda.synchronize()
        err = max(max_abs_err(torch, counts, want[0]),
                  max_abs_err(torch, mask, want[1]))
        if err:
            raise AssertionError(f"pair_count {label}: max abs err {err}")
        del want
        ms = time_ms(torch, lambda: pair_count(*args, rows_checked=True))
        ms_p = time_ms(torch, lambda: pair_count_plain(*args), 2)
        sort_ms = time_ms(torch, lambda: block_order(pg, nb))
        rows = torch.unique(pg.long()[:, None] * (s_block + 1)
                            + loc[pb.long()]).numel()
        bd = bound(rows * W * 4 + torch.unique(pb).numel() * (Kw + 1) * 4
                   + nb * 32 * W * 4 + nbytes(pb, pg, counts, mask))
        VARIANT_OF[label] = pair_count_variant(W, s_block)
        log(f"phase 3 pair_count [{label}] W={W}: exact (max abs err 0, "
            f"{int(torch.count_nonzero(mask))} mask words set); kernel "
            f"{ms:.3f} ms ({VARIANT_OF[label]} variant, block sort "
            f"included; the sort alone {sort_ms:.3f} ms), plain "
            f"{ms_p:.3f} ms, bound {bd[0]:.4f} ms ({bd[1]}, {rows} rows "
            f"touched), kernel / bound {ms / bd[0]:.2f}")
        res["pair_count"].append((label, err, ms, ms_p, bd))
        del bits, loc, counts, mask, args
        torch.cuda.empty_cache()
    return res


def phase_pass2(torch, dev) -> dict:
    """Phase 3, screened pass 2: K5' pair_count and K6' group_count against
    their plain versions at 32 and 128 blocks of 4,096 targets (s_block =
    3,578 rows of random bits, 140 windows per read and 300 per joined
    pair, 5% of them invalid),
    on 20,480 and 36,864 read-major pairs of a 16,384-read batch (bits of
    density 1/4, so a pair's counts sit near 33 at 140 windows and 71
    at 300); K6' (the same pairs, the
    same floors) must also equal K5''s counts and mask.  Each kernel is
    also held exact and timed on the pairs padded to the screened tail's
    pair budget (``check_padded``), and each pass-2 route timed whole
    there, as the tail runs it (``screen.pass2_fixed``)."""
    from kmcp_tpu_torch.search import screen
    from kmcp_tpu_torch.search.device_step import FLOOR_NEVER
    from kmcp_tpu_torch.search.group_count import (
        gemm_slabs, group_count, group_count_plain, s_pad_for,
    )
    from kmcp_tpu_torch.search.pair_count import (
        pair_count, pair_count_plain, pair_count_variant,
    )

    rng = np.random.default_rng(2025)
    B, s_block, W = 16_384, 3_578, 128
    S_pad = s_pad_for(s_block)
    res = {"pair_count": [], "group_count": []}
    # windows of a read in the batch's rows: lmax = 160 (single-end) and
    # 320 (joined pairs)
    for Kw, nb, P in [(lmax - K + 1, nb, P) for lmax in (160, 320)
                      for nb, P in PASS2_CASES]:
        as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        bits = as_dev(random_bits(rng, nb * s_block, W, 1, 0).view(np.int32))
        loc_np = rng.integers(0, s_block, (B, Kw)).astype(np.int32)
        loc_np[rng.random((B, Kw)) < 0.05] = s_block  # invalid windows
        loc = as_dev(loc_np)
        flat = np.sort(rng.choice(B * nb, size=P, replace=False))
        pb = as_dev((flat // nb).astype(np.int32))
        pg = as_dev((flat % nb).astype(np.int32))
        # floors as the main path sets them (a 150 bp read needs ~72 of
        # its 140 windows, a pair about half of its 300); one read in 500
        # gets a low floor, so that about half its pairs' targets pass and
        # the mask is not empty
        cthr_np = np.full(B, Kw // 2 + 2, dtype=np.int32)
        cthr_np[rng.random(B) < 0.002] = Kw * 33 // 140
        cthr = as_dev(cthr_np)
        thr_np = rng.integers(1, 10, (nb, 32 * W)).astype(np.int32)
        thr_np[:, -7:] = FLOOR_NEVER  # padding lanes
        thr = as_dev(thr_np)
        label = f"nb={nb} P={P} K={Kw}"
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
        pad, (pbp, pgp) = check_padded(
            torch, f"pair_count {label}", "pair", B, nb, pb, pg, counts,
            mask, lambda b, g, **kw: pair_count(bits, loc, b, g, cthr, thr,
                                                **kw),
            lambda b, g: pair_count_plain(bits, loc, b, g, cthr, thr))
        route = time_ms(torch, lambda: screen.pass2_fixed(
            "pair", bits, None, loc, pbp, pgp, cthr, thr, s_block, 2 * B,
            chunk))
        # each pair reads its read's locations and the block rows they hit
        reads_used = torch.unique(pb).numel()
        blocks_used = torch.unique(pg).numel()
        rows = torch.unique(pg.long()[:, None] * (s_block + 1)
                            + loc[pb.long()]).numel()
        bd = bound(rows * W * 4 + reads_used * (Kw + 1) * 4
                   + blocks_used * 32 * W * 4 + nbytes(pb, pg, counts, mask))
        VARIANT_OF[label] = pair_count_variant(W, s_block)
        log(f"phase 3 pair_count [{label}] s_block={s_block} W={W} K={Kw}: "
            f"exact (max abs err 0, {n_set} mask words set); kernel "
            f"{ms:.3f} ms (block sort included), plain {ms_p:.3f} ms, bound "
            f"{bd[0]:.4f} ms ({bd[1]}); at the tail's padded pair budget "
            f"({pad['slots']} slots, {P} real): kernel {pad['ms']:.3f} ms, "
            f"route (K5' + compaction to a budget of {2 * B} + splice) "
            f"{route:.3f} ms")
        res["pair_count"].append((label, err, ms, ms_p, bd, route, None,
                                  pad))

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
        pad6, (pbp, pgp) = check_padded(
            torch, f"group_count {label}", "gemm", B, nb, pb, pg, *got,
            lambda b, g, **kw: group_count(bits01, loc, b, g, cthr, thr,
                                           s_block, **kw),
            lambda b, g: group_count_plain(bits01, loc, b, g, cthr, thr,
                                           s_block))
        route6 = time_ms(torch, lambda: screen.pass2_fixed(
            "gemm", None, bits01, loc, pbp, pgp, cthr, thr, s_block,
            pad6["budget"], chunk))
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
            f"err {lib_err} vs K6'); at the tail's padded pair budget "
            f"({pad6['slots']} slots, {P} real; candidate budget "
            f"{pad6['budget']}): kernel {pad6['ms']:.3f} ms, route (K6' + "
            f"compaction + splice) {route6:.3f} ms")
        res["group_count"].append((label, err6, ms6, ms6_p, bd, route6,
                                   lib_ms, pad6))
        del bits, bits01, got, counts, mask
        torch.cuda.empty_cache()
    return res


def check_padded(torch, label, pass2, B, nb, pb, pg, counts, mask, kernel,
                 plain) -> tuple[dict, tuple]:
    """A pass-2 kernel on the read-major pairs padded to the slots the
    screened tail gives a 16,384-read batch (``screen.pair_budget_for`` at
    the first candidate budget, 2 B, or at the first 4x retry's that holds
    the pairs), padding as ``screen.pair_list`` leaves it (pb = B - 1, pg =
    nb): its mask must equal the plain version's (0 on padding rows) and
    its real rows the unpadded launch's counts and mask -> ({"pairs",
    "slots", "budget", "ms": the padded launch's median}, (pb, pg)
    padded)."""
    from kmcp_tpu_torch.search import screen

    P = pb.shape[0]
    budget = 2 * B
    while screen.pair_budget_for(B, nb, budget, pass2) < P:
        budget *= 4
    slots = screen.pair_budget_for(B, nb, budget, pass2)
    pbp = torch.cat([pb, pb.new_full((slots - P,), B - 1)])
    pgp = torch.cat([pg, pg.new_full((slots - P,), nb)])
    got = kernel(pbp, pgp)
    want = plain(pbp, pgp)
    torch.cuda.synchronize()
    err = max(max_abs_err(torch, got[1], want[1]),
              max_abs_err(torch, got[0][:P], want[0][:P]),
              max_abs_err(torch, got[0][:P], counts),
              max_abs_err(torch, got[1][:P], mask))
    if err or got[1][P:].any():
        raise AssertionError(f"{label} padded to {slots}: max abs err {err}")
    del got, want
    ms = time_ms(torch, lambda: kernel(pbp, pgp, rows_checked=True))
    return {"pairs": P, "slots": slots, "budget": budget, "ms": ms}, (pbp,
                                                                      pgp)


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


def counted_run(fn, *args, **kwargs):
    """fn(*args, **kwargs) with every kernel's launch count set to 0 just
    before it -> (its result, the launches it made, its wall seconds)."""
    from kmcp_tpu_torch.parallel.dryrun import kernel_wrappers

    kernels = kernel_wrappers()
    for k in kernels.values():
        k.launches = 0
        for v in getattr(k, "by_variant", {}):
            k.by_variant[v] = 0
    t0 = time.time()
    out = fn(*args, **kwargs)
    wall = time.time() - t0
    return out, {n: k.launches for n, k in kernels.items()}, wall


def variant_launches() -> dict:
    """K2''s and K5''s launches by variant since the last counted_run
    ("count_mask/ring": n, ...), the variants that launched only."""
    from kmcp_tpu_torch.parallel.dryrun import kernel_wrappers

    return {f"{n}/{v}": c for n, k in kernel_wrappers().items()
            for v, c in getattr(k, "by_variant", {}).items() if c}


def searched(db: str, out: str, **kwargs) -> dict:
    """run_search(db, out_file=out, **kwargs) as counted_run runs it ->
    its TSV bytes, ``out``, stats, wall seconds, (total, matched),
    launches and K2''s and K5''s launches by variant."""
    from kmcp_tpu_torch.commands.search import run_search

    stats: dict = {}
    totals, launches, wall = counted_run(run_search, db, out_file=out,
                                         verbose=False, stats=stats, **kwargs)
    with open(out, "rb") as f:
        tsv = f.read()
    return {"tsv": tsv, "out": out, "stats": stats, "wall": wall,
            "totals": totals, "launches": launches,
            "variants": variant_launches()}


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
        log(f"{label} stages ({STAGES}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
            + f"; run_search wall {wall:.3f}; steady {total / steady:.1f} "
            "reads/s (without engine open and streamer set-up)")
    return {"launches": launches, "device_rps": total / dev_s,
            "retries": stats["retries"], "out": out_dev, "ref": out_ref}


@contextlib.contextmanager
def stage_timers(torch, acc: dict):
    """Time a search's stages on a synchronised host clock, by wrapping
    the functions it calls: the DB set-up (host arrays, of which the union
    screens' packing, then the upload; the engine's open and check before
    it, and the streamer set-up around it), the device hash, a sketch
    DB's window selection, the paired mode's dedup, the dense tail with
    its K2' launches and compaction, or the screened pass 1, pair list,
    pass-2 kernels and whole pass-2 routes, the packing, the dispatch of
    the D2H copy, and the TSV writer.  The synchronisation around every
    wrapped call serialises the streamer's batches in flight, so a timed
    run's wall is not the pipeline's: e2e rates come from untimed runs;
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
               (device, "count_tail_async", "dense_tail"),
               (device_step, "count_mask", "dense_count_kernel"),
               (device_step, "compact_candidates", "dense_compaction"),
               (device_step, "dedup_planes", "dedup"),
               (screen, "dedup_planes", "dedup"),
               (screen, "active_mask", "pass1"),
               (screen, "pair_list", "pair_list"),
               (screen, "pair_count", "pass2_kernel"),
               (screen, "group_count", "pass2_kernel"),
               (screen, "pass2_fixed", "pass2_route"),
               (device_step, "pack_result", "pack"),
               (screen, "pack_result_split", "pack"),
               (device, "_copy_async", "d2h"),
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


def index_dbs(ks: str, jobs: dict) -> float:
    """Index phase 4's k-mer files ``ks`` into each DB of ``jobs`` (out
    dir -> the ``index`` options after ``-I ks -O out``), all at once
    (``run_all``: each reads all 131,072 k-mer files); returns the wall
    seconds."""
    t0 = time.time()
    run_all([["index", "-I", ks, "-O", db, *opts, "--force"]
             for db, opts in jobs.items()])
    return time.time() - t0


SCREENED_OPTS = ["-n", "1", "-f", "0.3", "--tpu-native",
                 "--native-block-targets", str(BLOCK_TARGETS),
                 "--block-screen", "--uniform-sigs"]


def phase_screened(torch, dev, db: str, index_s: float, reads: str,
                   n_source: int) -> dict:
    """Phase 6: the screened main path on a 32-block DB of phase 4's
    chunks (``db``, indexed in ``index_s`` beside phase 14's DBs),
    pass2="gemm", "pair" and "auto" on the card against the same path with
    the kernels bound to their plain versions on the card (pass2="pair");
    then a stage-timed run of the gemm and pair routes."""
    from kmcp_tpu_torch.search.engine import SearchOptions
    from kmcp_tpu_torch.search.screen import pass2_kernel

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
        f"screen {st['union_rows']} rows; indexed in {index_s:.1f} s, "
        "beside phase 14's two DBs")
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
        log(f"phase 6 stages {p2} ({STAGES}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
            + f"; run_search wall {run['wall']:.3f}")
    return {"launches": {p: r["launches"] for p, r in runs.items()},
            "breakdown": breakdown, "db": db, "ref": ref["out"]}


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
    log(f"{tag} stages ({STAGES}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
        + f"; run_search wall {timed['wall']:.3f}; steady "
        f"{N_READS / steady:.1f} pairs/s (without engine open and streamer "
        "set-up)")
    return {"launches": la, "breakdown": acc, "out": run["out"],
            "ref": ref["out"]}


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


def run_all(cmds: list[list[str]]) -> None:
    """The port's command lines ``python -m kmcp_tpu_torch <cmd>``, all
    started at once (DB builds, which nothing else overlaps); raises if
    one fails."""
    procs = [(cmd, subprocess.Popen(
        [sys.executable, "-m", "kmcp_tpu_torch", "-q", *cmd], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in cmds]
    for cmd, p in procs:
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{cmd[0]} failed: {cmd}\n{out}")


SKETCH_KINDS = {"minimizer": ["-W", "5"], "syncmer": ["-S", "11"]}


def sketch_dbs(gdir: str) -> tuple[dict, float]:
    """A "minimizer" (compute -W 5) and a "syncmer" (-S 11) DB of the
    genomes in ``gdir`` x 64 chunks, k = 21, one block (-n 1 -f 0.3
    --tpu-native), through the port's command line, the two built at once
    -> ({kind: DB}, wall seconds)."""
    t0 = time.time()
    root = os.path.join(SCRATCH, "sketch")
    run_all([["compute", "-I", gdir, "-O", os.path.join(root, kind, "ks"),
              "-k", str(K), *flag, "-n", str(WIDE_CHUNKS), "-l",
              str(READ_LEN), "--force"]
             for kind, flag in SKETCH_KINDS.items()])
    dbs = {kind: os.path.join(root, kind, "db") for kind in SKETCH_KINDS}
    run_all([["index", "-I", os.path.join(root, kind, "ks"), "-O", db, "-n",
              "1", "-f", "0.3", "--tpu-native", "--native-block-targets",
              str(SKETCH_GENOMES * WIDE_CHUNKS), "--force"]
             for kind, db in dbs.items()])
    return dbs, time.time() - t0


def sketch_genomes(genome_src: str, pool) -> str:
    """Phase 8's genome directory: SKETCH_GENOMES of phase 4's genomes,
    its 40 source genomes among them."""
    return link_genomes(os.path.join(SCRATCH, "sketch", "genomes"),
                        genome_src, genome_subset(pool, SKETCH_GENOMES))


def phase_sketch(torch, dev, genome_src: str, pool, reads: str,
                 n_source: int) -> dict:
    """Phase 8: a minimizer (compute -W 5) and a closed-syncmer (-S 11) DB
    of SKETCH_GENOMES of phase 4's genomes (its 40 source genomes among
    them) x 64 chunks, k = 21, one block (-n 1 -f 0.3 --tpu-native);
    phase 4's reads streamed on the card (K1' at k with values, at k = s
    for syncmers, the window selection, the dense tail) against the same
    path with the kernels bound to their plain versions on the card; then
    a stage-timed rerun."""
    dbs, build_s = sketch_dbs(sketch_genomes(genome_src, pool))
    out = {"launches": {}, "breakdown": {}, "db": {}, "ref": {}}
    for kind, db in dbs.items():

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
            f"{st['rows']} Bloom rows x {st['words']} words, built beside "
            f"the other sketch DB in {build_s:.1f} s; TSV byte-identical to "
            "the plain run "
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
        log(f"{tag} stages ({STAGES}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
            + f"; run_search wall {timed['wall']:.3f}; steady "
            f"{N_READS / steady:.1f} reads/s (without engine open and "
            "streamer set-up)")
        out["launches"][kind] = la
        out["breakdown"][kind] = acc
        out["db"][kind] = db
        out["ref"][kind] = ref["out"]
    return out


@contextlib.contextmanager
def env_var(name: str, value: str):
    """The environment variable ``name`` set to ``value`` for the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


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
    then a stage-timed rerun of each; and ENGINE_READS of phase 4's reads
    on the screened DB with ``KMCP_TPU_NO_SCREEN=1`` (route "engine", K2'
    and no other kernel, HostDB without its unions), byte-identical to
    ``--backend host``'s run under the same variable."""
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

    # KMCP_TPU_NO_SCREEN turns the union screens off (ROADMAP C1): the
    # streamer declines phase 6's DB, so the object engine counts all 32
    # blocks with K2', as --backend host's HostDB does without its unions
    tag = "phase 9 no-screen"
    with env_var("KMCP_TPU_NO_SCREEN", "1"):
        run = searched(screened_db, os.path.join(root, "no-screen.cuda.tsv"),
                       files=[few], device=dev)
        host = host_searched(torch, f"{tag} host", screened_db,
                             os.path.join(root, "no-screen.host.tsv"),
                             files=[few])
    la = run["launches"]
    if run["stats"]["route"] != "engine" or host["stats"]["route"] != "stream":
        raise AssertionError(f"{tag}: routes {run['stats']['route']}, "
                             f"host {host['stats']['route']}")
    if (dev.type == "cuda" and not la["count_mask"]) or any(
            la[n] for n in ("hash_loc", "pair_count", "group_count")):
        raise AssertionError(f"{tag}: launches {la}")
    if host["stats"]["union_rows"]:
        raise AssertionError(f"{tag}: HostDB kept its unions")
    if run["tsv"] != host["tsv"] or run["totals"] != host["totals"]:
        raise AssertionError(f"{tag}: TSV differs from --backend host's")
    log(f"{tag}: route engine, TSV byte-identical to --backend host's "
        f"(HostDB without its unions; {len(run['tsv'])} bytes, "
        f"{run['totals'][1]}/{run['totals'][0]} reads matched); "
        f"wall {run['wall']:.3f} s, host {host['wall']:.3f} s; "
        f"launches {la}")
    out["launches"]["no-screen"] = la
    return out


# ------------------------------------------------------------- phase 14
# tall rows: phase 4's k-mer files at -f 0.01

TALL_FPR = "0.01"
TALL_EVERY = 4  # every 4th read or pair: 16,384 of phase 4's and 7's


@contextlib.contextmanager
def bound_recorder(torch, acc: dict):
    """Record, beside the stage timers, each K2' launch of the dense tail
    and each K5' launch of pass 2: acc["count_mask_bound_s"] and
    acc["pair_count_bound_s"] sum the bound of each launch (the rows its
    locations touch read once, every other input and output once, at the
    card's memory rate), acc["count_mask_calls"] / ["pair_count_calls"]
    count them.  The row counts are taken outside the timed calls."""
    from kmcp_tpu_torch.search import device_step, screen

    saved = (device_step.count_mask, screen.pair_count)

    def count(bits, loc, cthr, thr, rows_checked=False):
        out = saved[0](bits, loc, cthr, thr, rows_checked=rows_checked)
        rows = torch.unique(loc).numel()
        n = rows * bits.shape[1] * 4 + nbytes(loc, cthr, thr, *out)
        acc["count_mask_bound_s"] = (acc.get("count_mask_bound_s", 0.0)
                                     + n / HBM_BYTES_PER_S)
        acc["count_mask_calls"] = acc.get("count_mask_calls", 0) + 1
        return out

    def pair(bits, loc, pb, pg, cthr, thr, rows_checked=False):
        out = saved[1](bits, loc, pb, pg, cthr, thr, rows_checked=rows_checked)
        nb = thr.shape[0]
        s_block = (bits.shape[0] - 1) // nb
        real = pg < nb
        rows = torch.unique(pg[real].long()[:, None] * (s_block + 1)
                            + loc[pb[real].long()]).numel()
        n = (rows * bits.shape[1] * 4 + torch.unique(pb[real]).numel()
             * (loc.shape[1] + 1) * 4 + nbytes(thr, pb, pg, *out))
        acc["pair_count_bound_s"] = (acc.get("pair_count_bound_s", 0.0)
                                     + n / HBM_BYTES_PER_S)
        acc["pair_count_calls"] = acc.get("pair_count_calls", 0) + 1
        return out

    device_step.count_mask, screen.pair_count = count, pair
    try:
        yield
    finally:
        device_step.count_mask, screen.pair_count = saved


TALL_OPTS = {
    "dense": ["-n", "1", "-f", TALL_FPR, "--tpu-native",
              "--native-block-targets", str(WIDE_GENOMES * WIDE_CHUNKS)],
    "screened": ["-n", "1", "-f", TALL_FPR, "--tpu-native",
                 "--native-block-targets", str(BLOCK_TARGETS),
                 "--block-screen", "--uniform-sigs"],
}


def tall_db(name: str) -> str:
    return os.path.join(SCRATCH, "tall", f"{name}.db")


def phase_tall(torch, dev, index_s: float, reads: str, pair_files) -> dict:
    """Phase 14 ("tall"): phase 4's k-mer files indexed again at ``-f
    0.01`` (a row count of a real KMCP DB: about 127k rows a block, where
    K2' and K5' take the row ring) as (i) one ``--tpu-native`` block of
    131,072 targets and (ii) ``--block-screen --uniform-sigs``, 32 blocks
    of 4,096 (``tall_db``, built beside phase 6's DB in ``index_s``);
    every 4th of phase 4's reads and of phase 7's pairs (16,384 each)
    searched on each DB on the card with stage timers, each TSV
    byte-identical to the same search with the kernels bound to their
    plain versions on the card and to ``--backend host``, every source
    read's best hit its genome; K2' and K5' launched on the ring (the
    gather only for pass 1's one-word union rows), K2''s and K5''s summed
    bounds beside their timed launches; and a ``pass2="gemm"`` search of
    (ii) (K6' at these rows) the plain run's bytes."""
    root = os.path.join(SCRATCH, "tall")
    sub = os.path.join(root, "reads.fq")
    fastq_every(reads, sub, TALL_EVERY)
    subp = (os.path.join(root, "pairs.r1.fq"),
            os.path.join(root, "pairs.r2.fq"))
    for src, dst in zip(pair_files, subp):
        fastq_every(src, dst, TALL_EVERY)
    n = N_READS // TALL_EVERY
    n_src = {"reads": 0, "pairs": 0}
    for kind, path in (("reads", sub), ("pairs", subp[0])):
        with open(path) as f:
            n_src[kind] = sum(1 for i, line in enumerate(f)
                              if i % 4 == 0 and line.startswith("@r"))
    dbs = {name: (tall_db(name), index_s) for name in TALL_OPTS}

    out = {"launches": {}, "variants": {}, "stages": {}}
    for (name, (db, index_s)), (kind, query) in [
            (d, q) for d in dbs.items()
            for q in (("reads", {"files": [sub]}),
                      ("pairs", {"read1": subp[0], "read2": subp[1]}))]:
        tag = f"phase 14 {name} {kind}"
        path = os.path.join(root, f"{name}.{kind}")

        def search(which: str, **kw) -> dict:
            return searched(db, f"{path}.{which}.tsv", device=dev, **query,
                            **kw)

        acc: dict = {}
        with stage_timers(torch, acc), bound_recorder(torch, acc):
            run = search("cuda", pass2="auto")
        with plain_kernels():
            ref = search("plain", pass2="auto")
        host = host_searched(torch, tag, db, f"{path}.host.tsv", **query)
        if any(ref["launches"].values()):
            raise AssertionError(f"{tag}: the plain run launched a kernel")
        for other, what in ((ref, "the plain run"), (host, "--backend host")):
            if run["tsv"] != other["tsv"] or run["totals"] != other["totals"]:
                raise AssertionError(f"{tag}: TSV differs from {what}")
        if run["totals"][0] != n:
            raise AssertionError(f"{tag}: totals {run['totals']}")
        check_best_hits(run["out"], n_src[kind])
        st, la, va = run["stats"], run["launches"], run["variants"]
        screened = name == "screened"
        rows_block = st["rows"] // st["n_blocks"]
        want = ["hash_loc", "count_mask"] + (["pair_count"] if screened
                                             else [])
        ring = ["count_mask/ring"] if not screened else ["pair_count/ring"]
        # pass 1 counts one-word union rows: the gather; nothing else
        # gathers at these widths
        gathers = {k: c for k, c in va.items() if k.endswith("/gather")}
        idle = dev.type == "cuda" and (
            min(la[k] for k in want) == 0
            or min(va.get(k, 0) for k in ring) == 0)
        if (idle or any(la[k] for k in la if k not in want)
                or (gathers and (not screened or set(gathers)
                                 != {"count_mask/gather"}))
                or st["slow_rows"] or (st["n_blocks"] > 1) != screened):
            raise AssertionError(f"{tag}: launches {la}, variants {va}, "
                                 f"stats {st}")
        if screened and va.get("count_mask/gather", 0) != la["count_mask"]:
            raise AssertionError(f"{tag}: pass 1 variants {va}")
        out["launches"][tag] = la
        out["variants"][tag] = va
        log(f"{tag}: DB {st['n_blocks']} block(s) x {rows_block} Bloom rows "
            f"x {st['words']} words (indexed at -f {TALL_FPR}, three DBs "
            f"at once in {index_s:.1f} s); TSV byte-identical to the plain "
            f"run and to --backend host ({len(run['tsv'])} bytes, "
            f"{run['totals'][1]}/{n} {kind} matched, all {n_src[kind]} "
            f"source {kind} best-hit their genome); run_search wall "
            f"{run['wall']:.3f} s (stage-timed), plain {ref['wall']:.3f} "
            f"s, host {host['wall']:.3f} s; launches {la}, by variant {va}")
        if screened and kind == "reads":
            # a pass2="gemm" request reaches K6' at these rows
            gemm = search("gemm", pass2="gemm")
            if gemm["tsv"] != ref["tsv"] or gemm["stats"]["pass2"] != "gemm" \
                    or (dev.type == "cuda"
                        and gemm["launches"]["group_count"] == 0):
                raise AssertionError(f"{tag} gemm: TSV or launches differ "
                                     f"({gemm['launches']})")
            log(f"{tag} pass2=gemm: K6' at {rows_block} rows a block, TSV "
                f"byte-identical to the plain run; run_search wall "
                f"{gemm['wall']:.3f} s, launches {gemm['launches']}")
        kern = "dense_count_kernel" if not screened else "pass2_kernel"
        which = "count_mask" if not screened else "pair_count"
        calls = acc.pop(f"{which}_calls", 0)
        bound_s = acc.pop(f"{which}_bound_s", 0.0)
        acc.pop("count_mask_calls", None)
        acc.pop("count_mask_bound_s", None)
        if "pass2_route" in acc:
            acc["compaction"] = (acc.pop("pass2_route")
                                 - acc.get("pass2_kernel", 0.0))
        calls = max(calls, 1)
        out["stages"][tag] = {**acc, f"{which}_ms": acc[kern] / calls * 1e3,
                              f"{which}_bound_ms": bound_s / calls * 1e3}
        log(f"{tag} stages ({STAGES}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
            + f"; run_search wall {run['wall']:.3f}; {which} "
            f"{acc[kern] / calls * 1e3:.3f} ms a launch over {calls} "
            f"launches (synchronised host clock), their bound "
            f"{bound_s / calls * 1e3:.4f} ms a launch")
    shutil.rmtree(root, ignore_errors=True)
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


# ------------------------------------------------------------- phase 11
P11_BATCH = 16_384  # the streamer's batch at 131,072 targets (2^31 / T)
P11_MESHES = ((1, 4), (2, 2), (4, 1))
P11_OVERFLOW_BUDGET = 8


def fastq_batches(path: str, n: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """The first n batches of P11_BATCH reads of a FASTQ file as the
    streamer ships them: zero-padded ASCII rows uint8 [B, lmax] (lmax
    rounded up to 32, at least k + 31) and the lengths."""
    from kmcp_tpu_torch.parallel.dryrun import read_matrix

    with open(path, "rb") as f:
        seqs = f.read().split(b"\n")[1::4][: n * P11_BATCH]
    return [read_matrix(seqs[i : i + P11_BATCH])
            for i in range(0, len(seqs), P11_BATCH)]


def p11_jobs(wide, scr, narrow_loc) -> dict:
    """Phase 11's plan: (a) the world of one rank, (b) the world of four.
    A job is (name, db key, pass2, kind, args) as ``mesh_jobs`` takes it."""
    budget = 2 * P11_BATCH  # the streamer's 2 slots a read

    def reads(key, pass2, batches, tag=""):
        return [(f"{key}{tag}.b{i}", key, pass2, "reads",
                 (mat, lens, budget, False))
                for i, (mat, lens) in enumerate(batches)]

    dense_scr = reads("wide", "auto", wide) + reads("scr", "auto", scr)
    plan_b = []
    for shape in P11_MESHES:
        jobs = list(dense_scr)
        if shape == (1, 4):
            jobs += reads("scr", "gemm", scr, ".gemm")
            jobs += [(f"narrow.b{i}", "narrow", "auto", "loc",
                      (loc, nk, budget))
                     for i, (loc, nk) in enumerate(narrow_loc)]
            loc, nk = narrow_loc[0]
            jobs.append(("narrow.over", "narrow", "auto", "loc",
                         (loc, nk, P11_OVERFLOW_BUDGET)))
        plan_b.append((shape, jobs))
    return {"a": ("nccl", 1, [((1, 1), dense_scr)]),
            "b": ("gloo", 4, plan_b)}


def p11_paths(name: str) -> set:
    """The kernels a phase 11 job's path runs."""
    if name.startswith("narrow"):
        return {"count_mask"}
    if name.startswith("scr"):
        return {"hash_loc", "count_mask",
                "group_count" if ".gemm" in name else "pair_count"}
    return {"hash_loc", "count_mask"}


def phase_sharded(torch, dev, smi: str, wide_db: str, narrow_db: str,
                  scr_db: str, wide_reads: str, narrow_reads: str) -> dict:
    """Phase 11: the multi-device search (kmcp_tpu_torch.parallel) on the
    card, through ``TorchDeviceDB(mesh=...)`` on ranks spawned by
    ``parallel.dryrun.spawn``: (a) a world of one rank on nccl, mesh (1, 1):
    the fused dense search (K1' + K2') on phase 4's DB and the screened
    search (K1' + K2' pass 1 + K5') on phase 6's DB, phase 4's 65,536 reads
    in the streamer's 16,384-read batches; (b) four ranks on cuda:0 over
    gloo, meshes (1, 4), (2, 2) and (4, 1): the same searches, at (1, 4)
    also pass 2 on K6' ("gemm"), the host-location ("loc") step on phase
    5's three-hash DB (5 words padded to 8) with phase 5's reads, and one
    of its batches from a budget of 8 that must overflow, report the true
    total and retry at 4x.  Every rank's (meta, aux) must be byte-identical
    to the single-device TorchDeviceDB on the same batch (here, on the
    card, in the same layout), and every rank must have launched each
    kernel of the job's path.  The four ranks share one card, so their
    walls and summed CUDA-event kernel times are not scale-out numbers."""
    from kmcp_tpu_torch.parallel.dryrun import host_loc, mesh_jobs, run_job, \
        spawn
    from kmcp_tpu_torch.search.device import (TorchDeviceDB, numpy_state,
                                              pad_words)
    from kmcp_tpu_torch.search.engine import SearchEngine, SearchOptions

    t0 = time.time()
    dbs = {"wide": wide_db, "scr": scr_db, "narrow": narrow_db}
    opt = SearchOptions()
    opened = {k: SearchEngine([p], opt).dbs[0] for k, p in dbs.items()}
    wide = fastq_batches(wide_reads, N_READS // P11_BATCH)
    narrow_rows = opened["narrow"].blocks[0].bits.shape[0]
    narrow_loc = []
    for mat, lens in fastq_batches(narrow_reads, N_READS // P11_BATCH):
        seqs = [bytes(row[:n]) for row, n in zip(mat, lens)]
        narrow_loc.append(host_loc(seqs, 3, narrow_rows))
    plans = p11_jobs(wide, wide, narrow_loc)
    prep_s = time.time() - t0

    # the single-device runs every rank is held to, on this card, in the
    # layout of the (1, 4) mesh (only the narrow DB's words pad: 5 -> 8)
    t0 = time.time()
    want: dict = {}
    for key, db in opened.items():
        state = numpy_state(db, opt)
        if key == "narrow":
            state = pad_words(state, 4)
        for pass2 in ("auto", "gemm") if key == "scr" else ("auto",):
            single = TorchDeviceDB.from_numpy_state(state, opt, dev,
                                                    db.query_fpr, pass2)
            for _w, _n, plan in plans.values():
                for _shape, jobs in plan:
                    for name, k, p2, kind, args in jobs:
                        if (k, p2) == (key, pass2) and name not in want:
                            want[name] = run_job(single, kind, args)
            del single
    torch.cuda.empty_cache()
    ref_s = time.time() - t0
    log(f"phase 11 single-device references: {len(want)} batches in "
        f"{ref_s:.1f} s (inputs {prep_s:.1f} s)")

    out: dict = {}
    for label, (backend, world, plan) in plans.items():
        t0 = time.time()
        ranks = spawn(mesh_jobs, world, (dbs, plan, True), "cuda:0",
                      backend, timeout_s=600)
        wall = time.time() - t0
        for shape, jobs in plan:
            cfgs: dict = {}
            for name, *_ in jobs:
                for r, res in enumerate(ranks):
                    got = res[shape, name]
                    w = want[name]
                    if not (np.array_equal(got["meta"], w["meta"])
                            and np.array_equal(got["aux"], w["aux"])
                            and got["first_total"] == w["first_total"]):
                        raise AssertionError(
                            f"phase 11 ({label}) mesh{shape} {name}: rank "
                            f"{r}'s (meta, aux) differs from the "
                            "single-device run")
                    missing = [k for k in p11_paths(name)
                               if not got["launches"][k]]
                    if missing:
                        raise AssertionError(
                            f"phase 11 ({label}) mesh{shape} {name}: rank "
                            f"{r} launched no {missing}")
                    cfg = cfgs.setdefault(name.split(".b")[0], {
                        "batches": 0, "wall": [0.0] * world,
                        "launches": [dict.fromkeys(got["launches"], 0)
                                     for _ in range(world)],
                        "kernel_ms": {}})
                    cfg["wall"][r] += got["wall"]
                    for k, v in got["launches"].items():
                        cfg["launches"][r][k] += v
                    for k, v in got["kernel_ms"].items():
                        cfg["kernel_ms"][k] = cfg["kernel_ms"].get(k, 0) + v
                cfgs[name.split(".b")[0]]["batches"] += 1
            if label == "b" and shape == (1, 4):
                over = ranks[0][shape, "narrow.over"]
                if over["first_total"] <= P11_OVERFLOW_BUDGET:
                    raise AssertionError("phase 11: the budget of 8 did not "
                                         "overflow")
                log(f"phase 11 (b) mesh(1, 4) narrow overflow: budget "
                    f"{P11_OVERFLOW_BUDGET} reported the true total "
                    f"{over['first_total']} on every rank (the single-device"
                    f" total), retried 4x to budget {over['budget']}, "
                    "byte-identical")
            for cfg_name, cfg in cfgs.items():
                log(f"phase 11 ({label}) {backend} mesh(d={shape[0]},"
                    f"t={shape[1]}) {cfg_name}: {cfg['batches']} batches "
                    "byte-identical on every rank; rank walls (s) "
                    + ", ".join(f"{w:.3f}" for w in cfg["wall"])
                    + "; launches by rank "
                    + str([{k: v for k, v in la.items() if v}
                           for la in cfg["launches"]])
                    + "; summed CUDA-event ms over ranks: "
                    + ", ".join(f"{k} {v:.3f}"
                                for k, v in cfg["kernel_ms"].items()))
            out[label, shape] = cfgs
        log(f"phase 11 ({label}): {world} rank(s) on {backend}, spawn to "
            f"finish {wall:.1f} s ({smi}; the ranks share one card: "
            "correctness only, not scale-out)")
    launches = {}
    for (label, shape), cfgs in out.items():
        for cfg_name, cfg in cfgs.items():
            key = f"phase 11 ({label}) {shape} {cfg_name}"
            launches[key] = {k: sum(la[k] for la in cfg["launches"])
                             for k in cfg["launches"][0]}
    return {"launches": launches}


# ------------------------------------------------------------- phase 12
# batches in flight: one at a time and the JAX default, one turn each so
# that the smoke stays inside its time bound
DEPTHS = (1, 4)


def busy_share(trace_path: str, wall_s: float) -> tuple:
    """(device busy seconds: the union of the kernel, memcpy and memset
    intervals of a torch.profiler chrome trace; the kernels' summed
    seconds; the busy share of ``wall_s``), or None when the trace holds no
    device event."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans, kernel_us = [], 0.0
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy",
                                             "gpu_memset"):
            continue
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        if cat == "kernel":
            kernel_us += float(e["dur"])
    if not spans:
        return None
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6, kernel_us / 1e6, busy / 1e6 / wall_s


def first_batch(reads, k: int) -> list:
    """The streamer's first 16,384 queries of a FASTQ, or of the pairs of
    two (``reads`` a pair of paths)."""
    from itertools import islice

    from kmcp_tpu_torch.commands.search import iter_queries

    files, r1, r2 = (([], *reads) if isinstance(reads, tuple)
                     else ([reads], None, None))
    return list(islice(iter_queries(files, r1, r2, False, False, "", k),
                       16_384))


def phase_inflight(torch, dev, smi: str, cells: list, wide: tuple,
                   flushes: list) -> dict:
    """Phase 12: batches in flight on the card.  (a) every cell of
    ``cells`` (name, DB, run_search's query arguments, pass2, the plain
    run's TSV, unit) through ``run_search`` at depths 1 and 4, each TSV
    byte-identical to the other depth's and to the plain versions' run,
    every kernel of its path launched; its wall, e2e rate and peak device
    memory.  (b) one batch of every tail of ``flushes`` (label, DB, pass2,
    the reads file or the pair of files) flushed under
    ``torch.cuda.set_sync_debug_mode("error")``, then drained.  (c) the
    wide cell with a starting budget of 8 and 4 batches in flight: the
    plain run's bytes, with retries.  (d) the card's busy share in one
    torch.profiler run of the wide cell at depth 4."""
    import io

    from kmcp_tpu_torch.commands.search import HEADER, write_stats
    from kmcp_tpu_torch.index.format import find_db_dirs
    from kmcp_tpu_torch.search import stream
    from kmcp_tpu_torch.search.engine import SearchEngine, SearchOptions

    out = {"launches": {}, "walls": {}}
    need = {"pair": ["pair_count"], "gemm": ["group_count"]}
    for name, db, query, pass2, ref, unit in cells:
        with open(ref, "rb") as f:
            want = f.read()
        walls = {1: [], 4: []}
        for turn, depth in enumerate(DEPTHS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            run = searched(db, os.path.join(SCRATCH, f"inflight.{name}.{turn}"
                                            ".tsv"), device=dev, pass2=pass2,
                           in_flight=depth, **query)
            peak = torch.cuda.max_memory_allocated(dev)
            la, st = run["launches"], run["stats"]
            kernels = ["hash_loc", "count_mask"] + need.get(
                st["pass2"] or "", [])
            if run["tsv"] != want:
                raise AssertionError(f"phase 12 {name} depth {depth}: TSV "
                                     "differs from the plain run")
            idle = dev.type == "cuda" and min(la[k] for k in kernels) == 0
            if idle or any(la[k] for k in la if k not in kernels):
                raise AssertionError(f"phase 12 {name} depth {depth}: "
                                     f"launches {la}")
            if st["in_flight"] != depth or st["slow_rows"]:
                raise AssertionError(f"phase 12 {name}: stats {st}")
            walls[depth].append(run["wall"])
            out["launches"][f"phase 12 {name} d{depth} t{turn}"] = la
            log(f"phase 12 (a) {name} depth {depth}: TSV byte-identical to "
                f"the plain run and the other depth ({len(want)} bytes); "
                f"run_search wall {run['wall']:.3f} s, "
                f"{N_READS / run['wall']:.1f} {unit}/s e2e (untimed), peak "
                f"device memory {peak / 2**20:.1f} MiB, 4x retries "
                f"{st['retries']}, launches {la}")
        out["walls"][name] = walls
        log(f"phase 12 (a) {name}: walls at depth 1 "
            f"{', '.join(f'{w:.3f}' for w in walls[1])} s, at depth 4 "
            f"{', '.join(f'{w:.3f}' for w in walls[4])} s (turns "
            f"{', '.join(map(str, DEPTHS))}); depth 4 / depth 1 of the sums "
            f"{sum(walls[4]) / sum(walls[1]):.3f} ({smi})")

    # (b) one batch of every tail flushed without the host waiting
    sts, states = [], []
    for label, db, pass2, reads in flushes:
        paired = isinstance(reads, tuple)
        opt = SearchOptions(paired_fpr_buf=paired)
        eng = SearchEngine(find_db_dirs(db), opt, dev)
        sts.append(stream.TorchStreamSearcher(eng, dev, pass2))
        states.append((label, first_batch(reads, max(eng.dbs[0].info.ks)),
                       paired))
    pending = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for st, (label, batch, paired) in zip(sts, states):
            pending.append(st._flush(batch, 16_384, 0, paired))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for st, state, (label, _b, _p) in zip(sts, pending, states):
        sink = io.StringIO()
        fmt = (stream._fmt_ratio_memo(), stream._fmt_ratio_memo(), {})
        matched = st._drain(state, sink, fmt)
        if not matched:
            raise AssertionError(f"phase 12 (b) {label}: no read matched")
    log(f"phase 12 (b): one 16,384-query batch of each tail ("
        + ", ".join(label for label, *_ in flushes) + ") flushed under "
        "torch.cuda.set_sync_debug_mode('error') with no error, then "
        "drained")
    del sts, states, pending
    torch.cuda.empty_cache()

    # (c) candidate overflow with 4 batches in flight
    name, db, path, ref = wide
    query, pass2 = {"files": [path]}, "auto"
    eng = SearchEngine(find_db_dirs(db), SearchOptions(), dev)
    st = stream.TorchStreamSearcher(eng, dev, pass2, in_flight=4)
    from kmcp_tpu_torch.commands.search import iter_queries

    sink = io.StringIO()
    sink.write(HEADER)
    slots = stream.SLOTS_PER_READ
    stream.SLOTS_PER_READ = 8 / 16_384  # 8 slots for a 16,384-read batch
    try:
        t0 = time.time()
        total, matched = st.run(iter_queries([path], None, None, False,
                                             False, "",
                                             max(eng.dbs[0].info.ks)), sink)
        wall = time.time() - t0
    finally:
        stream.SLOTS_PER_READ = slots
    write_stats(sink, total, matched)
    with open(ref, "rb") as f:
        if sink.getvalue().encode() != f.read():
            raise AssertionError("phase 12 (c): TSV differs at budget 8")
    if st.retries < 4:
        raise AssertionError(f"phase 12 (c): {st.retries} retries")
    log(f"phase 12 (c) {name}: a starting budget of 8 with 4 batches in "
        f"flight: the plain run's bytes, {st.retries} 4x retries, "
        f"{wall:.3f} s")
    del st, eng

    # (d) the card's busy share, one profiled run at depth 4
    from torch.profiler import ProfilerActivity, profile

    trace = os.path.join(SCRATCH, "inflight.trace.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        searched(db, os.path.join(SCRATCH, "inflight.profiled.tsv"),
                 device=dev, pass2=pass2, in_flight=4, **query)
        torch.cuda.synchronize()
        wall = time.time() - t0
    prof.export_chrome_trace(trace)
    share = busy_share(trace, wall)
    if share is None:
        log(f"phase 12 (d) {name}: the profiler saw no device event: busy "
            "share not measured")
    else:
        log(f"phase 12 (d) {name} depth 4 under torch.profiler: wall "
            f"{wall:.3f} s, device busy {share[0]:.4f} s (kernels "
            f"{share[1]:.4f} s), busy share {share[2]:.4f} ({smi})")
    out["busy"] = share
    return out


# ------------------------------------------------------------- phase 13
# the host backend and host hashing on the card
MULTI_GENOMES, MULTI_BLOCK_TARGETS = 256, 4096  # (b): 4 blocks, 2 hashes
HOST_READS = 4096  # (b) and (c): reads or pairs
# (d): (where reads hash, depth) in turns, each cell's runs in one call
A15_TURNS = (("device", 4), ("host", 1), ("host", 4), ("host", 4),
             ("host", 1), ("device", 4))


def host_info() -> str:
    from kmcp_tpu_torch.kmer import native

    return (f"host os.cpu_count() {os.cpu_count()}, OpenMP threads "
            f"{native._threads(0)}")


def host_searched(torch, tag: str, db: str, out: str, opt=None,
                  **kwargs) -> dict:
    """``searched`` with ``opt`` (default options) on backend "host", as
    ``search --backend host`` sets it: no kernel launched, no tensor left
    on the card."""
    from kmcp_tpu_torch.search.engine import SearchOptions

    opt = dataclasses.replace(opt or SearchOptions(), backend="host")
    before = torch.cuda.memory_allocated()
    run = searched(db, out, opt=opt, **kwargs)
    if any(run["launches"].values()) or (
            torch.cuda.memory_allocated() != before):
        raise AssertionError(f"{tag}: the host backend used the card "
                             f"(launches {run['launches']})")
    if run["stats"]["backend"] != "host":
        raise AssertionError(f"{tag}: stats {run['stats']}")
    return run


def multi_block_db(wide_ks: str, pool) -> str:
    """(b)'s DB: phase 4's k-mer sets of MULTI_GENOMES genomes (the 40
    source genomes among them) indexed with 2 hashes into blocks of
    MULTI_BLOCK_TARGETS targets, no union screen (``-n 2 -f 0.3
    --tpu-native --native-block-targets 4096``)."""
    from kmcp_tpu_torch.cli import main as cli
    from kmcp_tpu_torch.kmer.kset import read_info, write_info

    root = os.path.join(SCRATCH, "host", "multi")
    shutil.rmtree(root, ignore_errors=True)
    ks, db = os.path.join(root, "ks"), os.path.join(root, "db")
    os.makedirs(ks)
    names = {f"g{g:05d}" for g in genome_subset(pool, MULTI_GENOMES)}
    write_info(ks, [i for i in read_info(wide_ks) if i.name in names])
    if cli(["-q", "index", "-I", ks, "-O", db, "-n", "2", "-f", "0.3",
            "--tpu-native", "--native-block-targets",
            str(MULTI_BLOCK_TARGETS), "--force"]):
        raise RuntimeError("index of the multi-block DB failed")
    return db


def phase_host(torch, dev, smi: str, cells: list, wide_ks: str, pool,
               reads: str, pair_files, minimizer_db: str,
               a15_cells: list) -> dict:
    """Phase 13: the host backend and host hashing on the card.
    (a) ``--backend host`` on each of ``cells`` (name, DB, run_search's
    query arguments, its phase's card TSV, unit): the card's bytes, no
    kernel launched; wall and rate.  (b) a multi-block DB without union
    screens (``multi_block_db``): HOST_READS of phase 4's reads, the host
    streamer against the card's object engine, and ``--low-mem`` row seek
    on the host engine, the same bytes.  (c) phase 8's minimizer DB and
    HOST_READS of phase 7's pairs: the host streamer (mates hashed as
    separate rows) against the card's object engine.  (d) with
    KMCP_TPU_DEVICE_HASH=0 each of ``a15_cells`` (name, DB, reads, its
    phase's card TSV) at depths 1 and 4 in turns with the device-hash run
    (A15_TURNS): the card's bytes, K1' launched only by the device-hash
    runs, K2' by all; walls and rates."""
    root = os.path.join(SCRATCH, "host")
    os.makedirs(root, exist_ok=True)
    out = {"launches": {}, "walls": {}}
    info = f"{smi}; {host_info()}"

    for name, db, query, card, unit in cells:  # (a)
        tag = f"phase 13 (a) {name}"
        run = host_searched(torch, tag, db, os.path.join(root, f"{name}.tsv"),
                            **query)
        with open(card, "rb") as f:
            if run["tsv"] != f.read():
                raise AssertionError(f"{tag}: TSV differs from the card's")
        st = run["stats"]
        if st["route"] != "stream" or st["hash"] != "host":
            raise AssertionError(f"{tag}: stats {st}")
        total = run["totals"][0]
        out["walls"][f"(a) {name}"] = run["wall"]
        log(f"{tag}: --backend host TSV byte-identical to the card's "
            f"({len(run['tsv'])} bytes, {run['totals'][1]}/{total} "
            f"matched), no kernel launched; run_search wall "
            f"{run['wall']:.3f} s, {total / run['wall']:.1f} {unit}/s e2e, "
            f"{st['n_blocks']} block(s), 4x retries {st['retries']}, slow "
            f"rows {st['slow_rows']} ({info})")

    few = os.path.join(root, "reads.fq")
    fastq_every(reads, few, N_READS // HOST_READS)
    p1, p2 = os.path.join(root, "r1.fq"), os.path.join(root, "r2.fq")
    fastq_every(pair_files[0], p1, N_READS // HOST_READS)
    fastq_every(pair_files[1], p2, N_READS // HOST_READS)
    t0 = time.time()
    multi = multi_block_db(wide_ks, pool)
    build_s = time.time() - t0
    from kmcp_tpu_torch.search.engine import SearchOptions

    cases = {  # (b), (c): (DB, query, the host run's options and route)
        "(b) multi-block": (multi, {"files": [few]}, {}, "stream"),
        "(b) multi-block --low-mem": (multi, {"files": [few]},
                                      {"low_mem": True}, "engine"),
        "(c) minimizer pairs": (minimizer_db, {"read1": p1, "read2": p2},
                                {}, "stream"),
    }
    card_runs: dict = {}
    for name, (db, query, kw, route) in cases.items():
        tag = f"phase 13 {name}"
        key = (db, repr(query))
        if key not in card_runs:  # each card run counts once
            card_runs[key] = searched(
                db, os.path.join(root, f"{name}.cuda.tsv"), device=dev,
                **query)
            out["launches"][f"phase 13 {name} card"] = card_runs[key][
                "launches"]
        card = card_runs[key]
        la = card["launches"]
        cuda = dev.type == "cuda"  # CPU tensors take the plain versions
        if (card["stats"]["route"] != "engine"
                or (cuda and la["count_mask"] == 0)
                or any(la[n] for n in la if n != "count_mask")):
            raise AssertionError(f"{tag}: card run {card['stats']}, {la}")
        run = host_searched(torch, tag, db,
                            os.path.join(root, f"{name}.host.tsv"),
                            opt=SearchOptions(**kw), **query)
        if run["tsv"] != card["tsv"] or run["totals"] != card["totals"]:
            raise AssertionError(f"{tag}: TSV differs from the card's "
                                 "object engine")
        if run["stats"]["route"] != route:
            raise AssertionError(f"{tag}: stats {run['stats']}")
        out["walls"][name] = run["wall"]
        st = card["stats"]
        log(f"{tag}: host {route} TSV byte-identical to the card's object "
            f"engine ({len(run['tsv'])} bytes, {run['totals'][1]}/"
            f"{run['totals'][0]} matched); host wall {run['wall']:.3f} s, "
            f"card engine wall {card['wall']:.3f} s"
            + (f"; DB {MULTI_GENOMES * 64} targets in blocks of "
               f"{MULTI_BLOCK_TARGETS}, 2 hashes, indexed in {build_s:.1f} s"
               if name.startswith("(b)") else "")
            + f"; card launches {la} ({info})")

    for name, db, path, card in a15_cells:  # (d)
        with open(card, "rb") as f:
            want = f.read()
        walls: dict = {}
        for turn, (where, depth) in enumerate(A15_TURNS):
            tag = f"phase 13 (d) {name} {where} hash depth {depth}"
            with env_var("KMCP_TPU_DEVICE_HASH",
                         "1" if where == "device" else "0"):
                run = searched(db, os.path.join(root, f"a15.{name}.{turn}"
                                                ".tsv"), files=[path],
                               device=dev, in_flight=depth)
            la, st = run["launches"], run["stats"]
            if run["tsv"] != want:
                raise AssertionError(f"{tag}: TSV differs from the card's")
            k1 = la["hash_loc"] > 0
            if (st["hash"] != where or st["in_flight"] != depth
                    or la["pair_count"] or la["group_count"]
                    or (dev.type == "cuda" and (
                        k1 != (where == "device") or la["count_mask"] == 0))
                    or (where == "host" and k1)):
                raise AssertionError(f"{tag}: launches {la}, stats {st}")
            walls.setdefault(f"{where} d{depth}", []).append(run["wall"])
            out["launches"][f"phase 13 (d) {name} {where} d{depth} "
                            f"t{turn}"] = la
            log(f"{tag}: TSV byte-identical to the card's "
                f"({len(want)} bytes); run_search wall {run['wall']:.3f} s, "
                f"{N_READS / run['wall']:.1f} reads/s e2e, slow rows "
                f"{st['slow_rows']}, 4x retries {st['retries']}, launches "
                f"{la}")
        out["walls"][f"(d) {name}"] = walls
        log(f"phase 13 (d) {name}: walls (s) "
            + "; ".join(f"{k} {', '.join(f'{w:.3f}' for w in v)}"
                        for k, v in walls.items()) + f" ({info})")
    return out


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
    for name, rows in phase_tall_kernels(torch, dev).items():
        kern[name] += rows
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
    wide_ks = os.path.join(SCRATCH, "wide", "ks")
    screened_db = os.path.join(SCRATCH, "screened", "db")
    index_s = index_dbs(wide_ks, {screened_db: SCREENED_OPTS,
                                  **{tall_db(n): o
                                     for n, o in TALL_OPTS.items()}})
    screened = phase_screened(torch, dev, screened_db, index_s, wide_reads,
                              wide_source)
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
    t0 = time.time()
    sharded = phase_sharded(torch, dev, smi, wide_db, narrow_db,
                            screened["db"], wide_reads, reads)
    walls["11 sharded"] = time.time() - t0
    t0 = time.time()
    single, pairs = {"files": [wide_reads]}, {"read1": pair_files[0],
                                              "read2": pair_files[1]}
    inflight = phase_inflight(
        torch, dev, smi,
        [("wide-131k", wide_db, single, "auto", wide["ref"], "reads"),
         ("screened-131k auto", screened["db"], single, "auto",
          screened["ref"], "reads"),
         ("screened-131k gemm", screened["db"], single, "gemm",
          screened["ref"], "reads"),
         ("paired-131k", wide_db, pairs, "auto", paired["dense"]["ref"],
          "pairs"),
         ("paired-screened-131k", screened["db"], pairs, "auto",
          paired["screened"]["ref"], "pairs"),
         ("sketch-minimizer-16k", sketch["db"]["minimizer"], single, "auto",
          sketch["ref"]["minimizer"], "reads")],
        ("wide-131k", wide_db, wide_reads, wide["ref"]),
        [("dense", wide_db, "auto", wide_reads),
         ("narrow 3-hash", narrow_db, "auto", reads),
         ("paired dense", wide_db, "auto", pair_files),
         ("screened pair", screened["db"], "pair", wide_reads),
         ("screened gemm", screened["db"], "gemm", wide_reads),
         ("paired screened", screened["db"], "auto", pair_files),
         ("sketch", sketch["db"]["minimizer"], "auto", wide_reads)])
    walls["12 in flight"] = time.time() - t0
    t0 = time.time()
    host = phase_host(
        torch, dev, smi,
        [("wide-131k", wide_db, single, wide["out"], "reads"),
         ("narrow-150", narrow_db, {"files": [reads]}, narrow["out"],
          "reads"),
         ("screened-131k", screened["db"], single, screened["ref"], "reads"),
         ("paired-131k", wide_db, pairs, paired["dense"]["out"], "pairs")],
        os.path.join(SCRATCH, "wide", "ks"), pool, wide_reads, pair_files,
        sketch["db"]["minimizer"],
        [("wide-131k", wide_db, wide_reads, wide["out"]),
         ("narrow-150", narrow_db, reads, narrow["out"])])
    walls["13 host"] = time.time() - t0
    t0 = time.time()
    tall = phase_tall(torch, dev, index_s, wide_reads, pair_files)
    walls["14 tall"] = time.time() - t0
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
                      for p, n in engine["launches"].items()},
                   **{p: n[name] for p, n in sharded["launches"].items()},
                   **{p: n[name] for p, n in inflight["launches"].items()},
                   **{p: n[name] for p, n in host["launches"].items()},
                   **{p: n[name] for p, n in tall["launches"].items()}}

        def timed(r) -> dict:
            # only K6' has a one-call library counterpart; K1''s ms is the
            # device time a launch, with the time of one call beside it
            out = {"shape": r[0], "ms": r[2], "plain_ms": r[3],
                   "bound_ms": r[4][0], "bound_by": r[4][1],
                   "library_ms": r[6] if len(r) > 6 else None}
            if r[0] in VARIANT_OF:
                out["variant"] = VARIANT_OF[r[0]]
            if name == "hash_loc":
                out["call_ms"] = r[5]
            if len(r) > 7:  # at the screened tail's padded pair budget
                out["padded"] = r[7]
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
