#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kmcp_tpu_torch) on one GPU.

Drives the port's main paths, single-end streaming search over a
single-block DB and over a multi-block ``--block-screen --uniform-sigs`` DB
(the two-pass screened search), through the entry points a user calls
(``python -m kmcp_tpu_torch compute / index`` to build the DBs, then
``kmcp_tpu_torch.commands.search.run_search``).  Every input is made here
from fixed seeds; nothing outside the checkout is read, and nothing of JAX
or of the JAX package is imported here.

Phases (each prints one status line; any failure raises, exit non-zero):
  1. device: a CUDA card, its name and power limit (nvidia-smi);
  2. build: nvcc builds the CUDA kernels from kmcp_tpu_torch/csrc/;
  3. kernels: K1' hash_loc (also with the screen plane) and K2'
     count_mask on the card at the main paths' shapes (wide, narrow, and
     screened pass 1 over a 2^25-row union table), and the screened
     pass-2 kernels K5' pair_count and K6' group_count at 32 and 128
     blocks of 4,096 targets (random bits, 3,578 rows per block, 20,480 and
     36,864 pairs of a 16,384-read batch), each exactly equal to its plain
     PyTorch version (K6' also to K5''s counts); CUDA event times, median
     of 5 after a warm-up, of the kernels, the plain versions and each
     pass-2 route as the tail runs it (K5' + compaction; U build + K6' +
     floors + compaction); each kernel's bound (``bound``) from this run's
     inputs; and for K6' the one PyTorch call that computes the same
     grouped product (``torch._grouped_mm`` in bf16), timed as a yardstick
     and used nowhere in the port;
  4. main path: a 131,072-target single-block wide DB (2,048 synthetic
     genomes x 64 chunks, k=21, one hash, FPR 0.3; the recipe of
     tools/bench_large_t.py) and 65,536 150 bp reads (40 source genomes,
     10% random junk).  The TSV of the port on the card must be
     byte-identical to the same path run with both kernels bound to their
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
     card with pass2="gemm" and pass2="pair"; both TSVs byte-identical to
     the port's ``--device cpu`` run (pass2="pair": the plain pair count
     is cheap on the CPU, as only active pairs are counted), every source
     read best-hits its genome, hash_loc and count_mask (pass 1) launch in
     both runs, group_count only in the first and pair_count only in the
     second, and no read takes the object engine; then a rerun of each
     with stage timers (a synchronised host clock) gives the time by
     stage.
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


# One NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): HBM rate and
# the bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


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


def bound(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for work
    that moves ``nbytes`` (each input read once, each output written once)
    and does ``flops`` bf16 tensor-core operations; the larger of the two
    times, and which of them it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
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
        ms = time_ms(torch, lambda: hash_loc(reads, K, S, full, h))
        ms_p = time_ms(torch, lambda: hash_loc_plain(reads, K, S, full, h))
        bd = bound(nbytes(reads, loc, nk))
        log(f"phase 3 hash_loc [{label}] B={B} lmax={lmax}: exact "
            f"(max abs err 0); kernel {ms:.3f} ms, plain {ms_p:.3f} ms, "
            f"bound {bd[0]:.4f} ms ({bd[1]})")
        res["hash_loc"].append((label, err, ms, ms_p, bd))

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
    ms = time_ms(torch, lambda: hash_loc(reads, K, S, full, 1, screen_sigs=N))
    ms_p = time_ms(torch, lambda: hash_loc_plain(reads, K, S, full, 1,
                                                 screen_sigs=N))
    label = f"screen S={S} N={N} h=1"
    bd = bound(nbytes(reads, *got))
    log(f"phase 3 hash_loc [{label}] B={B} lmax={lmax}: exact (max abs err "
        f"0); kernel {ms:.3f} ms, plain {ms_p:.3f} ms, bound {bd[0]:.4f} ms "
        f"({bd[1]})")
    res["hash_loc"].append((label, err, ms, ms_p, bd))

    # screened pass 1: K2' over the packed union table of 32 blocks (one
    # word a row, N rows), every read of the batch, floors 0
    union = torch.from_numpy(random_bits(rng, N, 1, 1, 0).view(np.int32)).to(dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    res["count_mask"].append(check_count_mask(
        torch, f"pass1 S={N} h=1 W=1", union, got[2].unsqueeze(2).contiguous(),
        zeros, zeros[:32]))
    return res


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
    density 1/4, so a pair's counts sit near 33); K6' is
    fed the block-sorted tiles and U the tail builds, and must also equal
    K5''s counts.  Each pass-2 route is also timed whole, as the tail runs
    it."""
    from kmcp_tpu_torch.search import screen
    from kmcp_tpu_torch.search.device_step import FLOOR_NEVER
    from kmcp_tpu_torch.search.group_count import (
        TILE, block_tiles, build_u, gemm_slabs, group_count,
        group_count_plain, s_pad_for,
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
        chunk = screen.pass2_chunk(32 * W)
        route = time_ms(torch, lambda: screen._pass2_pair(
            bits, loc, pb, pg, cthr, thr, chunk))
        # each pair reads its read's locations and the block rows they hit
        reads_used = torch.unique(pb).numel()
        rows = torch.unique(pg.long()[:, None] * (s_block + 1)
                            + loc[pb.long()]).numel()
        bd = bound(rows * W * 4 + reads_used * (Kw + 1) * 4
                   + torch.unique(pg).numel() * 32 * W * 4
                   + nbytes(pb, pg, counts, mask))
        log(f"phase 3 pair_count [{label}] s_block={s_block} W={W} K={Kw}: "
            f"exact (max abs err 0, {n_set} mask words set); kernel "
            f"{ms:.3f} ms, plain {ms_p:.3f} ms, bound {bd[0]:.4f} ms "
            f"({bd[1]}); route (K5' + compaction) {route:.3f} ms")
        res["pair_count"].append((label, err, ms, ms_p, bd, route))

        bits01 = gemm_slabs(bits, nb, s_block, S_pad)
        slot, blk = block_tiles(pg, nb)
        rows = torch.full((TILE * blk.shape[0],), B, dtype=torch.int64,
                          device=dev)
        rows[slot] = pb.long()
        loc_ext = torch.cat([loc, loc.new_full((1, Kw), s_block)])
        u = build_u(loc_ext[rows], S_pad)
        got = group_count(bits01, u, blk)
        want = group_count_plain(bits01, u, blk)
        torch.cuda.synchronize()
        err6 = max(max_abs_err(torch, got, want),
                   max_abs_err(torch, got[slot], counts))
        if err6:
            raise AssertionError(f"group_count {label}: max abs err {err6}")
        del want, counts, mask
        ms6 = time_ms(torch, lambda: group_count(bits01, u, blk))
        ms6_p = time_ms(torch, lambda: group_count_plain(bits01, u, blk))
        ms_u = time_ms(torch, lambda: build_u(loc_ext[rows], S_pad))
        chunk = screen.pass2_chunk(32 * W, S_pad)
        route6 = time_ms(torch, lambda: screen._pass2_gemm(
            bits01, loc, pb, pg, cthr, thr, s_block, chunk))
        flops = 2.0 * u.shape[0] * S_pad * 32 * W
        slab = S_pad * 32 * W  # int8 bytes of one block's slab
        bd = bound(torch.unique(blk).numel() * slab + nbytes(u, blk, got),
                   flops)
        lib_ms, lib_err = grouped_mm_yardstick(torch, bits01, u, blk, got)
        log(f"phase 3 group_count [{label}] P_pad={u.shape[0]} "
            f"S_pad={S_pad} T={32 * W}: exact (max abs err 0 vs plain and "
            f"vs pair_count); kernel {ms6:.3f} ms ({flops / ms6 / 1e9:.1f} "
            f"TFLOP/s), plain {ms6_p:.3f} ms, bound {bd[0]:.4f} ms "
            f"({bd[1]}), torch._grouped_mm bf16 {lib_ms:.3f} ms (max abs "
            f"err {lib_err} vs K6'); U build {ms_u:.3f} ms; route (U build "
            f"+ K6' + floors + compaction) {route6:.3f} ms")
        res["group_count"].append((label, err6, ms6, ms6_p, bd, route6,
                                   lib_ms))
        del bits, bits01, u, got, loc_ext, rows
        torch.cuda.empty_cache()
    return res


def grouped_mm_yardstick(torch, bits01, u, blk, got) -> tuple[float, int]:
    """The one PyTorch call that computes K6''s grouped product on the same
    inputs: ``torch._grouped_mm`` of U bf16 [P_pad, S_pad] (rows grouped by
    block, in block order) by the 0/1 slabs in bf16, with the per-block row
    ends as offsets.  Its bf16 output holds the counts exactly (< 256).
    Returns (median ms, max abs err against K6''s counts)."""
    nb = bits01.shape[0]
    # [nb, T, S_pad] contiguous, seen as [nb, S_pad, T]: the column-major
    # right operand the grouped GEMM takes
    slabs = bits01.transpose(1, 2).contiguous().to(torch.bfloat16)
    slabs = slabs.transpose(1, 2)
    rows_per_block = torch.bincount(blk.long(), minlength=nb) * (
        u.shape[0] // blk.shape[0])
    offs = torch.cumsum(rows_per_block, 0).to(torch.int32)
    out = torch._grouped_mm(u, slabs, offs=offs)
    torch.cuda.synchronize()
    err = max_abs_err(torch, out.to(torch.int32), got)
    ms = time_ms(torch, lambda: torch._grouped_mm(u, slabs, offs=offs))
    del slabs, out
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


def write_reads(path: str, genomes: list[bytes], seed: int) -> int:
    """N_READS 150 bp reads as FASTQ: 90% from 40 source genomes, named
    r<i>.<genome>, and 10% random junk, named j<i>
    (tools/bench_large_t.py:104-128).  Returns the number of source reads."""
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
    return N_READS - n_junk


def check_best_hits(path: str, n_source: int) -> None:
    """Every source read r<i>.<genome> must have <genome> as its first (best)
    hit: its own chunk covers all its k-mers, and another genome's chunk
    would have to share all 130 of them by Bloom false positives."""
    best = {}
    with open(path) as f:
        for line in f:
            if not line.startswith("#"):
                cols = line.split("\t", 6)
                best.setdefault(cols[0], cols[5])
    src = {q: t for q, t in best.items() if q.startswith("r")}
    wrong = [q for q, t in src.items() if q.split(".", 1)[1] != t]
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


@contextlib.contextmanager
def plain_kernels():
    """Bind the main path's two kernel calls to their plain PyTorch
    versions, so the same path runs without the CUDA kernels."""
    from kmcp_tpu_torch.search import device, device_step
    from kmcp_tpu_torch.search.count import count_mask_plain
    from kmcp_tpu_torch.search.hash_loc import hash_loc_plain

    saved = device.hash_loc, device_step.count_mask
    device.hash_loc = hash_loc_plain
    device_step.count_mask = (
        lambda bits, loc, cthr, thr, rows_checked=False:
        count_mask_plain(bits, loc, cthr, thr)
    )
    try:
        yield
    finally:
        device.hash_loc, device_step.count_mask = saved


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
            "retries": stats["retries"]}


@contextlib.contextmanager
def stage_timers(torch, acc: dict):
    """Time a search's stages on a synchronised host clock, by wrapping
    the functions it calls: the DB set-up (host arrays, of which the union
    screens' packing, then the upload; the engine's open and check before
    it, and the streamer set-up around it), the device hash, the dense
    tail and its K2' launches, or the screened pass 1, U build, pass-2
    kernels, whole pass-2 routes and packing with its D2H copy, and the
    TSV writer; seconds accumulate in ``acc``."""
    from kmcp_tpu_torch.commands import search as command
    from kmcp_tpu_torch.search import device, device_step, screen
    from kmcp_tpu_torch.search.stream import TorchStreamSearcher

    targets = [(command, "SearchEngine", "engine_open"),
               (command, "unsupported", "engine_check"),
               (command, "TorchStreamSearcher", "streamer_setup"),
               (device, "numpy_state", "db_state"),
               (device, "build_packed_union", "db_state_union_pack"),
               (device.TorchDeviceDB, "_init", "db_upload"),
               (device, "hash_loc", "hash"),
               (device, "count_tail", "dense_tail"),
               (device_step, "count_mask", "dense_count_kernel"),
               (screen, "active_pairs", "pass1"),
               (screen, "build_u", "u_build"),
               (screen, "pair_count", "pass2_kernel"),
               (screen, "group_count", "pass2_kernel"),
               (screen, "_pass2_pair", "pass2_route"),
               (screen, "_pass2_gemm", "pass2_route"),
               (screen, "pack_result_split", "pack_d2h"),
               (TorchStreamSearcher, "_write_native", "writer")]
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
    chunks, pass2="gemm" and "pair" on the card against the port's CPU run
    (pass2="pair"); then a stage-timed run of each route."""
    from kmcp_tpu_torch.cli import main as cli
    from kmcp_tpu_torch.commands.search import run_search

    db = os.path.join(SCRATCH, "screened", "db")
    t0 = time.time()
    if cli(["-q", "index", "-I", ks, "-O", db, "-n", "1", "-f", "0.3",
            "--tpu-native", "--native-block-targets", str(BLOCK_TARGETS),
            "--block-screen", "--uniform-sigs", "--force"]):
        raise RuntimeError("index of the screened DB failed")
    index_s = time.time() - t0

    def search(pass2: str, device, tag: str) -> dict:
        out = os.path.join(SCRATCH, f"screened.{tag}.tsv")
        stats: dict = {}
        totals, launches, wall = counted_run(
            run_search, db, [reads], out_file=out, device=device,
            verbose=False, stats=stats, pass2=pass2)
        with open(out, "rb") as f:
            tsv = f.read()
        return {"tsv": tsv, "out": out, "stats": stats, "wall": wall,
                "totals": totals, "launches": launches}

    runs = {p: search(p, dev, f"{dev.type}.{p}") for p in ("gemm", "pair")}
    ref = search("pair", "cpu", "cpu.pair")
    if any(ref["launches"].values()):
        raise AssertionError("phase 6: the CPU run launched a kernel")
    st = ref["stats"]
    if st["n_blocks"] < 2 or st["pass2"] != "pair":
        raise AssertionError(f"phase 6: not a screened run: {st}")
    rows_per_block = st["rows"] // st["n_blocks"]
    for p2, run in runs.items():
        tag = f"phase 6 screened {p2}"
        if run["tsv"] != ref["tsv"]:
            raise AssertionError(f"{tag}: TSV differs from the CPU run")
        if run["totals"] != ref["totals"] or run["totals"][0] != N_READS:
            raise AssertionError(f"{tag}: totals {run['totals']} vs "
                                 f"{ref['totals']}")
        check_best_hits(run["out"], n_source)
        if run["stats"]["pass2"] != p2 or run["stats"]["slow_rows"]:
            raise AssertionError(f"{tag}: stats {run['stats']}")
        other = "pair_count" if p2 == "gemm" else "group_count"
        mine = "group_count" if p2 == "gemm" else "pair_count"
        la = run["launches"]
        launched = min(la["hash_loc"], la["count_mask"], la[mine]) > 0
        if (dev.type == "cuda" and not launched) or la[other]:
            raise AssertionError(f"{tag}: launches {la}")
    log(f"phase 6 DB: {st['n_blocks']} blocks x {rows_per_block} Bloom rows "
        f"x {st['words']} words ({32 * st['words']} targets a block), union "
        f"screen {st['union_rows']} rows; indexed in {index_s:.1f} s")
    for p2, run in runs.items():
        log(f"phase 6 screened {p2}: TSV byte-identical to the CPU run "
            f"({len(run['tsv'])} bytes, {run['totals'][1]}/{run['totals'][0]}"
            f" reads matched, all {n_source} source reads best-hit their "
            f"genome); {N_READS / run['wall']:.1f} reads/s (run_search wall "
            f"incl. DB load), CPU run {N_READS / ref['wall']:.1f} reads/s; "
            f"{run['stats']['pairs']} active pairs, 4x retries "
            f"{run['stats']['retries']}, slow rows 0, launches "
            f"{run['launches']}")

    breakdown = {}
    for p2 in ("gemm", "pair"):
        acc: dict = {}
        with stage_timers(torch, acc):
            run = search(p2, dev, f"{dev.type}.{p2}.timed")
        if run["tsv"] != ref["tsv"]:
            raise AssertionError(f"phase 6 timed {p2}: TSV differs")
        acc["compaction"] = (acc.pop("pass2_route")
                             - acc.get("pass2_kernel", 0.0)
                             - acc.get("u_build", 0.0))
        breakdown[p2] = acc
        log(f"phase 6 stages {p2} (synchronised host clock, s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
            + f"; run_search wall {run['wall']:.3f}")
    return {"launches": {p: r["launches"] for p, r in runs.items()},
            "breakdown": breakdown}


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

    kern = phase_kernels(torch, dev)
    kern.update(phase_pass2(torch, dev))

    os.makedirs(SCRATCH, exist_ok=True)
    t0 = time.time()
    wide_db, genomes = build_db("wide", WIDE_GENOMES, WIDE_CHUNKS, 1000, 1, 42)
    build_s = time.time() - t0
    wide_reads = os.path.join(SCRATCH, "wide.reads.fq")
    wide_source = write_reads(wide_reads, genomes, 7)
    del genomes
    log(f"phase 4 DB: {WIDE_GENOMES * WIDE_CHUNKS} targets built in "
        f"{build_s:.1f} s")
    wide = phase_main_path(torch, dev, "phase 4 wide", wide_db, wide_reads,
                           wide_source, "plain", timed=True)

    t0 = time.time()
    narrow_db, genomes = build_db("narrow", NARROW_GENOMES, NARROW_CHUNKS,
                                  680_000, 3, 43)
    reads = os.path.join(SCRATCH, "narrow.reads.fq")
    n_source = write_reads(reads, genomes, 8)
    del genomes
    log(f"phase 5 DB: {NARROW_GENOMES * NARROW_CHUNKS} targets, 3 hashes, "
        f"built in {time.time() - t0:.1f} s")
    narrow = phase_main_path(torch, dev, "phase 5 narrow", narrow_db, reads,
                             n_source, "cpu")

    screened = phase_screened(torch, dev, os.path.join(SCRATCH, "wide", "ks"),
                              wide_reads, wide_source)

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
                   "phase 6 gemm": screened["launches"]["gemm"][name],
                   "phase 6 pair": screened["launches"]["pair"][name]}

        def timed(r) -> dict:
            # only K6' has a one-call library counterpart
            return {"shape": r[0], "ms": r[2], "plain_ms": r[3],
                    "bound_ms": r[4][0], "bound_by": r[4][1],
                    "library_ms": r[6] if len(r) > 6 else None}

        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r[1] for r in rows), **timed(rows[0]),
        }
        if len(rows[0]) > 5:  # the pass-2 kernels: the whole route too
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
