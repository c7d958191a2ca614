#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kmcp_tpu_torch) on one GPU.

Drives the port's main path, single-end streaming search over a
single-block DB, through the entry points a user calls (``python -m
kmcp_tpu_torch compute / index`` to build the DBs, then
``kmcp_tpu_torch.commands.search.run_search``).  Every input is made here
from fixed seeds; nothing outside the checkout is read, and nothing of JAX
or of the JAX package is imported here.

Phases (each prints one status line; any failure raises, exit non-zero):
  1. device: a CUDA card, its name and power limit (nvidia-smi);
  2. build: nvcc builds the CUDA kernels from kmcp_tpu_torch/csrc/;
  3. kernels: K1' hash_loc and K2' count_mask on the card at the main
     path's shapes, exactly equal to their plain PyTorch versions; CUDA
     event times, median of 5 after a warm-up;
  4. main path: a 131,072-target single-block wide DB (2,048 synthetic
     genomes x 64 chunks, k=21, one hash, FPR 0.3; the recipe of
     tools/bench_large_t.py) and 65,536 150 bp reads (40 source genomes,
     10% random junk).  The TSV of the port on the card must be
     byte-identical to the same path run with both kernels bound to their
     plain PyTorch versions on the card (the CPU run of the plain versions
     would take about half an hour at this width), both kernels must have
     launched, and every read drawn from a DB genome must have that genome
     as its best hit;
  5. the same on a narrow-row DB (150 targets of 680 kb, W = 5 words,
     three hashes, about 1.85 M Bloom rows: the demo DB's shape), held
     byte for byte against the port's ``--device cpu`` run, which the CPU
     tests hold byte-identical to ``kmcp_tpu search --backend host``.
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
    rows; K2' gets the read chunk the count tail launches it on)."""
    from kmcp_tpu_torch.search.count import count_mask, count_mask_plain
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
        log(f"phase 3 hash_loc [{label}] B={B} lmax={lmax}: exact "
            f"(max abs err 0); kernel {ms:.3f} ms, plain {ms_p:.3f} ms")
        res["hash_loc"].append((label, err, ms, ms_p))

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
        lc = loc[:Bc].contiguous()
        counts, mask = count_mask(bits, lc, cthr, thr)
        counts_p, mask_p = count_mask_plain(bits, lc, cthr, thr)
        torch.cuda.synchronize()
        err = max(max_abs_err(torch, counts, counts_p),
                  max_abs_err(torch, mask, mask_p))
        if err:
            raise AssertionError(f"count_mask {label}: max abs err {err}")
        n_set = int(torch.count_nonzero(mask))
        ms = time_ms(torch, lambda: count_mask(bits, lc, cthr, thr))
        ms_p = time_ms(torch, lambda: count_mask_plain(bits, lc, cthr, thr))
        log(f"phase 3 count_mask [{label}] B={Bc} K={lmax - K + 1}: exact "
            f"(max abs err 0, {n_set} mask words set); kernel {ms:.3f} ms, "
            f"plain {ms_p:.3f} ms")
        res["count_mask"].append((label, err, ms, ms_p))
        del bits, counts, mask, counts_p, mask_p
    return res


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
                    n_source: int, reference: str) -> dict:
    """The port on ``dev`` against a reference run of the same reads:
    ``plain`` (the same path on ``dev`` with the plain versions) or
    ``cpu`` (the port's CPU run).  The TSVs must be byte-identical."""
    from kmcp_tpu_torch.commands.search import run_search
    from kmcp_tpu_torch.search.count import count_mask
    from kmcp_tpu_torch.search.hash_loc import hash_loc

    out_dev = os.path.join(SCRATCH, f"{label}.{dev.type}.tsv")
    out_ref = os.path.join(SCRATCH, f"{label}.{reference}.tsv")
    stats: dict = {}
    hash_loc.launches = count_mask.launches = 0
    t0 = time.time()
    total, matched = run_search(db, [reads], out_file=out_dev, device=dev,
                                verbose=False, stats=stats)
    dev_s = time.time() - t0
    launches = {"hash_loc": hash_loc.launches,
                "count_mask": count_mask.launches}

    ref_stats: dict = {}
    t0 = time.time()
    if reference == "plain":
        with plain_kernels():
            ref = run_search(db, [reads], out_file=out_ref, device=dev,
                             verbose=False, stats=ref_stats)
    else:
        ref = run_search(db, [reads], out_file=out_ref, device="cpu",
                         verbose=False, stats=ref_stats)
    ref_s = time.time() - t0
    if (hash_loc.launches, count_mask.launches) != tuple(launches.values()):
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
    for name, n in launches.items():
        if dev.type == "cuda" and n <= 0:  # CPU tensors take the plain path
            raise AssertionError(f"{label}: kernel {name} never launched")
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
    return {"launches": launches, "device_rps": total / dev_s,
            "retries": stats["retries"]}


def main() -> int:
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

    os.makedirs(SCRATCH, exist_ok=True)
    t0 = time.time()
    wide_db, genomes = build_db("wide", WIDE_GENOMES, WIDE_CHUNKS, 1000, 1, 42)
    build_s = time.time() - t0
    reads = os.path.join(SCRATCH, "wide.reads.fq")
    n_source = write_reads(reads, genomes, 7)
    del genomes
    log(f"phase 4 DB: {WIDE_GENOMES * WIDE_CHUNKS} targets built in "
        f"{build_s:.1f} s")
    wide = phase_main_path(torch, dev, "phase 4 wide", wide_db, reads,
                           n_source, "plain")

    t0 = time.time()
    narrow_db, genomes = build_db("narrow", NARROW_GENOMES, NARROW_CHUNKS,
                                  680_000, 3, 43)
    reads = os.path.join(SCRATCH, "narrow.reads.fq")
    n_source = write_reads(reads, genomes, 8)
    del genomes
    log(f"phase 5 DB: {NARROW_GENOMES * NARROW_CHUNKS} targets, 3 hashes, "
        f"built in {time.time() - t0:.1f} s")
    phase_main_path(torch, dev, "phase 5 narrow", narrow_db, reads,
                    n_source, "cpu")

    sources = {
        "hash_loc": ("kmcp_tpu_torch/csrc/hash_loc.cu",
                     "kmcp_tpu/search/pallas_hash.py:36"),
        "count_mask": ("kmcp_tpu_torch/csrc/count_mask.cu",
                       "kmcp_tpu/search/pallas_count.py:146,363,488"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        rows = kern[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": wide["launches"][name],
            "max_abs_err": max(r[1] for r in rows),
            "ms": rows[0][2], "plain_ms": rows[0][3], "shape": rows[0][0],
        })
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
