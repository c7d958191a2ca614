"""K2' count_mask and K5' pair_count at a real KMCP DB's row count, against
an earlier version of themselves, on one card.

KMCP's profiling DBs split each genome into 10 chunks; at GTDB r202's
~317 kb mean chunk and ``index -f 0.3 -n 1`` a Bloom needs about 2^20
rows (tools/gtdb_rehearsal.py).  The shapes here are the dense tail's
read chunk and the screened pass 2 at such rows:

- K2' (a) 2^20 rows x 4,096 words, h = 1, 2,048 reads, K = 140 (17.2 GB
  of bits); (b) the same at K = 300 on bits whose counts pass 255; (c)
  2^20 rows x 1,024 words, h = 3, 8,192 reads; (d) 16,000 rows x 4,096
  words, h = 1 (the TPU's row-group range);
- K5' 32 blocks x 4,096 targets, 20,480 pairs of a 16,384-read batch, at
  s_block = 16,000 and 2^20 rows, K = 140 and 300.

The bits, locations and pairs are made on the card from a seeded
``torch.Generator``.  Every launch must equal the plain version.  Given
``--parent`` (a directory holding an earlier checkout's ``csrc/`` with
the same entry points) the parent's library is built with the same nvcc
flags; given ``--force``, copies of this checkout's ``csrc/`` with one
edit each (``FORCED``: "gather" takes the gather where this one takes the
ring), built alike.  All are timed in turns (each in order, then
in reverse), CUDA events, median of ``--reps`` after a warm-up; without
either, this checkout alone.  The bound counts the Bloom rows the
locations touch, read once, and every other input and output once.
Prints one JSON object a shape and writes them all to ``--out``.

    python -m kmcp_tpu_torch.tools.tall_ab [--parent DIR] [--only a,b]
        [--force gather,depth5,regs]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys

import numpy as np
import torch

from ..kernels import _build
from ..search.count import count_mask, count_mask_plain, count_mask_variant
from ..search.device_step import FLOOR_NEVER
from ..search.pair_count import (
    block_order, pair_count, pair_count_plain, pair_count_variant,
)

TALL = 1 << 20
# (id, rows S, words W, hashes h, reads B, windows K, density: uniform
#  words ANDed (< 0) or ORed (> 0) into each word)
COUNT_CASES = (
    ("a", TALL, 4096, 1, 2048, 140, -1),
    ("b", TALL, 4096, 1, 2048, 300, 2),
    ("c", TALL, 1024, 3, 8192, 140, 1),
    ("d", 16_000, 4096, 1, 2048, 140, -1),
)
# (id, s_block, windows K); 32 blocks of 128 words, 20,480 pairs of a
# 16,384-read batch
PAIR_CASES = (
    ("p16k-140", 16_000, 140), ("p16k-300", 16_000, 300),
    ("ptall-140", TALL, 140), ("ptall-300", TALL, 300),
)
PAIR_BLOCKS, PAIR_W, PAIR_P, PAIR_B = 32, 128, 20_480, 16_384
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# Copies of csrc/ with one edit each, for --force: (file, old, new) text
# edits.  "gather" takes the gather where this checkout takes the ring (the
# variant the ring replaced, timed in the same call); "depth5" gives a
# warp's ring 5 stages at one hash (one CTA an SM at 512-word spans);
# "regs" lifts the 64-register cap of the 9-plane ring kernels.
FORCED = {
    "gather": [("geometry.cuh", "return RING;", "return GATHER;")],
    "depth5": [("geometry.cuh", "return h <= 2 ? 4 : h == 3 ? 3 : 2;",
                "return h == 1 ? 5 : h <= 2 ? 4 : h == 3 ? 3 : 2;")],
    "regs": [("count_mask.cu", "NL <= 9 ? 2 : 1", "NL <= 8 ? 2 : 1"),
             ("pair_count.cu", "NL <= 9 ? 2 : 1", "NL <= 8 ? 2 : 1")],
}


def build_forced(name: str, root: str):
    """This checkout's csrc/ with FORCED[name]'s edits, built into
    root/name with the package's nvcc flags."""
    d = os.path.join(root, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, d)
    for fname, old, new in FORCED[name]:
        path = os.path.join(d, fname)
        with open(path) as f:
            src = f.read()
        if old not in src:
            raise SystemExit(f"--force {name}: anchor not found: {old!r}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    so = os.path.join(d, "lib.so")
    log = _build.compile_library(sorted(glob.glob(os.path.join(d, "*.cu"))),
                                 so)
    with open(os.path.join(d, "build.log"), "w") as f:
        f.write(log)
    return _build.load(so)


def random_words(gen, rows: int, words: int, dens: int) -> torch.Tensor:
    """[rows + 1, words] int32 uniform words on the card, each ANDed (dens
    < 0) or ORed (dens > 0) with |dens| more, the last row zero; made in
    slabs of rows so that no temporary is as large as the matrix."""
    out = torch.empty((rows + 1, words), dtype=torch.int32, device="cuda")
    step = max(1, (1 << 28) // (4 * words))
    for r0 in range(0, rows + 1, step):
        r1 = min(rows + 1, r0 + step)
        x = torch.randint(-2**31, 2**31, (r1 - r0, words), dtype=torch.int32,
                          device="cuda", generator=gen)
        for _ in range(abs(dens)):
            y = torch.randint(-2**31, 2**31, x.shape, dtype=torch.int32,
                              device="cuda", generator=gen)
            x = x & y if dens < 0 else x | y
        out[r0:r1] = x
    out[-1] = 0
    return out


def random_loc(gen, shape, rows: int) -> torch.Tensor:
    """Uniform rows 0..rows-1 on the card, 5% of the windows the sentinel
    ``rows`` (invalid windows)."""
    loc = torch.randint(0, rows, shape, dtype=torch.int32, device="cuda",
                        generator=gen)
    bad = torch.rand(shape[:2], device="cuda", generator=gen) < 0.05
    loc[bad] = rows
    return loc


def floors_near(gen, n: int, mean: int, spread: int) -> torch.Tensor:
    return torch.randint(mean - spread, mean + spread, (n,),
                         dtype=torch.int32, device="cuda", generator=gen)


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def in_turns(libs: dict, fn, reps: int) -> dict:
    """{name: [ms, ...]} of fn launching from each library, in turns (each
    in order, then in reverse) or this alone."""
    order = list(libs) + list(reversed(libs)) if len(libs) > 1 else ["new"]
    times: dict = {}
    for name in order:
        with _build.using(libs[name]):
            times.setdefault(name, []).append(median_ms(fn, reps))
    return times


def exact_in(libs: dict, fn, want, variant) -> tuple[bool, dict]:
    """Whether fn() from every library equals ``want``, and the variant
    each library ran (``variant()`` under it)."""
    ok, ran = True, {}
    for name, lib in libs.items():
        with _build.using(lib):
            got = fn()
            ran[name] = variant()
        torch.cuda.synchronize()
        ok &= all(torch.equal(g, w) for g, w in zip(got, want))
        del got
    return ok, ran


def count_case(libs, gen, reps, S, W, h, B, K, dens) -> dict:
    bits = random_words(gen, S, W, dens)
    loc = random_loc(gen, (B, K, h), S)
    # floors near the mean count, so that both outcomes occur
    p = 0.5 ** (abs(dens) + 1)
    lo = int(0.95 * K * (p if dens < 0 else 1 - p) ** h)
    thr = floors_near(gen, 32 * W, lo, 10)
    thr[-7:] = FLOOR_NEVER  # padding lanes
    cthr = floors_near(gen, B, lo, 20)
    cthr[::97] = FLOOR_NEVER  # excluded reads
    args = (bits, loc, cthr, thr)
    want = count_mask_plain(*args)
    over = int((want[0] > 255).sum())
    ok, ran = exact_in(libs, lambda: count_mask(*args, rows_checked=True),
                       want, lambda: count_mask_variant(W, S + 1, h))
    del want
    times = in_turns(libs, lambda: count_mask(*args, rows_checked=True), reps)
    rows = torch.unique(loc).numel()
    n = rows * W * 4 + (loc.numel() + B + 32 * W + B * 32 * W + B * W) * 4
    return {"exact": ok, "counts_over_255": over, "rows_touched": rows,
            "variant": ran, "times": times,
            "bound_ms": n / HBM_BYTES_PER_S * 1e3}


def pair_case(libs, gen, reps, s_block, K) -> dict:
    nb, W, P, B = PAIR_BLOCKS, PAIR_W, PAIR_P, PAIR_B
    bits = random_words(gen, nb * s_block, W, -1 if K < 256 else 2)
    loc = random_loc(gen, (B, K), s_block)
    flat = torch.randperm(B * nb, device="cuda", generator=gen)[:P].sort()[0]
    pb, pg = (flat // nb).to(torch.int32), (flat % nb).to(torch.int32)
    # a read needs about half its windows (single-end), or 85% of them
    # on the paired rows' denser bits; one in 500 a quarter of that
    need = K // 2 + 2 if K < 256 else K * 85 // 100
    cthr = torch.full((B,), need, dtype=torch.int32, device="cuda")
    cthr[::500] = need // 4
    thr = torch.randint(1, 10, (nb, 32 * W), dtype=torch.int32, device="cuda",
                        generator=gen)
    thr[:, -7:] = FLOOR_NEVER
    args = (bits, loc, pb, pg, cthr, thr)
    want = pair_count_plain(*args)
    over = int((want[0] > 255).sum())
    ok, ran = exact_in(libs, lambda: pair_count(*args, rows_checked=True),
                       want, lambda: pair_count_variant(W, s_block))
    del want
    times = in_turns(libs, lambda: pair_count(*args, rows_checked=True), reps)
    # the wrapper's block sort, which every variant but the gather runs
    times["block_order"] = [median_ms(lambda: block_order(pg, nb), reps)]
    reads = torch.unique(pb)
    rows = torch.unique(pg.long()[:, None] * (s_block + 1)
                        + loc[pb.long()]).numel()
    n = (rows * W + reads.numel() * (K + 1) + nb * 32 * W
         + 2 * P + P * 32 * W + P * W) * 4
    return {"exact": ok, "counts_over_255": over, "rows_touched": rows,
            "variant": ran, "times": times,
            "bound_ms": n / HBM_BYTES_PER_S * 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", help="comma-separated case ids")
    ap.add_argument("--force", help="comma-separated FORCED variants")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    libs = {"new": _build.get_lib()}
    if args.parent:
        libs["old"] = _build.build_checkout(
            os.path.join(args.parent, "csrc"),
            os.path.join(args.parent, "build", "libparent_tall.so"))
    for name in args.force.split(",") if args.force else []:
        libs[name] = build_forced(name, os.path.join(_build.BUILD_DIR,
                                                     "forced"))
    only = set(args.only.split(",")) if args.only else None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2027)
    rows = []
    cases = ([("count_mask", c[0], c[1:]) for c in COUNT_CASES]
             + [("pair_count", c[0], c[1:]) for c in PAIR_CASES])
    for kernel, cid, shape in cases:
        if only and cid not in only:
            continue
        if kernel == "count_mask":
            S, W, h, B, K, dens = shape
            label = f"({cid}) S={S} W={W} h={h} B={B} K={K}"
            row = count_case(libs, gen, args.reps, *shape)
        else:
            s_block, K = shape
            label = (f"({cid}) nb={PAIR_BLOCKS} s_block={s_block} "
                     f"W={PAIR_W} P={PAIR_P} K={K}")
            row = pair_case(libs, gen, args.reps, s_block, K)
        new = float(np.median(row["times"]["new"]))
        row = {"kernel": kernel, "shape": label, **row,
               "ratio_to_bound": new / row["bound_ms"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
        if not row["exact"]:
            raise AssertionError(f"{label}: a kernel differs from the plain "
                                 "version")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
