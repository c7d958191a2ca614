"""K2' count_mask against an earlier version of itself, on one card.

Builds this checkout's kernels (kmcp_tpu_torch/kernels/_build.py) and, with
the same nvcc flags, the ``csrc/*.cu`` of an earlier checkout of
kmcp_tpu_torch with the same entry points (``--parent``, a directory
holding its ``csrc/``), then times ``count_mask`` launching from each in
turns (earlier, this, this, earlier), CUDA events, median of ``--reps``
launches after a warm-up, at the main paths' K2' shapes.  Both must give
the same counts and mask as ``count_mask_plain``.  Prints one JSON object
per shape and writes them all to ``--out``.

Shapes: wide (the dense tail's 2,048-read chunk of 131,072 targets, 3,579
rows, K = 140), paired (the same at K = 300, the joined rows of 2 x 150
bp, on rows dense enough that counts pass 255), narrow (16,384 reads, 5
words, 3 hashes, 1.85 M rows) and pass 1 of the screened search (16,384
reads, 1 word, 2^25 + 1 union rows) at K = 140 and 300.

    python -m kmcp_tpu_torch.tools.count_mask_ab --parent DIR
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..kernels import _build
from ..search.count import count_mask, count_mask_plain

SHAPES = (
    # (label, rows S (the sentinel is one more), W, h, reads B, windows K,
    #  uniform words ANDed (< 0) or ORed (> 0) into each word)
    ("wide S=3578 h=1 W=4096 B=2048 K=140", 3578, 4096, 1, 2048, 140, -1),
    ("paired S=3578 h=1 W=4096 B=2048 K=300", 3578, 4096, 1, 2048, 300, 2),
    ("narrow S=1850000 h=3 W=5 B=16384 K=140", 1_850_000, 5, 3, 16384, 140,
     1),
    ("pass1 S=33554432 h=1 W=1 B=16384 K=140", 1 << 25, 1, 1, 16384, 140,
     -1),
    ("pass1 S=33554432 h=1 W=1 B=16384 K=300", 1 << 25, 1, 1, 16384, 300,
     -1),
)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def bound_ms(S: int, W: int, h: int, B: int, K: int) -> float:
    """Bytes once (bits, loc, floors in; counts and mask out) over the
    card's memory rate."""
    n = ((S + 1) * W + B * K * h + B + 32 * W + B * 32 * W + B * W) * 4
    return n / HBM_BYTES_PER_S * 1e3


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/count_mask_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    libs = {"new": _build.get_lib(),
            "old": _build.build_checkout(
                os.path.join(args.parent, "csrc"),
                os.path.join(args.parent, "build", "libparent.so"))}
    rng = np.random.default_rng(2026)
    rows = []
    for label, S, W, h, B, K, dens in SHAPES:
        bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
        for _ in range(abs(dens)):
            other = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
            bits = bits & other if dens < 0 else bits | other
        bits[-1] = 0
        loc = rng.integers(0, S, (B, K, h)).astype(np.int32)
        loc[rng.random((B, K)) < 0.05] = S  # invalid windows
        # floors near the mean count, so that both outcomes occur
        p = 0.5 ** (abs(dens) + 1)
        lo = int(0.95 * K * (p if dens < 0 else 1 - p) ** h)
        thr = rng.integers(lo - 10, lo + 10, 32 * W).astype(np.int32)
        cthr = rng.integers(lo - 20, lo + 20, B).astype(np.int32)
        t = [torch.from_numpy(a).to(dev) for a in
             (bits.view(np.int32), loc, cthr, thr)]
        del bits, loc
        want = count_mask_plain(*t)
        exact = True
        for lib in libs.values():
            with _build.using(lib):
                got = count_mask(*t, rows_checked=True)
            torch.cuda.synchronize()
            exact &= torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                  want[1])
        over = int((want[0] > 255).sum())
        del want, got
        times = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            with _build.using(libs[name]):
                times[name].append(median_ms(
                    lambda: count_mask(*t, rows_checked=True), args.reps))
        row = {
            "shape": label, "K": K, "exact": exact, "counts_over_255": over,
            "variant": ("slice" if libs["new"].kmcp_count_mask_variant(
                W, S + 1, h) == 1 else "gather"),
            "old_ms": times["old"], "new_ms": times["new"],
            "bound_ms": bound_ms(S, W, h, B, K),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not exact:
            raise AssertionError(f"{label}: a kernel differs from the plain "
                                 "version")
        del t
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
