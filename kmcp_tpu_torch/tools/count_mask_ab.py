"""K2' count_mask against an earlier version of itself, on one card.

Builds this checkout's kernels (kmcp_tpu_torch/kernels/_build.py) and, with
the same nvcc flags, the ``csrc/*.cu`` of an earlier checkout of
kmcp_tpu_torch (``--parent``, a directory holding its ``csrc/``), then times
both entry points at the main paths' K2' shapes in turns (earlier, this,
this, earlier), CUDA events, median of ``--reps`` launches after a warm-up.
Both must give the same counts and mask as ``count_mask_plain``.  Prints one
JSON object per shape and writes them all to ``--out``.

Shapes: wide (the dense tail's 2,048-read chunk of 131,072 targets, 3,579
rows), narrow (16,384 reads, 5 words, 3 hashes, 1.85 M rows) and pass 1 of
the screened search (16,384 reads, 1 word, 2^25 + 1 union rows).

    python -m kmcp_tpu_torch.tools.count_mask_ab --parent DIR
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import sys

import numpy as np
import torch

from ..kernels import _build
from ..search.count import count_mask, count_mask_plain

SHAPES = (
    # (label, rows S (the sentinel is one more), W, h, reads B, density)
    ("wide S=3578 h=1 W=4096 B=2048", 3578, 4096, 1, 2048, "and"),
    ("narrow S=1850000 h=3 W=5 B=16384", 1_850_000, 5, 3, 16384, "or"),
    ("pass1 S=33554432 h=1 W=1 B=16384", 1 << 25, 1, 1, 16384, "and"),
)
K = 140  # windows of a 160-byte read row at k = 21
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def build_parent(parent: str, out_dir: str) -> ctypes.CDLL:
    srcs = sorted(glob.glob(os.path.join(parent, "csrc", "*.cu")))
    if not srcs:
        raise SystemExit(f"no csrc/*.cu under {parent}")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libparent.so")
    _build.compile_library(srcs, so)
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # the earlier entry point takes no row count
    lib.kmcp_count_mask.argtypes = [vp, i32, vp, i32, i32, i32, vp, vp, vp,
                                    vp, vp]
    lib.kmcp_count_mask.restype = i32
    return lib


def bound_ms(S: int, W: int, h: int, B: int) -> float:
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
    lib_new = _build.get_lib()
    lib_old = build_parent(args.parent, os.path.join(args.parent, "build"))
    rng = np.random.default_rng(2026)
    rows = []
    for label, S, W, h, B, dens in SHAPES:
        bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
        other = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
        bits = bits & other if dens == "and" else bits | other
        bits[-1] = 0
        del other
        loc = rng.integers(0, S, (B, K, h)).astype(np.int32)
        loc[rng.random((B, K)) < 0.05] = S  # invalid windows
        thr = rng.integers(1, 10, 32 * W).astype(np.int32)
        cthr = rng.integers(30, 60, B).astype(np.int32)
        t = [torch.from_numpy(a).to(dev) for a in
             (bits.view(np.int32), loc, cthr, thr)]
        del bits, loc
        counts, mask = count_mask(*t, rows_checked=True)
        want = count_mask_plain(*t)
        out_c = torch.empty_like(counts)
        out_m = torch.empty_like(mask)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def old():
            rc = lib_old.kmcp_count_mask(
                t[0].data_ptr(), W, t[1].data_ptr(), B, K, h,
                t[2].data_ptr(), t[3].data_ptr(), out_c.data_ptr(),
                out_m.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"earlier kernel: cuda error {rc}")

        def new():
            count_mask(*t, rows_checked=True)

        old()
        torch.cuda.synchronize()
        exact = (torch.equal(counts, want[0]) and torch.equal(mask, want[1])
                 and torch.equal(out_c, want[0]) and torch.equal(out_m, want[1]))
        del want
        times = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            times[name].append(median_ms(old if name == "old" else new,
                                         args.reps))
        row = {
            "shape": label, "K": K, "exact": exact,
            "variant": ("slice" if lib_new.kmcp_count_mask_variant(W, S + 1, h)
                        == 1 else "gather"),
            "old_ms": times["old"], "new_ms": times["new"],
            "bound_ms": bound_ms(S, W, h, B),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not exact:
            raise AssertionError(f"{label}: a kernel differs from the plain "
                                 "version")
        del t, counts, mask, out_c, out_m
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
