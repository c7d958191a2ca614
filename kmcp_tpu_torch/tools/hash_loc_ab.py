"""K1' hash_loc against an earlier version of itself, on one card.

Builds this checkout's kernels (kmcp_tpu_torch/kernels/_build.py) and, with
the same nvcc flags, the ``csrc/hash_loc.cu`` of an earlier checkout of
kmcp_tpu_torch (``--parent``, a directory holding its ``csrc/``: the K1'
that rolls each read in one thread and has no value plane), then times
both, in turns (earlier, this, this, earlier), CUDA events, median of
``--reps`` after a warm-up, at chip_smoke.py phase 3's shapes: 16,384 reads
of 150 bp in lmax = 160 rows at S = 3,578 h = 1, S = 1,850,000 h = 3 and
with the 2^25-row screen plane; and 16,384 joined 150 + N + 150 bp pairs in
lmax = 320 rows with the screen plane, which this checkout also times with
the value plane (the earlier kernel has none).  Every output must equal the
plain version's.

Two times each: ``call`` is CUDA events around one wrapper call, as
chip_smoke.py times its other kernels; at tens of microseconds it includes
the host's enqueue of the launch while the card waits.  ``device`` is the
card's time per launch: CUDA events around the replay of a CUDA graph of
``--graph`` launches.  Prints one JSON object per shape and, given
``--out``, writes them all there.

    python -m kmcp_tpu_torch.tools.hash_loc_ab --parent DIR
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

from ..kernels import _build
from ..kmer.nthash import SEED_A, SEED_C, SEED_G, SEED_T
from ..search.hash_loc import hash_loc, hash_loc_plain

B, K, FULL = 16_384, 21, (1 << 64) - 1
N = 1 << 25
# (label, lmax, S, h, screen rows, paired rows)
CASES = (("S=3578 h=1", 160, 3578, 1, 0, False),
         ("S=1850000 h=3", 160, 1_850_000, 3, 0, False),
         ("screen S=3578 N=2^25", 160, 3578, 1, N, False),
         ("paired screen S=3578 N=2^25 lmax=320", 320, 3578, 1, N, True))


def build_parent(parent: str, out_dir: str) -> ctypes.CDLL:
    src = os.path.join(parent, "csrc", "hash_loc.cu")
    if not os.path.isfile(src):
        raise SystemExit(f"no csrc/hash_loc.cu under {parent}")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libparent_hash_loc.so")
    _build.compile_library([src], so)
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    i64, u64 = ctypes.c_longlong, ctypes.c_ulonglong
    lib.kmcp_hash_loc.argtypes = [vp, i32, i32, i32, i64, u64, i32, u64, u64,
                                  u64, u64, i64, vp, vp, vp, vp]
    lib.kmcp_hash_loc.restype = i32
    return lib


def reads_of(rng, paired: bool, lmax: int) -> np.ndarray:
    """Random ACGT/acgt reads with a few N, one in eight mates shorter; as
    joined mate1 + N + mate2 rows when ``paired``."""
    alphabet = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
    p = [0.125] * 4 + [0.1235] * 4 + [0.006]
    out = np.zeros((B, lmax), dtype=np.uint8)
    for b in range(B):
        mates = [rng.choice(alphabet, size=150 if rng.random() > 0.125 else
                            int(rng.integers(0, 150)), p=p).tobytes()
                 for _ in range(2 if paired else 1)]
        row = b"N".join(m for m in mates if m)
        out[b, : len(row)] = np.frombuffer(row, np.uint8)
    return out


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


def graph_ms(fn, n: int, reps: int) -> float:
    """Device ms per launch: n calls of fn captured in a CUDA graph (after
    one call outside it), replayed between CUDA events; median of reps."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return median_ms(g.replay, reps) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--graph", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.get_lib()
    old = build_parent(args.parent, os.path.join(args.parent, "build"))
    rng = np.random.default_rng(2024)
    rows = []
    for label, lmax, S, h, NS, paired in CASES:
        reads = torch.from_numpy(reads_of(rng, paired, lmax)).to(dev)
        Kw = lmax - K + 1
        o_loc = torch.empty((B, Kw, h), dtype=torch.int32, device=dev)
        o_nk = torch.empty(B, dtype=torch.int32, device=dev)
        o_locu = torch.empty((B, Kw), dtype=torch.int32, device=dev)

        def run_old():
            rc = old.kmcp_hash_loc(
                reads.data_ptr(), B, lmax, K, S, FULL, h, int(SEED_A),
                int(SEED_C), int(SEED_G), int(SEED_T), NS, o_loc.data_ptr(),
                o_locu.data_ptr() if NS else None, o_nk.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"earlier hash_loc: cuda error {rc}")

        want = hash_loc_plain(reads, K, S, FULL, h, NS, values=True)
        run_old()
        got_new = hash_loc(reads, K, S, FULL, h, NS, values=True)
        torch.cuda.synchronize()
        got_old = (o_loc, o_nk) + ((o_locu,) if NS else ())
        for g, w in zip(got_old, want):
            assert torch.equal(g, w), f"{label}: earlier kernel differs"
        for g, w in zip(got_new, want):
            assert torch.equal(g, w), f"{label}: this kernel differs"
        new = lambda v: hash_loc(reads, K, S, FULL, h, NS, values=v)  # noqa: E731
        row = {"shape": label, "B": B, "lmax": lmax, "exact": True}
        for kind, timer in (("call", lambda f: median_ms(f, args.reps)),
                            ("device", lambda f: graph_ms(f, args.graph,
                                                          args.reps))):
            t = [timer(run_old), timer(lambda: new(False)),
                 timer(lambda: new(False)), timer(run_old)]
            row[f"earlier_{kind}_ms"] = [t[0], t[3]]
            row[f"this_{kind}_ms"] = [t[1], t[2]]
            if paired:
                row[f"this_values_{kind}_ms"] = [timer(lambda: new(True))
                                                 for _ in range(2)]
        rows.append(row)
        print(json.dumps(row), flush=True)
        del reads, o_loc, o_nk, o_locu, want, got_new
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
