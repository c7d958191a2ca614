"""The screened pass-2 kernels K5' pair_count and K6' group_count against
an earlier version of themselves, on one card.

Builds this checkout's kernels (kmcp_tpu_torch/kernels/_build.py) and, with
the same nvcc flags, the ``csrc/*.cu`` of an earlier checkout of
kmcp_tpu_torch with the same entry points (``--parent``, a directory
holding its ``csrc/``), then times, at chip_smoke.py phase 3's pass-2
shapes (32 and 128 blocks of 4,096 targets and 3,578 rows, 20,480 and
36,864 read-major pairs of a 16,384-read batch, 140 windows a read for
single-end rows and 300 for the joined rows of 2 x 150 bp), launching from
each library in turns (earlier, this, this, earlier), CUDA events, median
of ``--reps`` after a warm-up:

- each kernel as its wrapper runs it (K5' with its block sort);
- each whole route as the screened tail runs it, ``screen.pass2_fixed``
  on K5' and on K6' (block sort, fused floors, fixed-budget compaction at
  2 slots a read, chunk splice);
- the torch steps around the kernels alone: the block sort and the
  fixed-budget compaction ``compact_mask``.

Every output must equal the plain versions'.  Prints one JSON object per
shape and, given ``--out``, writes them all there.

    python -m kmcp_tpu_torch.tools.pass2_ab --parent DIR
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..kernels import _build
from ..search import screen
from ..search.device_step import FLOOR_NEVER, compact_mask, mask_hits
from ..search.group_count import gemm_slabs, group_count, s_pad_for
from ..search.pair_count import block_order, pair_count, pair_count_plain

CASES = ((32, 20_480), (128, 36_864))  # (blocks, pairs)
KS = (140, 300)  # windows a read: single-end and paired rows
B, S_BLOCK, W = 16_384, 3_578, 128


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
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    libs = {"new": _build.get_lib(),
            "old": _build.build_checkout(
                os.path.join(args.parent, "csrc"),
                os.path.join(args.parent, "build", "libparent_pass2.so"))}
    rng = np.random.default_rng(2025)
    rows = []
    for K in KS:
        for nb, P in CASES:
            as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            bw = rng.integers(0, 2**32, (nb * S_BLOCK + 1, W),
                              dtype=np.uint32)
            bw &= rng.integers(0, 2**32, bw.shape, dtype=np.uint32)
            bw[-1] = 0
            bits = as_dev(bw.view(np.int32))
            del bw
            loc_np = rng.integers(0, S_BLOCK, (B, K)).astype(np.int32)
            loc_np[rng.random((B, K)) < 0.05] = S_BLOCK
            loc = as_dev(loc_np)
            flat = np.sort(rng.choice(B * nb, size=P, replace=False))
            pb = as_dev((flat // nb).astype(np.int32))
            pg = as_dev((flat % nb).astype(np.int32))
            # a read needs about half its windows; one in 500 a quarter
            cthr_np = np.full(B, K // 2 + 2, dtype=np.int32)
            cthr_np[rng.random(B) < 0.002] = K * 33 // 140
            cthr = as_dev(cthr_np)
            thr_np = rng.integers(1, 10, (nb, 32 * W)).astype(np.int32)
            thr_np[:, -7:] = FLOOR_NEVER
            thr = as_dev(thr_np)
            T = 32 * W
            chunk = screen.pass2_chunk(T)
            budget = 2 * B  # the streamer's starting candidate slots
            slabs = gemm_slabs(bits, nb, S_BLOCK, s_pad_for(S_BLOCK))
            fns = {
                "k5": lambda: pair_count(bits, loc, pb, pg, cthr, thr,
                                         rows_checked=True),
                "k6": lambda: group_count(slabs, loc, pb, pg, cthr, thr,
                                          S_BLOCK, rows_checked=True),
                "route5": lambda: screen.pass2_fixed(
                    "pair", bits, None, loc, pb, pg, cthr, thr, S_BLOCK,
                    budget, chunk),
                "route6": lambda: screen.pass2_fixed(
                    "gemm", None, slabs, loc, pb, pg, cthr, thr, S_BLOCK,
                    budget, chunk),
            }
            # every output of both libraries against the plain version:
            # the kernels' counts and mask, the routes' (read, lane g T + t,
            # count) of the first ``budget`` candidates and the exact total
            want_c, want_m = pair_count_plain(bits, loc, pb, pg, cthr, thr)
            p, t = mask_hits(want_m)
            n_want = min(p.numel(), budget)
            want_fixed = (pb[p].long()[:n_want],
                          (pg[p].long() * T + t)[:n_want],
                          want_c[p, t][:n_want])
            exact = True
            for lib in libs.values():
                with _build.using(lib):
                    outs = {k: fns[k]() for k in fns}
                torch.cuda.synchronize()
                exact &= all(torch.equal(a, b) for k in ("k5", "k6")
                             for a, b in zip(outs[k], (want_c, want_m)))
                exact &= all(
                    int(n) == p.numel() and all(
                        torch.equal(a[v].to(b.dtype), b)
                        for a, b in zip(lanes, want_fixed))
                    for n, lanes, v in (outs["route5"], outs["route6"]))
                del outs
            times: dict = {}
            for name, fn in fns.items():
                for which in ("old", "new", "new", "old"):
                    with _build.using(libs[which]):
                        times.setdefault(f"{name}_{which}", []).append(
                            median_ms(fn, args.reps))
            # the torch steps around the kernels, alone
            times["block_order"] = [median_ms(lambda: block_order(pg, nb),
                                              args.reps)]
            times["compact_mask"] = [median_ms(
                lambda: compact_mask(want_m, budget, 0), args.reps)]
            row = {"shape": f"nb={nb} P={P} s_block={S_BLOCK} W={W} K={K}",
                   "exact": exact,
                   **{f"{k}_ms": v for k, v in times.items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)
            if not exact:
                raise AssertionError(f"nb={nb} K={K}: a kernel or route "
                                     "differs from the plain versions")
            del bits, loc, slabs, want_c, want_m
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
