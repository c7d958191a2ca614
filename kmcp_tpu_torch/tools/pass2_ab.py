"""The screened pass-2 kernels K5' pair_count and K6' group_count against
an earlier version of themselves, on one card.

Builds this checkout's kernels (kmcp_tpu_torch/kernels/_build.py) and, with
the same nvcc flags, the ``csrc/*.cu`` of an earlier checkout of
kmcp_tpu_torch (``--parent``, a directory holding its ``csrc/``: the K5'
that takes pairs one thread per (pair, word) and the K6' that multiplies a
materialised U on ``wmma``), then times, at chip_smoke.py phase 3's pass-2
shapes (32 and 128 blocks of 4,096 targets and 3,578 rows, 20,480 and
36,864 read-major pairs of a 16,384-read batch, 140 windows a read), in
turns (earlier, this, this, earlier), CUDA events, median of ``--reps``
after a warm-up:

- each kernel as its wrapper runs it (the earlier K6' on the U, slabs and
  block tiles its route built, outside the time);
- each whole route as the screened tail runs it: the earlier K5' + its
  exact-size compaction, and the earlier U build + kernel + floors in
  torch + compaction + restoring sort, against this checkout's
  ``screen.pass2_fixed`` on K5' and on K6' (block sort, fused floors,
  fixed-budget compaction at 2 slots a read, chunk splice);
- this checkout's torch steps around the kernels alone: the block sort
  and the fixed-budget compaction ``compact_mask``.

Every output must equal the plain versions'.  Prints one JSON object per
shape and, given ``--out``, writes them all there.

    python -m kmcp_tpu_torch.tools.pass2_ab --parent DIR
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
from ..search import screen
from ..search.device_step import FLOOR_NEVER, compact_mask, mask_hits
from ..search.group_count import build_u, gemm_slabs, group_count, s_pad_for
from ..search.pair_count import block_order, pair_count, pair_count_plain

CASES = ((32, 20_480), (128, 36_864))  # (blocks, pairs)
B, S_BLOCK, W, K = 16_384, 3_578, 128, 140
OLD_TILE, OLD_S_ALIGN = 64, 32  # the earlier K6''s pair tile and depth step


def build_parent(parent: str, out_dir: str) -> ctypes.CDLL:
    srcs = sorted(glob.glob(os.path.join(parent, "csrc", "*.cu")))
    if not srcs:
        raise SystemExit(f"no csrc/*.cu under {parent}")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libparent_pass2.so")
    _build.compile_library(srcs, so)
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kmcp_pair_count.argtypes = [vp, i32, i32, i32, vp, i32, vp, vp, i32,
                                    vp, vp, vp, vp, vp]
    lib.kmcp_pair_count.restype = i32
    lib.kmcp_group_count.argtypes = [vp, i32, i32, i32, vp, vp, i32, vp, vp]
    lib.kmcp_group_count.restype = i32
    return lib


def old_slabs(bits: torch.Tensor, nb: int) -> torch.Tensor:
    """The earlier K6''s int8 0/1 slabs [nb, S_pad, 32 W]."""
    S_pad = -(-(S_BLOCK + 1) // OLD_S_ALIGN) * OLD_S_ALIGN
    out = torch.zeros((nb, S_pad, 32 * W), dtype=torch.int8,
                      device=bits.device)
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    for g in range(nb):
        b = bits[g * S_BLOCK : (g + 1) * S_BLOCK]
        out[g, :S_BLOCK] = ((b[..., None] >> shifts) & 1).to(
            torch.int8).reshape(S_BLOCK, 32 * W)
    return out


def old_block_tiles(pg: torch.Tensor, nb: int):
    """The earlier route's block sort: pair i to row slot[i] of block-sorted
    tiles of 64, tile r holding block blk[r]."""
    order = torch.argsort(pg, stable=True)
    cnt = torch.bincount(pg.long(), minlength=nb)
    padded = (cnt + OLD_TILE - 1) // OLD_TILE * OLD_TILE
    pbase = torch.cumsum(padded, 0) - padded
    start = torch.cumsum(cnt, 0) - cnt
    g_s = pg[order].long()
    slot = torch.empty_like(order)
    slot[order] = pbase[g_s] + torch.arange(
        order.shape[0], device=pg.device) - start[g_s]
    blk = torch.repeat_interleave(
        torch.arange(nb, dtype=torch.int32, device=pg.device),
        padded // OLD_TILE)
    return slot, blk


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
    _build.get_lib()
    old = build_parent(args.parent, os.path.join(args.parent, "build"))
    rng = np.random.default_rng(2025)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for nb, P in CASES:
        as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        bw = rng.integers(0, 2**32, (nb * S_BLOCK + 1, W), dtype=np.uint32)
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
        cthr_np = np.full(B, 72, dtype=np.int32)
        cthr_np[rng.random(B) < 0.002] = 33
        cthr = as_dev(cthr_np)
        thr_np = rng.integers(1, 10, (nb, 32 * W)).astype(np.int32)
        thr_np[:, -7:] = FLOOR_NEVER
        thr = as_dev(thr_np)
        T = 32 * W
        chunk = screen.pass2_chunk(T)
        budget = 2 * B  # the streamer's starting candidate slots

        want_c, want_m = pair_count_plain(bits, loc, pb, pg, cthr, thr)
        # the earlier K5'
        oc = torch.empty_like(want_c)
        om = torch.empty_like(want_m)

        def old_k5():
            rc = old.kmcp_pair_count(
                bits.data_ptr(), W, nb, S_BLOCK, loc.data_ptr(), K,
                pb.data_ptr(), pg.data_ptr(), P, cthr.data_ptr(),
                thr.data_ptr(), oc.data_ptr(), om.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"earlier pair_count: cuda error {rc}")

        def old_k5_route():
            old_k5()
            p, t = mask_hits(om)
            return p, t, oc[p, t]

        # the earlier K6' route: U build, kernel, torch floors, nonzero and
        # the restoring sort (search/screen.py of the earlier checkout)
        slabs8 = old_slabs(bits, nb)
        S_old = slabs8.shape[1]
        slot, blk = old_block_tiles(pg, nb)
        P_pad = OLD_TILE * blk.shape[0]
        pb_pad = torch.full((P_pad,), B, dtype=torch.int64, device=dev)
        pb_pad[slot] = pb.long()
        pair_of = torch.full((P_pad,), -1, dtype=torch.int64, device=dev)
        pair_of[slot] = torch.arange(P, device=dev)
        loc_ext = torch.cat([loc, loc.new_full((1, K), S_BLOCK)])
        cthr_ext = torch.cat([cthr, cthr.new_full((1,), FLOOR_NEVER)])
        thr_ext = torch.cat([thr, thr.new_full((1, T), FLOOR_NEVER)])
        u = build_u(loc_ext[pb_pad], S_old)
        o6 = torch.empty((P_pad, T), dtype=torch.int32, device=dev)

        def old_k6(u_=u, out=o6):
            rc = old.kmcp_group_count(
                slabs8.data_ptr(), nb, S_old, T, u_.data_ptr(),
                blk.data_ptr(), blk.shape[0], out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"earlier group_count: cuda error {rc}")

        def old_k6_route():
            uu = build_u(loc_ext[pb_pad], S_old)
            out = torch.empty((P_pad, T), dtype=torch.int32, device=dev)
            old_k6(uu, out)
            c3 = out.view(-1, OLD_TILE, T)
            ok = ((c3 >= thr_ext[blk.long()][:, None, :])
                  & (c3 >= cthr_ext[pb_pad].view(-1, OLD_TILE, 1)))
            s, t = torch.nonzero(ok.view(P_pad, T), as_tuple=True)
            p = pair_of[s]
            order = torch.argsort(p, stable=True)
            return p[order], t[order], out[s, t][order]

        slabs = gemm_slabs(bits, nb, S_BLOCK, s_pad_for(S_BLOCK))
        fns = {
            "k5_old": old_k5,
            "k5_new": lambda: pair_count(bits, loc, pb, pg, cthr, thr,
                                         rows_checked=True),
            "k6_old": old_k6,
            "k6_new": lambda: group_count(slabs, loc, pb, pg, cthr, thr,
                                          S_BLOCK, rows_checked=True),
            "route5_old": old_k5_route,
            "route5_new": lambda: screen.pass2_fixed(
                "pair", bits, None, loc, pb, pg, cthr, thr, S_BLOCK, budget,
                chunk),
            "route6_old": old_k6_route,
            "route6_new": lambda: screen.pass2_fixed(
                "gemm", None, slabs, loc, pb, pg, cthr, thr, S_BLOCK, budget,
                chunk),
        }
        # every output against the plain versions
        old_k5()
        old_k6()
        new5 = fns["k5_new"]()
        new6 = fns["k6_new"]()
        routes = [fns[k]() for k in ("route5_old", "route6_old")]
        fixed = [fns[k]() for k in ("route5_new", "route6_new")]
        torch.cuda.synchronize()
        p, t = mask_hits(want_m)
        want_route = (p, t, want_c[p, t])
        # the fixed-budget routes: (read, lane g T + t, count), the
        # first ``budget`` candidates, and the exact total
        n_want = min(p.numel(), budget)
        want_fixed = (pb[p].long()[:n_want], (pg[p].long() * T + t)[:n_want],
                      want_c[p, t][:n_want])
        exact = (torch.equal(oc, want_c) and torch.equal(om, want_m)
                 and torch.equal(o6[slot], want_c)
                 and all(torch.equal(a, b) for a, b in zip(new5, (want_c, want_m)))
                 and all(torch.equal(a, b) for a, b in zip(new6, (want_c, want_m)))
                 and all(torch.equal(a, b) for r in routes
                         for a, b in zip(r, want_route))
                 and all(int(n) == p.numel() and all(
                     torch.equal(a[v].to(b.dtype), b)
                     for a, b in zip(lanes, want_fixed))
                     for n, lanes, v in fixed))
        del new5, new6, routes, fixed
        times: dict = {k: [] for k in fns}
        for pair in (("k5", "old", "new"), ("k6", "old", "new"),
                     ("route5", "old", "new"), ("route6", "old", "new")):
            name = pair[0]
            for which in ("old", "new", "new", "old"):
                times[f"{name}_{which}"].append(
                    median_ms(fns[f"{name}_{which}"], args.reps))
        # the torch steps around the new kernels, alone
        parts = {
            "block_order": lambda: block_order(pg, nb),
            "compact_mask": lambda: compact_mask(want_m, budget, 0),
        }
        for k, fn in parts.items():
            times[k] = [median_ms(fn, args.reps)]
        row = {"shape": f"nb={nb} P={P} s_block={S_BLOCK} W={W} K={K}",
               "exact": exact, **{f"{k}_ms": v for k, v in times.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not exact:
            raise AssertionError(f"nb={nb}: a kernel or route differs from "
                                 "the plain versions")
        del bits, loc, slabs8, slabs, u, o6, oc, om, want_c, want_m
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
