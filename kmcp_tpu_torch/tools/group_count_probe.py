"""Where K6''s launch spends its time: variants of csrc/group_count.cu with
one part changed or cut out, each built and timed at chip_smoke.py phase
3's pass-2 shape of 32 blocks (4,096 targets and 3,578 rows a block,
20,480 read-major pairs of a 16,384-read batch, 140 windows a read).

Each variant copies ``kmcp_tpu_torch/csrc`` to a directory under
``kmcp_tpu_torch/build/probe_k6/``, applies its text edits (a missing
anchor fails the run), builds with the package's nvcc flags and times the
C entry point on the same inputs (the block sort and pair tiles computed
once, outside the time).  Times are CUDA
events, median of ``--reps`` launches after a warm-up, in two rounds
(variants in order, then again); one JSON object with every variant's
times is printed.  The variants that cut work give wrong counts on
purpose: they only locate the time.

    python -m kmcp_tpu_torch.tools.group_count_probe
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import shutil
import sys

import numpy as np
import torch

from ..kernels import _build
from ..search.device_step import FLOOR_NEVER
from ..search.group_count import gemm_slabs, n_tiles, s_pad_for
from ..search.pair_count import block_order
from .count_mask_ab import median_ms
from .count_mask_probe import apply_edit

VARIANTS = {
    "as_built": [],
    # pair tiles of 64 (one consumer warpgroup) in place of 128
    "pairs64": [("constexpr int PAIR_WARPGROUPS = 2;",
                 "constexpr int PAIR_WARPGROUPS = 1;")],
    # one target tile per CTA: the windows staged and sorted for each
    "one_target_tile_per_cta": [("  while (ntc < 8 && ntc < NT &&",
                                 "  while (false && ntc < 8 && ntc < NT &&")],
    # at most half as many target tiles per CTA (four CTAs per SM)
    "ntc_half": [(">= 2LL * dev.sms)", ">= 4LL * dev.sms)")],
    # no A fragments built from the windows (all zero)
    "no_a_build": [("    for (; e < z; ++e) {", "    for (; e < 0; ++e) {")],
    # no tensor-core products
    "no_mma": [("for (int k = 0; k < BK / 32; ++k)\n    wgmma_u8(",
                "for (int k = 0; k < 0; ++k)\n    wgmma_u8(")],
    # the windows staged and sorted, no k-steps at all
    "prologue_only": [("  for (int k = 0; k < BK / 32; ++k)\n    wgmma_u8(",
                       "  for (int k = 0; k < 0; ++k)\n    wgmma_u8("),
                      ("          for (int kt = 0; kt < nks; kt += 2) {",
                       "          for (int kt = 0; kt < 0; kt += 2) {"),
                      ("mbar_arrive(&empty[(it - 1) % STAGES]);\n        }",
                       "if (it) mbar_arrive(&empty[(it - 1) % STAGES]);\n"
                       "        }"),
                      ("          for (int kt = 0; kt < n_k; ++kt, ++it) {",
                       "          for (int kt = 0; kt < 0; ++kt, ++it) {")],
    # no windows bucketed (every A fragment zero; the k-steps still run)
    "no_prologue": [("const int nwin = nr * wc;", "const int nwin = 0 * nr * wc;")],
    # no count or mask stores
    "no_epilogue_stores": [
        ("        if (col < T) {\n          if (p0 >= 0)",
         "        if (col < 0) {\n          if (p0 >= 0)"),
        ("if ((w & 3) == q && word < W) {", "if ((w & 3) == q && word < 0) {")],
}
NB, P, B, S_BLOCK, W, K = 32, 20_480, 16_384, 3_578, 128, 140


def build(name: str, edits, root: str) -> ctypes.CDLL:
    d = os.path.join(root, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, d)
    for old, new in edits:
        apply_edit(d, ("group_count.cu",), old, new, name)
    so = os.path.join(d, "lib.so")
    _build.compile_library(sorted(glob.glob(os.path.join(d, "*.cu"))), so)
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kmcp_group_count.argtypes = [
        vp, i32, i32, i32, i32, i32, vp, i32, vp, vp, vp, i32, vp, vp, vp, vp,
        vp]
    lib.kmcp_group_count.restype = i32
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2025)
    bw = rng.integers(0, 2**32, (NB * S_BLOCK + 1, W), dtype=np.uint32)
    bw &= rng.integers(0, 2**32, bw.shape, dtype=np.uint32)
    bw[-1] = 0
    bits = torch.from_numpy(bw.view(np.int32)).to(dev)
    slabs = gemm_slabs(bits, NB, S_BLOCK, s_pad_for(S_BLOCK))
    loc_np = rng.integers(0, S_BLOCK, (B, K)).astype(np.int32)
    loc_np[rng.random((B, K)) < 0.05] = S_BLOCK
    flat = np.sort(rng.choice(B * NB, size=P, replace=False))
    t = {n: torch.from_numpy(a).to(dev) for n, a in (
        ("loc", loc_np), ("pb", (flat // NB).astype(np.int32)),
        ("pg", (flat % NB).astype(np.int32)),
        ("cthr", np.full(B, 72, dtype=np.int32)),
        ("thr", np.where(rng.random((NB, 32 * W)) < 0.01, FLOOR_NEVER,
                         rng.integers(1, 10, (NB, 32 * W))).astype(np.int32)))}
    order, seg = block_order(t["pg"], NB)
    T = 32 * W
    counts = torch.empty((P, T), dtype=torch.int32, device=dev)
    mask = torch.empty((P, W), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    NT, KT = slabs.shape[1], slabs.shape[2]
    root = os.path.join(_build.BUILD_DIR, "probe_k6")
    libs = {n: build(n, e, root) for n, e in VARIANTS.items()}

    def launch(name: str):
        lib = libs[name]
        outs = (t["cthr"].data_ptr(), t["thr"].data_ptr(), counts.data_ptr(),
                mask.data_ptr())
        tile = 64 if name == "pairs64" else 128
        rc = lib.kmcp_group_count(
            slabs.data_ptr(), NB, NT, KT, T, S_BLOCK, t["loc"].data_ptr(), K,
            t["pb"].data_ptr(), order.data_ptr(), seg.data_ptr(),
            n_tiles(P, NB, tile), *outs, stream)
        if rc:
            raise RuntimeError(f"{name}: cuda error {rc}")

    res: dict = {}
    # the other tile shape must count as the kernel as built does
    outs = []
    for name in ("as_built", "pairs64"):
        launch(name)
        outs.append((counts.clone(), mask.clone()))
    res["others_equal_as_built"] = all(
        torch.equal(a, b) for o in outs[1:] for a, b in zip(outs[0], o))
    del outs
    for _ in range(2):
        for name in libs:
            res.setdefault(name, []).append(
                median_ms(lambda name=name: launch(name), args.reps))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
