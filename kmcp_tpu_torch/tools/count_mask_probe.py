"""Where K2''s wide launch spends its time: variants of csrc/count_mask.cu
with one part changed or cut out, each built and timed at the wide shape.

Each variant copies ``kmcp_tpu_torch/csrc`` to a directory under
``kmcp_tpu_torch/build/probe/``, applies its text edits (a missing anchor
fails the run), builds with the package's nvcc flags and times the entry
point on the same inputs: the dense tail's 2,048-read chunk of 131,072
targets, 3,579 rows, h = 1, K = 140.  Times are CUDA events, median of
``--reps`` launches after a warm-up, in two rounds (variants in order, then
again); one JSON object with every variant's two times is printed.  The
variants that cut work (no count loop, no count stores) give wrong counts
on purpose: they only locate the time.  ``fill_counts_ms`` is a torch fill
of the same counts tensor, the store floor.

    python -m kmcp_tpu_torch.tools.count_mask_probe
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build
from .count_mask_ab import median_ms

STORE = """            reinterpret_cast<int4*>(
                counts + ((size_t)(b0 + r) * W + w0) * 32)[q] = v;"""
NO_LOOP = [("for (; i + 8 <= kc; i += 8) {", "for (; i + 8 <= 0; i += 8) {"),
           ("for (; i < kc; ++i) {", "for (; i < 0; ++i) {")]
VARIANTS = {
    "as_built": [],
    # 32-window location chunks at h = 1 too
    "kc32": [("return h == 1 ? 64 : 32;", "return 32;")],
    # two CTAs per tile (each copies the tile's rows)
    "two_ctas_per_tile": [("(dev.sms + tiles - 1) / tiles",
                           "(4 * dev.sms + tiles - 1) / tiles")],
    # the tile copied word by word instead of by cp.async
    "sync_slice_copy": [("const bool async = nw == WT",
                         "const bool async = false && nw == WT")],
    "no_count_loop": NO_LOOP,
    "no_count_stores": [(STORE, "            if (x == 0xdeadbeefu) "
                         + STORE.strip())],
}
S, W, H, B, K = 3578, 4096, 1, 2048, 140


def build(name: str, edits, root: str) -> ctypes.CDLL:
    d = os.path.join(root, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, d)
    for old, new in edits:
        path = os.path.join(d, "count_mask.cu")
        with open(path) as f:
            src = f.read()
        if old not in src:
            raise SystemExit(f"variant {name}: anchor not found: {old!r}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    so = os.path.join(d, "lib.so")
    res = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
         *sorted(glob.glob(os.path.join(d, "*.cu")))],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc of variant {name} failed:\n{res.stderr}")
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kmcp_count_mask.argtypes = [vp, i32, i32, vp, i32, i32, i32, vp, vp,
                                    vp, vp, vp]
    lib.kmcp_count_mask.restype = i32
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    bits = (rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
            & rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32))
    bits[-1] = 0
    loc = rng.integers(0, S, (B, K, H)).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (
        bits.view(np.int32), loc, rng.integers(30, 60, B).astype(np.int32),
        rng.integers(1, 10, 32 * W).astype(np.int32))]
    counts = torch.empty((B, 32 * W), dtype=torch.int32, device=dev)
    mask = torch.empty((B, W), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    root = os.path.join(_build.BUILD_DIR, "probe")
    libs = {n: build(n, e, root) for n, e in VARIANTS.items()}
    res: dict = {}
    for _ in range(2):
        for name, lib in libs.items():
            def run(lib=lib):
                rc = lib.kmcp_count_mask(
                    t[0].data_ptr(), W, S + 1, t[1].data_ptr(), B, K, H,
                    t[2].data_ptr(), t[3].data_ptr(), counts.data_ptr(),
                    mask.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"{name}: cuda error {rc}")
            res.setdefault(name, []).append(median_ms(run, args.reps))
    res["fill_counts_ms"] = median_ms(lambda: counts.fill_(1), args.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
