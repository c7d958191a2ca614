"""The streaming search of an earlier checkout against this one's, end to
end on one card, in one call.

Builds chip_smoke.py's wide DB (131,072 targets, one block), its 65,536
reads and read pairs and its minimizer DB (16,384 targets) under .smoke/
with the smoke's own builders, then runs ``run_search`` on three cells,
wide-131k (single-end reads), paired-131k (the pairs, on the wide DB) and
sketch-minimizer-16k (the reads), in turns: earlier, this, this, earlier.
Each turn is a fresh process on the card, importing the ``kmcp_tpu_torch``
of the earlier checkout (``--parent``, a directory that holds that
package) or of this one.  It searches each cell once untimed (the kernels
build, the caches fill), then ``--reps`` times timed: the wall of
``run_search``, DB open included, as chip_smoke.py phase 12 reads it.
This checkout runs at its default depth (4 batches in flight) and at
depth 1.  Every TSV of a cell must be byte-identical to every other.
Prints one JSON line per turn and a summary line, and writes them all to
``--out`` when given.  ``--reuse`` takes the DBs and reads a finished
``python3 chip_smoke.py`` left under .smoke/ instead of building them.

    python -m kmcp_tpu_torch.tools.stream_ab --parent DIR [--reps 3] [--reuse]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# one turn: every cell at every depth, in a process of the checkout at
# sys.argv[1]
TURN = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
from kmcp_tpu_torch.commands.search import run_search
cfg = json.loads(sys.argv[2])
out = {}
for cell in cfg["cells"]:
    for depth in cfg["depths"]:
        kw = dict(cell["query"], device="cuda", verbose=False)
        if depth is not None:
            kw["in_flight"] = depth
        path = cell["out"] + f".{cfg['tag']}.d{depth}.tsv"
        run_search(cell["db"], out_file=path, **kw)
        walls = []
        for _ in range(cfg["reps"]):
            t0 = time.time()
            run_search(cell["db"], out_file=path, **kw)
            walls.append(time.time() - t0)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        out[f"{cell['name']} d{depth}"] = {"walls": walls, "sha256": digest}
print(json.dumps(out))
"""


def build_cells(reuse: bool) -> list[dict]:
    """The three cells' DBs and queries, built as chip_smoke.py builds
    them, or with ``reuse`` those it left."""
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    wide_db = os.path.join(smoke.SCRATCH, "wide", "db")
    reads = os.path.join(smoke.SCRATCH, "wide.reads.fq")
    r1 = os.path.join(smoke.SCRATCH, "pairs.r1.fq")
    r2 = os.path.join(smoke.SCRATCH, "pairs.r2.fq")
    sketch = os.path.join(smoke.SCRATCH, "sketch", "minimizer", "db")
    if reuse:
        missing = [p for p in (wide_db, reads, r1, r2, sketch)
                   if not os.path.exists(p)]
        if missing:
            raise SystemExit(f"--reuse: no {missing} (run chip_smoke.py)")
    else:
        os.makedirs(smoke.SCRATCH, exist_ok=True)
        t0 = time.time()
        wide_db, genomes = smoke.build_db("wide", smoke.WIDE_GENOMES,
                                          smoke.WIDE_CHUNKS, 1000, 1, 42)
        _n, pool = smoke.write_reads(reads, genomes, 7)
        smoke.write_pairs(r1, r2, genomes, 7, smoke.WIDE_CHUNKS)
        del genomes
        gdir = smoke.sketch_genomes(os.path.join(smoke.SCRATCH, "wide",
                                                 "genomes"), pool)
        sketch = smoke.sketch_db("minimizer", gdir)
        print(f"[ab] DBs and reads built in {time.time() - t0:.1f} s",
              file=sys.stderr, flush=True)
    out = os.path.join(smoke.SCRATCH, "ab")
    return [
        {"name": "wide-131k", "db": wide_db, "query": {"files": [reads]},
         "out": out + ".wide"},
        {"name": "paired-131k", "db": wide_db,
         "query": {"read1": r1, "read2": r2}, "out": out + ".paired"},
        {"name": "sketch-minimizer-16k", "db": sketch,
         "query": {"files": [reads]}, "out": out + ".sketch"},
    ]


def run_turn(root: str, tag: str, depths: list, cells: list,
             reps: int) -> dict:
    cfg = {"cells": cells, "depths": depths, "reps": reps, "tag": tag}
    t0 = time.time()
    res = subprocess.run([sys.executable, "-c", TURN, root, json.dumps(cfg)],
                         cwd=root, capture_output=True, text=True,
                         timeout=900)
    if res.returncode:
        sys.stderr.write(res.stderr[-4000:])
        raise RuntimeError(f"the {tag} turn failed ({res.returncode})")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"[ab] {tag} turn: {time.time() - t0:.1f} s", file=sys.stderr,
          flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a directory holding the earlier kmcp_tpu_torch")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--reuse", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    parent = os.path.abspath(args.parent)
    if not os.path.isdir(os.path.join(parent, "kmcp_tpu_torch")):
        raise SystemExit(f"no kmcp_tpu_torch under {parent}")
    cells = build_cells(args.reuse)
    turns = []
    for i, which in enumerate(("parent", "this", "this", "parent")):
        root, depths = ((parent, [None]) if which == "parent"
                        else (ROOT, [4, 1]))
        row = {"turn": i + 1, "checkout": which, "card": smi,
               "walls": run_turn(root, f"{which}{i}", depths, cells,
                                 args.reps)}
        turns.append(row)
        print(json.dumps(row), flush=True)
    summary = {"card": smi, "median_s": {}}
    for cell in cells:
        digests = {w["sha256"] for t in turns
                   for k, w in t["walls"].items()
                   if k.startswith(cell["name"] + " ")}
        if len(digests) != 1:
            raise AssertionError(f"{cell['name']}: the TSVs differ")
        for label, depth in (("parent", "dNone"), ("this d4", "d4"),
                             ("this d1", "d1")):
            walls = sorted(w for t in turns for k, v in t["walls"].items()
                           if k == f"{cell['name']} {depth}"
                           for w in v["walls"])
            summary["median_s"][f"{cell['name']} {label}"] = (
                walls[len(walls) // 2])
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"turns": turns, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
