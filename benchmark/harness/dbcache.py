"""A configuration's DB, built once through the port's own command line and
kept in the checkout's benchmark cache.

Users build a DB once and search many samples against it, so a run that
finds the DB in the cache only opens it.  Each stage (genomes, k-mer files,
DB) is keyed by the parameters it depends on and built under
``<dir>.part``, renamed when complete: a build that was cut off is never
used.  Once the DB is complete its genomes and k-mer files go, so that
the cache holds only what later runs read.

The DB's layout follows the configuration: ``index --tpu-native`` blocks
of ``block_targets`` targets, and with ``"block_screen": true`` also
``--block-screen --uniform-sigs`` (a union screen a block and one row
count for every block: the layout of the two-pass screened search, which
the program serves only with both).  The key joins the DB's cache key
only where a configuration sets it true, so a configuration without it
keeps the key it had.

A build logs its wall time and its peak disk (the genomes, every k-mer
file and the DB, which ``index`` needs all at once) on standard error.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

from .genomes import write_genomes
from .manifest import ROOT

GENOME_KEYS = ("genomes", "genome_bp", "genome_seed")
COMPUTE_KEYS = GENOME_KEYS + ("k", "chunks_per_genome", "chunk_overlap_bp")
INDEX_KEYS = COMPUTE_KEYS + ("num_hashes", "fpr", "block_targets")
SCREEN_FLAGS = ["--block-screen", "--uniform-sigs"]


def _key(config: dict, keys) -> str:
    blob = json.dumps({k: config[k] for k in keys}, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def index_key(config: dict) -> str:
    """The DB's cache key: ``INDEX_KEYS``, and ``block_screen`` where it
    is true."""
    screened = ("block_screen",) if config.get("block_screen") else ()
    return _key(config, INDEX_KEYS + screened)


def _port(*args: str) -> None:
    """``python -m kmcp_tpu_torch -q <args>`` from the checkout; raises
    with its output if it fails."""
    res = subprocess.run([sys.executable, "-m", "kmcp_tpu_torch", "-q",
                          *args], cwd=ROOT, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"kmcp_tpu_torch {' '.join(args)} failed "
                           f"({res.returncode}):\n{res.stdout}{res.stderr}")


def _stage(path: str, build) -> None:
    """Build ``path`` with ``build(part_dir)`` unless it is complete."""
    if os.path.isdir(path):
        return
    part = path + ".part"
    shutil.rmtree(part, ignore_errors=True)
    build(part)
    os.rename(part, path)


def _bytes_under(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def index_args(config: dict) -> list[str]:
    return ["-n", str(config["num_hashes"]), "-f", str(config["fpr"]),
            "--tpu-native", "--native-block-targets",
            str(config["block_targets"])] + (
                SCREEN_FLAGS if config.get("block_screen") else [])


def ensure_db(config: dict, cache_dir: str) -> tuple[str, bool]:
    """(the DB directory, whether any stage was built by this call)."""
    os.makedirs(cache_dir, exist_ok=True)
    db = os.path.join(cache_dir, "db-" + index_key(config))
    if os.path.isdir(db):
        return db, False
    t0 = time.perf_counter()
    gdir = os.path.join(cache_dir, "genomes-" + _key(config, GENOME_KEYS))
    ks = os.path.join(cache_dir, "kmers-" + _key(config, COMPUTE_KEYS))
    _stage(gdir, lambda out: write_genomes(config, out))
    _stage(ks, lambda out: _port(
        "compute", "-I", gdir, "-O", out, "-k", str(config["k"]),
        "-n", str(config["chunks_per_genome"]),
        "-l", str(config["chunk_overlap_bp"]), "--force"))
    _stage(db, lambda out: _port(
        "index", "-I", ks, "-O", out, *index_args(config), "--force"))
    sizes = [_bytes_under(p) for p in (gdir, ks, db)]
    shutil.rmtree(ks)
    shutil.rmtree(gdir)
    print(f"[bench] DB build: {time.perf_counter() - t0:.1f} s wall, peak "
          f"disk {sum(sizes) / 1e9:.3f} GB (genomes {sizes[0] / 1e9:.3f}, "
          f"k-mer files {sizes[1] / 1e9:.3f}, DB {sizes[2] / 1e9:.3f}); "
          f"index {' '.join(index_args(config))}", file=sys.stderr,
          flush=True)
    return db, True
