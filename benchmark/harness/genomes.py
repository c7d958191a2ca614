"""A configuration's synthetic reference genomes and how ``compute`` cuts
them into chunk targets.

The genomes come from the configuration's own fixed ``genome_seed``, so the
DB, the reads and the plain reference all see the same bases.  The chunk
arithmetic is KMCP's split-by-number rule (``compute -n N -l L``): chunk
size ``ceil((len + (N-1) L) / N)``, step ``size - L``, windows from 0 by
``step``, the last one cut at the genome's end, chunks of ``L + 1`` or fewer
bases dropped.
"""

from __future__ import annotations

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def genome_codes(config: dict) -> np.ndarray:
    """[genomes, genome_bp] uint8 base codes (A=0 C=1 G=2 T=3)."""
    rng = np.random.default_rng(config["genome_seed"])
    return rng.integers(0, 4, size=(config["genomes"], config["genome_bp"]),
                        dtype=np.uint8)


def genome_name(g: int) -> str:
    return f"g{g:05d}"


def write_genomes(config: dict, out_dir: str) -> None:
    """One FASTA file a genome, ``g<index>.fa`` holding ``>g<index>``."""
    codes = genome_codes(config)
    os.makedirs(out_dir, exist_ok=True)
    for g in range(codes.shape[0]):
        name = genome_name(g)
        with open(os.path.join(out_dir, f"{name}.fa"), "wb") as f:
            f.write(b">" + name.encode() + b"\n" + ACGT[codes[g]].tobytes()
                    + b"\n")


def chunk_bounds(config: dict) -> list[tuple[int, int]]:
    """[(start, end)] of each chunk target of one genome, in chunk order."""
    length = config["genome_bp"]
    n, overlap = config["chunks_per_genome"], config["chunk_overlap_bp"]
    size = (length + (n - 1) * overlap + n - 1) // n
    step = size - overlap
    out, start = [], 0
    while start < length:
        end = min(start + size, length)
        if not (end - start - 1 <= overlap or end - start < config["k"]):
            out.append((start, end))
        if end == length:
            break
        start += step
    return out
