""".kset — k-mer hash-set interchange format (compute -> index).

The port's copy of kmcp_tpu/kmer/kset.py (less ``read_kset_header``).  One
file per genome chunk: a tiny JSON header plus the sorted, deduplicated
uint64 hash array stored raw little-endian for mmap-friendly loading.

Layout:
    bytes 0-7    magic  b"KTPKSET1"
    bytes 8-11   uint32 LE header JSON length
    header JSON  {"ks", "canonical", "scaled", "scale", "minimizer",
                  "minimizer_w", "syncmer", "syncmer_s", "split_seq",
                  "split_num", "split_size", "split_overlap",
                  "seq_id", "frag_idx", "genome_size", "n"}
    payload      n * uint64 LE (sorted unique hashes)

A sidecar summary ``_info.tsv`` per output directory lists
(path, name, chunk_idx, chunks, kmers, genome_size).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

MAGIC = b"KTPKSET1"
INFO_FILE = "_info.tsv"


@dataclass
class KsetMeta:
    ks: list[int]
    canonical: bool = True
    scaled: bool = False
    scale: int = 1
    minimizer: bool = False
    minimizer_w: int = 0
    syncmer: bool = False
    syncmer_s: int = 0
    split_seq: bool = False
    split_num: int = 1
    split_size: int = 0
    split_overlap: int = 0
    seq_id: str = ""
    frag_idx: int = 0
    genome_size: int = 0
    extra: dict = field(default_factory=dict)


def write_kset(path: str, hashes: np.ndarray, meta: KsetMeta) -> None:
    header = {
        "ks": meta.ks,
        "canonical": meta.canonical,
        "scaled": meta.scaled,
        "scale": meta.scale,
        "minimizer": meta.minimizer,
        "minimizer_w": meta.minimizer_w,
        "syncmer": meta.syncmer,
        "syncmer_s": meta.syncmer_s,
        "split_seq": meta.split_seq,
        "split_num": meta.split_num,
        "split_size": meta.split_size,
        "split_overlap": meta.split_overlap,
        "seq_id": meta.seq_id,
        "frag_idx": meta.frag_idx,
        "genome_size": meta.genome_size,
        "n": int(len(hashes)),
    }
    hb = json.dumps(header, separators=(",", ":")).encode()
    arr = np.ascontiguousarray(hashes, dtype="<u8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint32(len(hb)).tobytes())
        f.write(hb)
        f.write(arr.tobytes())
    os.replace(tmp, path)


def read_kset(path: str, mmap: bool = True) -> tuple[np.ndarray, KsetMeta]:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError(f"not a .kset file: {path}")
        (hlen,) = np.frombuffer(f.read(4), dtype="<u4")
        header = json.loads(f.read(int(hlen)))
        offset = f.tell()
    n = header.pop("n")
    meta = KsetMeta(**{k: v for k, v in header.items() if k in KsetMeta.__dataclass_fields__})
    if mmap:
        arr = np.memmap(path, dtype="<u8", mode="r", offset=offset, shape=(n,))
    else:
        with open(path, "rb") as f:
            f.seek(offset)
            arr = np.frombuffer(f.read(n * 8), dtype="<u8")
    return arr, meta


@dataclass
class KsetFileInfo:
    """One row of _info.tsv."""

    path: str
    name: str
    index: int       # chunk index within the genome
    indexes: int     # total number of chunks of the genome
    kmers: int
    genome_size: int


def write_info(dir_path: str, infos: list[KsetFileInfo]) -> None:
    with open(os.path.join(dir_path, INFO_FILE), "w") as f:
        f.write("#path\tname\tchunkIdx\tchunks\tkmers\tgenomeSize\n")
        for i in infos:
            rel = os.path.relpath(i.path, dir_path)
            f.write(f"{rel}\t{i.name}\t{i.index}\t{i.indexes}\t{i.kmers}\t{i.genome_size}\n")


def read_info(dir_path: str) -> list[KsetFileInfo]:
    path = os.path.join(dir_path, INFO_FILE)
    if not os.path.isfile(path):
        raise SystemExit(
            f"kmcp-tpu-torch: no {INFO_FILE} in {dir_path} — run "
            "'kmcp-tpu-torch compute' first"
        )
    infos: list[KsetFileInfo] = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            p, name, idx, idxs, kmers, gsize = line.rstrip("\n").split("\t")
            infos.append(
                KsetFileInfo(
                    path=os.path.join(dir_path, p),
                    name=name,
                    index=int(idx),
                    indexes=int(idxs),
                    kmers=int(kmers),
                    genome_size=int(gsize),
                )
            )
    return infos
