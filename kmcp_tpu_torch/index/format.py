"""On-disk database format: bit-sliced Bloom signature index.

The port's copy of kmcp_tpu/index/format.py.  Each block stores one
dense uint32 bit matrix ``[num_sigs, num_words]`` (target t -> word t//32,
bit t%32, LSB-first) as a raw ``.npy``, per-block metadata (names, genome
sizes, packed chunk indices, per-target k-mer counts) in a JSON sidecar,
an optional k-mer-union screen per block (``.union.npz``) and DB-level
parameters in ``db.json``.  Both packages read and write the same bytes.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field

import numpy as np

from .. import DB_VERSION

DB_INFO_FILE = "db.json"
NAME_MAPPING_FILE = "name_mapping.tsv"


@dataclass
class BlockMeta:
    names: list[str]
    gsizes: list[int]           # genome size per target
    indices: list[int]          # packed: low16 chunkIdx, high16 #chunks
    sizes: list[int]            # distinct k-mer count per target
    num_sigs: int
    num_targets: int

    @property
    def num_words(self) -> int:
        return (self.num_targets + 31) // 32


@dataclass
class DBInfo:
    version: int = DB_VERSION
    alias: str = ""
    ks: list[int] = field(default_factory=list)
    canonical: bool = True
    hashed: bool = True
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
    num_hashes: int = 1
    fpr: float = 0.3
    num_names: int = 0
    block_size: int = 0
    total_kmers: int = 0
    blocks: list[str] = field(default_factory=list)

    def to_json(self) -> dict:
        return dict(self.__dict__)

    @classmethod
    def from_json(cls, d: dict) -> "DBInfo":
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        return cls(**known)


def block_paths(db_dir: str, block_id: int) -> tuple[str, str]:
    base = os.path.join(db_dir, f"block_{block_id:03d}")
    return base + ".bits.npy", base + ".meta.json"


def write_block(
    db_dir: str, block_id: int, bits: np.ndarray, meta: BlockMeta
) -> str:
    bits_path, meta_path = block_paths(db_dir, block_id)
    assert bits.dtype == np.uint32 and bits.ndim == 2
    assert bits.shape == (meta.num_sigs, meta.num_words)
    np.save(bits_path, bits)
    with open(meta_path, "w") as f:
        json.dump(
            {
                "names": meta.names,
                "gsizes": meta.gsizes,
                "indices": meta.indices,
                "sizes": meta.sizes,
                "num_sigs": meta.num_sigs,
                "num_targets": meta.num_targets,
            },
            f,
        )
    return os.path.basename(bits_path)


def read_block_meta(db_dir: str, block_id: int) -> BlockMeta:
    _, meta_path = block_paths(db_dir, block_id)
    with open(meta_path) as f:
        d = json.load(f)
    return BlockMeta(**d)


def read_block_bits(db_dir: str, block_id: int, mmap: bool = True) -> np.ndarray:
    bits_path, _ = block_paths(db_dir, block_id)
    return np.load(bits_path, mmap_mode="r" if mmap else None)


class BlockRowReader:
    """Row-seek access to a block's on-disk bit matrix, the ``--low-mem``
    mode of the host backend (the reference's Seek+ReadFull per Bloom row
    instead of mmap, util-db-search.go:6975-7176): only the rows a batch
    gathers are read, by pread, so memory stays O(batch), not O(index).
    Runs of adjacent rows coalesce into one read; ``bytes_read`` counts
    what was read."""

    def __init__(self, db_dir: str, block_id: int):
        path = block_paths(db_dir, block_id)[0]
        self.f = open(path, "rb", buffering=0)
        if self.f.read(6) != b"\x93NUMPY":
            raise ValueError(f"not a .npy file: {path}")
        major = self.f.read(2)[0]
        n = 2 if major == 1 else 4
        hlen = int.from_bytes(self.f.read(n), "little")
        header = ast.literal_eval(self.f.read(hlen).decode("latin1"))
        if header["descr"] not in ("<u4", "|u4") or header["fortran_order"]:
            raise ValueError(f"unexpected block layout in {path}")
        self.shape = header["shape"]
        self.offset = 6 + 2 + n + hlen
        self.row_bytes = self.shape[1] * 4
        self.bytes_read = 0

    def gather(self, rows: np.ndarray) -> np.ndarray:
        """rows: sorted unique row indices -> [len(rows), W] uint32."""
        nw = self.shape[1]
        out = np.empty((len(rows), nw), dtype=np.uint32)
        if len(rows) == 0:
            return out
        fd = self.f.fileno()
        rb = self.row_bytes
        rows = np.asarray(rows, dtype=np.int64)
        breaks = np.flatnonzero(np.diff(rows) != 1) + 1
        starts = np.concatenate(([0], breaks))
        ends = np.concatenate((breaks, [len(rows)]))
        for s, e in zip(starts, ends):
            nbytes = (e - s) * rb
            buf = os.pread(fd, nbytes, self.offset + int(rows[s]) * rb)
            if len(buf) != nbytes:
                raise OSError("short read from block file")
            out[s:e] = np.frombuffer(buf, np.uint32).reshape(e - s, nw)
            self.bytes_read += nbytes
        return out

    def close(self):
        self.f.close()


def union_path(db_dir: str, block_id: int) -> str:
    return os.path.join(db_dir, f"block_{block_id:03d}.union.npz")


def write_block_union(
    db_dir: str, block_id: int, words: np.ndarray, num_bits: int,
    fpr: float,
) -> None:
    """Per-block k-mer-union Bloom bitset: the large-T block screen."""
    np.savez(
        union_path(db_dir, block_id), words=words,
        num_bits=np.int64(num_bits), fpr=np.float64(fpr),
    )


def read_block_union(db_dir: str, block_id: int):
    """(words, num_bits, fpr) or None when the block has no screen."""
    path = union_path(db_dir, block_id)
    if not os.path.isfile(path):
        return None
    with np.load(path) as z:
        return z["words"], int(z["num_bits"]), float(z["fpr"])


def read_block_union_header(db_dir: str, block_id: int):
    """(num_bits, fpr) or None — the union's scalars without loading
    the word array; npz members load lazily."""
    path = union_path(db_dir, block_id)
    if not os.path.isfile(path):
        return None
    with np.load(path) as z:
        return int(z["num_bits"]), float(z["fpr"])


def write_db_info(db_dir: str, info: DBInfo) -> None:
    with open(os.path.join(db_dir, DB_INFO_FILE), "w") as f:
        json.dump(info.to_json(), f, indent=1)


def read_db_info(db_dir: str) -> DBInfo:
    with open(os.path.join(db_dir, DB_INFO_FILE)) as f:
        info = DBInfo.from_json(json.load(f))
    if info.version != DB_VERSION:
        raise ValueError(
            f"kmcp-tpu db version mismatch: {info.version} != {DB_VERSION}"
        )
    return info


def write_name_mapping(db_dir: str, names: list[str]) -> None:
    with open(os.path.join(db_dir, NAME_MAPPING_FILE), "w") as f:
        for n in names:
            f.write(f"{n}\t{n}\n")


def is_db_dir(path: str) -> bool:
    return os.path.isfile(
        os.path.join(path, DB_INFO_FILE)
    ) or os.path.isfile(os.path.join(path, "__db.yml"))


def find_db_dirs(path: str) -> list[str]:
    """A search target may be a DB dir itself or a parent holding several
    (one level of subdirectories is scanned).  Reference-layout databases
    (``__db.yml``) are recognized alongside ``db.json`` dirs."""
    if is_db_dir(path):
        return [path]
    if not os.path.isdir(path):
        raise SystemExit(f"kmcp-tpu-torch: database directory not found: {path}")
    out = []
    for name in sorted(os.listdir(path)):
        sub = os.path.join(path, name)
        if os.path.isdir(sub) and is_db_dir(sub):
            out.append(sub)
    return out
