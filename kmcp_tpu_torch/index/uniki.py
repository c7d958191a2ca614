"""Reference-format interop: the ``.uniki`` block index and ``__db.yml``
DB metadata of shenwei356/kmcp.

The port's copy of kmcp_tpu/index/uniki.py.  Byte layout, from the
reference's sources:

- ``.uniki``: kmcp/cmd/index/serialization.go:32-348 (magic ``.kmcpidx``,
  version 4, big-endian header; body = numSigs rows x (numGroups+7)/8
  bytes, file k of an 8-file group occupying bit ``7 - k`` of its byte —
  index.go:1144-1158, :1283-1319)
- ``__db.yml``: kmcp/cmd/util-db-info.go:36-120 (flat YAML, blocks under an
  ``R001`` subdirectory, index.go:637,1377)

A reference-built database loads straight into the search engine (bit
columns transposed to the port's word layout on load), and the port's
databases export to the reference layout (``export_ref_layout``).
"""

from __future__ import annotations

import io
import os
import struct
from dataclasses import dataclass

import numpy as np

from .format import BlockMeta, DBInfo

MAGIC = b".kmcpidx"
UNIKI_VERSION = 4
FLAG_CANONICAL = 1
FLAG_COMPACT = 2
DB_YML = "__db.yml"
NAME_MAPPING_TSV = "__name_mapping.tsv"

# bit-reversal LUT: reference bytes are MSB-first (file k -> bit 7-k),
# our uint32 words are LSB-first (target t -> bit t%32)
_REV = np.array(
    [int(f"{b:08b}"[::-1], 2) for b in range(256)], dtype=np.uint8
)


@dataclass
class UnikiHeader:
    version: int
    k: int
    canonical: bool
    compact: bool
    num_hashes: int
    num_sigs: int
    names: list[list[str]]
    gsizes: list[list[int]]
    indices: list[list[int]]
    sizes: list[int]

    @property
    def num_row_bytes(self) -> int:
        return (len(self.names) + 7) // 8


def write_uniki(
    path: str, header: UnikiHeader, row_bytes: np.ndarray
) -> None:
    """row_bytes: [num_sigs, num_row_bytes] uint8 in reference bit order."""
    h = header
    assert row_bytes.shape == (h.num_sigs, h.num_row_bytes)
    buf = io.BytesIO()
    buf.write(MAGIC)
    flag = (FLAG_CANONICAL if h.canonical else 0) | (
        FLAG_COMPACT if h.compact else 0
    )
    buf.write(struct.pack(">4B", h.version, h.k, flag, h.num_hashes))
    buf.write(struct.pack(">Q", h.num_sigs))
    # names: group count, then per group byte-length + newline-joined
    buf.write(struct.pack(">I", len(h.names)))
    for group in h.names:
        joined = b"".join(n.encode() + b"\n" for n in group)
        buf.write(struct.pack(">I", len(joined)))
        buf.write(joined)
    # gsizes
    buf.write(struct.pack(">I", len(h.gsizes)))
    for group in h.gsizes:
        buf.write(struct.pack(">I", len(group)))
        buf.write(np.asarray(group, dtype=">u8").tobytes())
    # indices (packed low16 chunkIdx, high16 #chunks)
    buf.write(struct.pack(">I", len(h.indices)))
    for group in h.indices:
        buf.write(struct.pack(">I", len(group)))
        buf.write(np.asarray(group, dtype=">u4").tobytes())
    # sizes: one u64 per group
    buf.write(np.asarray(h.sizes, dtype=">u8").tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())
        f.write(np.ascontiguousarray(row_bytes).tobytes())


def read_uniki(path: str, mmap: bool = True):
    """-> (UnikiHeader, row_bytes [num_sigs, num_row_bytes] uint8)."""
    f = open(path, "rb")
    try:
        if f.read(8) != MAGIC:
            raise ValueError(f"not a kmcp .uniki file: {path}")
        version, k, flag, num_hashes = struct.unpack(">4B", f.read(4))
        if version != UNIKI_VERSION:
            raise ValueError(
                f"kmcp index version mismatch: {version} != {UNIKI_VERSION}"
            )
        (num_sigs,) = struct.unpack(">Q", f.read(8))
        (n_groups,) = struct.unpack(">I", f.read(4))
        names = []
        for _ in range(n_groups):
            (nb,) = struct.unpack(">I", f.read(4))
            names.append(f.read(nb).decode().split("\n")[:-1])
        (ng,) = struct.unpack(">I", f.read(4))
        gsizes = []
        for _ in range(ng):
            (n,) = struct.unpack(">I", f.read(4))
            gsizes.append(
                np.frombuffer(f.read(8 * n), dtype=">u8").astype(np.int64).tolist()
            )
        (ni,) = struct.unpack(">I", f.read(4))
        indices = []
        for _ in range(ni):
            (n,) = struct.unpack(">I", f.read(4))
            indices.append(
                np.frombuffer(f.read(4 * n), dtype=">u4").astype(np.int64).tolist()
            )
        sizes = (
            np.frombuffer(f.read(8 * n_groups), dtype=">u8")
            .astype(np.int64)
            .tolist()
        )
        header = UnikiHeader(
            version=version, k=k,
            canonical=bool(flag & FLAG_CANONICAL),
            compact=bool(flag & FLAG_COMPACT),
            num_hashes=num_hashes, num_sigs=num_sigs,
            names=names, gsizes=gsizes, indices=indices, sizes=sizes,
        )
        offset = f.tell()
        rb = header.num_row_bytes
        if mmap:
            body = np.memmap(
                path, dtype=np.uint8, mode="r", offset=offset,
                shape=(num_sigs, rb),
            )
        else:
            body = np.fromfile(f, dtype=np.uint8, count=num_sigs * rb)
            body = body.reshape(num_sigs, rb)
        return header, body
    finally:
        f.close()


# ---------------------------------------------------------------- bit layout


def ref_bytes_to_words(row_bytes: np.ndarray) -> np.ndarray:
    """[S, RB] uint8 MSB-first byte columns -> [S, W] uint32 LSB-first
    words (our layout; target t -> word t//32, bit t%32)."""
    rev = _REV[row_bytes]
    pad = (-rev.shape[1]) % 4
    if pad:
        rev = np.pad(rev, ((0, 0), (0, pad)))
    return np.ascontiguousarray(rev).view("<u4")


def words_to_ref_bytes(bits: np.ndarray, num_targets: int) -> np.ndarray:
    """[S, W] uint32 LSB-first -> [S, (T+7)//8] uint8 MSB-first."""
    by = np.ascontiguousarray(bits).view("<u4").view(np.uint8)
    by = by.reshape(bits.shape[0], -1)
    rb = (num_targets + 7) // 8
    return _REV[by[:, :rb]]


# ---------------------------------------------------------------- __db.yml


def write_db_yml(path: str, fields: dict) -> None:
    """Flat YAML writer for the reference's field set (go-yaml block
    style for lists)."""
    with open(path, "w") as f:
        for key, val in fields.items():
            if isinstance(val, bool):
                f.write(f"{key}: {str(val).lower()}\n")
            elif isinstance(val, (int, float, str)):
                f.write(f"{key}: {val}\n")
            elif isinstance(val, list):
                if not val:
                    f.write(f"{key}: []\n")
                else:
                    f.write(f"{key}:\n")
                    for item in val:
                        f.write(f"- {item}\n")
            else:
                raise TypeError(f"unsupported yaml value for {key}: {val!r}")


def read_db_yml(path: str) -> dict:
    """Minimal YAML subset parser: flat ``key: value`` scalars plus block
    lists — exactly what go-yaml emits for UnikIndexDBInfo
    (util-db-info.go:46-79)."""
    out: dict = {}
    cur_list = None
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line or line.lstrip().startswith("#"):
                continue
            if line.startswith("- ") or line.startswith("  - "):
                if cur_list is None:
                    raise ValueError(f"stray list item in {path}: {line}")
                cur_list.append(_yaml_scalar(line.split("- ", 1)[1]))
                continue
            key, _, val = line.partition(":")
            key = key.strip()
            val = val.strip()
            if val == "" or val == "|":
                cur_list = []
                out[key] = cur_list
            elif val == "[]":
                out[key] = []
                cur_list = None
            else:
                out[key] = _yaml_scalar(val)
                cur_list = None
    return out


def _yaml_scalar(s: str):
    s = s.strip()
    if s.startswith('"') and s.endswith('"') and len(s) >= 2:
        return s[1:-1]
    if s == "true":
        return True
    if s == "false":
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


# ---------------------------------------------------------------- DB-level


def find_ref_dirs(path: str) -> list[str]:
    """Reference DB detection: the dir itself holds __db.yml, or its
    R%03d subdirectories do (search.go:299-324; index.go:637)."""
    if os.path.isfile(os.path.join(path, DB_YML)):
        return [path]
    out = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            sub = os.path.join(path, name)
            if os.path.isdir(sub) and os.path.isfile(
                os.path.join(sub, DB_YML)
            ):
                out.append(sub)
    return out


def load_ref_db(rdir: str, meta_only: bool = False):
    """Load one reference R-dir -> (DBInfo, [(BlockMeta, bits_u32), ...])
    (bits None with ``meta_only``).

    Per-target metadata flattens the reference's name groups; padding
    targets (bits beyond the real targets of the last byte) get empty
    names/zero sizes, matching our block loader's conventions."""
    y = read_db_yml(os.path.join(rdir, DB_YML))
    if y.get("version") != 4:
        raise SystemExit(
            f"unsupported reference DB version: {y.get('version')}"
        )
    ks = y.get("ks") or [y.get("k")]
    info = DBInfo(
        alias=str(y.get("alias", "")),
        ks=[int(k) for k in ks],
        canonical=bool(y.get("canonical", True)),
        hashed=bool(y.get("hashed", True)),
        scaled=bool(y.get("scaled", False)),
        scale=int(y.get("scale", 1) or 1),
        minimizer=bool(y.get("minimizer", False)),
        minimizer_w=int(y.get("minimizer-w", 0) or 0),
        syncmer=bool(y.get("syncmer", False)),
        syncmer_s=int(y.get("syncmer-s", 0) or 0),
        split_seq=bool(y.get("split-seq", False)),
        split_num=int(y.get("split-num", 1) or 1),
        split_size=int(y.get("split-size", 0) or 0),
        split_overlap=int(y.get("split-overlap", 0) or 0),
        num_hashes=int(y.get("hashes", 1)),
        fpr=float(y.get("fpr", 0.3)),
        num_names=int(y.get("numNameGroups", 0) or 0),
        block_size=int(y.get("blocksize", 0) or 0),
        total_kmers=int(y.get("totalKmers", 0) or 0),
        blocks=[str(b) for b in y.get("files", [])],
    )
    blocks = []
    block_ks: set[int] = set()
    for fname in info.blocks:
        header, row_bytes = read_uniki(os.path.join(rdir, fname))
        block_ks.add(header.k)
        if meta_only:
            bits = None
        else:
            bits = ref_bytes_to_words(np.asarray(row_bytes))
        names: list[str] = []
        gsizes: list[int] = []
        indices: list[int] = []
        sizes: list[int] = []
        for gi, group in enumerate(header.names):
            # one column per name group; multi-name groups (RAMBO mode,
            # hard-disabled in the reference, index.go:262-279) keep the
            # first name
            names.append(group[0] if group else "")
            gs = header.gsizes[gi] if gi < len(header.gsizes) else [0]
            gsizes.append(int(gs[0]) if gs else 0)
            ix = header.indices[gi] if gi < len(header.indices) else [0]
            indices.append(int(ix[0]) if ix else 0)
            sizes.append(int(header.sizes[gi]))
        meta = BlockMeta(
            names=names, gsizes=gsizes, indices=indices, sizes=sizes,
            num_sigs=header.num_sigs, num_targets=len(header.names),
        )
        blocks.append((meta, bits))
    if block_ks:
        if len(block_ks) > 1:
            raise SystemExit(
                f"reference DB {rdir} mixes k sizes {sorted(block_ks)} in "
                "one R-dir"
            )
        # the R-dir's blocks carry exactly one k even when __db.yml lists
        # the full multi-k set (each k lives in its own R-dir,
        # index.go:637); search this R-dir with its own k only
        info.ks = sorted(block_ks)
    return info, blocks


def export_ref_layout(db_dir: str, out_dir: str, alias: str = "") -> str:
    """Write one of our DBs as a reference-layout database
    (out_dir/R001/{__db.yml, __name_mapping.tsv, _blockNNN.uniki});
    returns the R-dir path."""
    from .format import read_block_bits, read_block_meta, read_db_info

    info = read_db_info(db_dir)
    if len(info.ks) != 1:
        raise SystemExit(
            "export-ref-db: multi-k DBs export one k per R-dir; "
            "rebuild per k"
        )
    rdir = os.path.join(out_dir, "R001")
    os.makedirs(rdir, exist_ok=True)
    files = []
    all_names = []
    for b in range(len(info.blocks)):
        meta = read_block_meta(db_dir, b)
        bits = np.asarray(read_block_bits(db_dir, b))
        nt = meta.num_targets
        header = UnikiHeader(
            version=UNIKI_VERSION, k=info.ks[0],
            canonical=info.canonical, compact=True,
            num_hashes=info.num_hashes, num_sigs=meta.num_sigs,
            names=[[n] for n in meta.names[:nt]],
            gsizes=[[int(g)] for g in meta.gsizes[:nt]],
            indices=[[int(i)] for i in meta.indices[:nt]],
            sizes=[int(s) for s in meta.sizes[:nt]],
        )
        fname = f"_block{b + 1:03d}.uniki"
        write_uniki(
            os.path.join(rdir, fname), header,
            words_to_ref_bytes(bits, nt),
        )
        files.append(fname)
        all_names.extend(meta.names[:nt])
    fields = {
        "version": 4,
        "unikiVersion": UNIKI_VERSION,
        "alias": alias or os.path.basename(os.path.normpath(out_dir)),
        "k": info.ks[0],
        "ks": [int(k) for k in info.ks],
        "hashed": info.hashed,
        "canonical": info.canonical,
        "scaled": info.scaled,
        "scale": int(info.scale),
        "minimizer": info.minimizer,
        "minimizer-w": int(info.minimizer_w),
        "syncmer": info.syncmer,
        "syncmer-s": int(info.syncmer_s),
        "split-seq": info.split_seq,
        "split-size": int(info.split_size),
        "split-num": int(info.split_num),
        "split-overlap": int(info.split_overlap),
        "compact-size": True,
        "hashes": int(info.num_hashes),
        "fpr": float(info.fpr),
        "numNameGroups": int(info.num_names),
        "blocksize": int(info.block_size),
        "totalKmers": int(info.total_kmers),
        "files": files,
    }
    write_db_yml(os.path.join(rdir, DB_YML), fields)
    with open(os.path.join(rdir, NAME_MAPPING_TSV), "w") as f:
        for n in all_names:
            if n:
                f.write(f"{n}\t{n}\n")
    return rdir
