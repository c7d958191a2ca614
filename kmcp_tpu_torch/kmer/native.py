"""ctypes bridge to the port's host C++ (csrc/host/*.cpp): the rolling
ntHash scan, the Bloom word-column build, the union-screen fill, the
parallel sort + unique, Bloom-row locations, read-batch packing, the
TSV row writer, and the search-TSV scanners of ``profile`` and ``merge``.

The port's copy of kmcp_tpu/kmer/native.py, cut to the entry points the
port calls.  At first use ``g++`` builds the three sources into one shared
library under ``kmcp_tpu_torch/build/host-<source hash>/``; a change to a
source or to the flags changes the hash and so triggers a rebuild.  A
missing ``g++`` or a failed build raises with the compiler's output: there
is no NumPy fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "build")
GXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
             "-fopenmp"]

_lock = threading.Lock()
_lib = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cpp")))


def library_path() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"host-{h.hexdigest()[:16]}",
                        "libkmcp_host.so")


def build() -> str:
    """Compile the sources unless the library for their hash exists;
    returns its path."""
    so = library_path()
    if os.path.isfile(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, *sources()]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(
            "g++ not found: kmcp_tpu_torch builds its host C++ from source "
            "at first use"
        ) from e
    if res.returncode != 0:
        raise RuntimeError(
            f"g++ failed (exit {res.returncode}): {' '.join(cmd)}\n"
            f"{res.stderr}{res.stdout}"
        )
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.kthash_scan_mt.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            u64p, u8p, ctypes.c_int,
        ]
        lib.kthash_scan_mt.restype = None
        lib.kt_sort_unique.argtypes = [u64p, ctypes.c_int64, ctypes.c_int]
        lib.kt_sort_unique.restype = ctypes.c_int64
        lib.kt_build_word_column.argtypes = [
            u64p, i64p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64, u32p,
        ]
        lib.kt_build_word_column.restype = None
        lib.kt_union_fill.argtypes = [
            u64p, ctypes.c_int64, ctypes.c_uint64, u64p, ctypes.c_int,
        ]
        lib.kt_union_fill.restype = None
        lib.kt_locations.argtypes = [
            u64p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64, i32p,
            ctypes.c_int,
        ]
        lib.kt_locations.restype = None
        lib.kt_write_rows.argtypes = [
            i32p, i32p, i32p, ctypes.c_int64,
            ctypes.c_int64, i64p, i64p, i32p, u8p,
            ctypes.c_char_p, i64p,
            ctypes.c_char_p, i64p,
            ctypes.c_char_p, i64p,
            i64p,
            ctypes.c_char_p, i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.kt_write_rows.restype = ctypes.c_int64
        lib.kt_pack_rows.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int64, u8p,
        ]
        lib.kt_pack_rows.restype = None
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.kt_parse_search_tsv.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_double,
            i64p, i32p, i32p, i64p, f64p,
            i64p, i64p, i32p, i64p,
            i64p, i64p,
            i64p,
        ]
        lib.kt_parse_search_tsv.restype = ctypes.c_int64
        lib.kt_merge_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            i64p, i64p, i64p, i64p, i64p, i64p, f64p, i64p,
        ]
        lib.kt_merge_scan.restype = ctypes.c_int64
        lib.kt_merge_emit.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i64p,
            i64p, i64p, i64p, i64p, i64p, i64p, i32p,
            ctypes.c_void_p,
        ]
        lib.kt_merge_emit.restype = ctypes.c_int64
        _lib = lib
        return _lib


def _threads(threads: int) -> int:
    return threads if threads > 0 else min(os.cpu_count() or 1, 16)


def scan(buf: bytes | np.ndarray, k: int, canonical: bool = True,
         threads: int = 0):
    """All-window ntHash over ``buf``: (hashes[L-k+1] uint64,
    valid[L-k+1] bool)."""
    lib = get_lib()
    if isinstance(buf, np.ndarray):
        buf = buf.tobytes()
    L = len(buf)
    n = L - k + 1
    if n <= 0:
        return np.empty(0, np.uint64), np.empty(0, bool)
    out = np.zeros(n, dtype=np.uint64)
    valid = np.zeros(n, dtype=np.uint8)
    lib.kthash_scan_mt(
        buf, L, k, int(canonical),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _threads(threads),
    )
    return out, valid.view(bool)


def pack_rows(reads: list[bytes], lens: np.ndarray, stride: int):
    """Pack reads into a zero-padded row-major [B, stride] uint8 matrix
    (the device batch layout)."""
    lib = get_lib()
    B = len(reads)
    concat = b"".join(reads)
    offs = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(np.asarray(lens, dtype=np.int64), out=offs[1:])
    out = np.empty((B, stride), dtype=np.uint8)
    lib.kt_pack_rows(
        concat,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, stride,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


_write_buf: np.ndarray | None = None


def _get_write_buf(size: int) -> np.ndarray:
    global _write_buf
    if _write_buf is None or _write_buf.nbytes < size:
        _write_buf = np.empty(int(size * 1.5), dtype=np.uint8)
    return _write_buf


def make_strtab(strings: list[bytes]) -> tuple[bytes, np.ndarray]:
    """(data, offsets[n+1]) flat string table for the native writer."""
    offsets = np.zeros(len(strings) + 1, dtype=np.int64)
    np.cumsum(
        np.fromiter(map(len, strings), np.int64, len(strings)),
        out=offsets[1:],
    )
    return b"".join(strings), offsets


def write_rows(
    qi: np.ndarray, t: np.ndarray, cnt: np.ndarray,
    qlen: np.ndarray, nkmers: np.ndarray, hits: np.ndarray,
    flags: np.ndarray,
    qid_tab, tname_tab, tmeta_tab,
    sizes: np.ndarray,
    fpr_tab, fpr_nmax: int,
    qidx_base: int,
    keep_unmatched: bool = False,
    k: int = 0,
) -> bytes:
    """Format match rows natively; returns the TSV bytes.
    With ``keep_unmatched``, reads with no hits emit the reference's
    unmatched row (kSize column = ``k``; flags bit1 marks too-short
    reads whose k-mer count reports as 0)."""
    lib = get_lib()
    n_rows = len(qi)
    n_reads = len(qlen)
    est = (n_rows + (n_reads if keep_unmatched else 0)) * 256 + 64
    buf = _get_write_buf(est)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    qi32, t32, c32 = (
        np.ascontiguousarray(qi, np.int32),
        np.ascontiguousarray(t, np.int32),
        np.ascontiguousarray(cnt, np.int32),
    )
    ql64, nk64 = (
        np.ascontiguousarray(qlen, np.int64),
        np.ascontiguousarray(nkmers, np.int64),
    )
    h32 = np.ascontiguousarray(hits, np.int32)
    f8 = np.ascontiguousarray(flags, np.uint8)
    sz64 = np.ascontiguousarray(sizes, np.int64)
    qd, qo = qid_tab
    td, to = tname_tab
    md, mo = tmeta_tab
    fd, fo = fpr_tab
    n = lib.kt_write_rows(
        qi32.ctypes.data_as(i32p), t32.ctypes.data_as(i32p),
        c32.ctypes.data_as(i32p), n_rows,
        n_reads, ql64.ctypes.data_as(i64p), nk64.ctypes.data_as(i64p),
        h32.ctypes.data_as(i32p),
        f8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        qd, qo.ctypes.data_as(i64p),
        td, to.ctypes.data_as(i64p),
        md, mo.ctypes.data_as(i64p),
        sz64.ctypes.data_as(i64p),
        fd, fo.ctypes.data_as(i64p), fpr_nmax,
        qidx_base, buf.ctypes.data,
        int(keep_unmatched), (ks := str(k).encode()), len(ks),
    )
    return buf[:n].tobytes()


def build_word_column(
    hashes_concat: np.ndarray, offsets: np.ndarray, n_targets: int,
    num_hashes: int, num_sigs: int,
) -> np.ndarray:
    """Build one uint32 word column (<=32 targets) of a Bloom matrix."""
    lib = get_lib()
    col = np.zeros(num_sigs, dtype=np.uint32)
    h = np.ascontiguousarray(hashes_concat, dtype=np.uint64)
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    lib.kt_build_word_column(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_targets, num_hashes, np.uint64(num_sigs),
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return col


def union_fill(hashes: np.ndarray, num_bits: int, threads: int = 0,
               out: np.ndarray | None = None) -> np.ndarray:
    """Bloom bitset (1 hash) over ``hashes % num_bits``: the per-block
    union screen.  ORs into ``out`` when given (a block's union builds
    target by target into one buffer).  Returns the uint64 words."""
    lib = get_lib()
    h = np.ascontiguousarray(hashes, dtype=np.uint64).ravel()
    words = (
        out
        if out is not None
        else np.zeros((num_bits + 63) // 64, dtype=np.uint64)
    )
    lib.kt_union_fill(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(h),
        np.uint64(num_bits),
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _threads(threads),
    )
    return words


def locations(hashes: np.ndarray, num_hashes: int, num_sigs: int,
              threads: int = 0) -> np.ndarray:
    """Bloom-row positions of a uint64 hash array of any shape -> int32
    with a trailing ``num_hashes`` axis (kernel.derive_locations)."""
    lib = get_lib()
    flat = np.ascontiguousarray(hashes, dtype=np.uint64).ravel()
    out = np.empty(flat.shape[0] * num_hashes, dtype=np.int32)
    lib.kt_locations(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        flat.shape[0], num_hashes, num_sigs,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _threads(threads),
    )
    return out.reshape(*hashes.shape, num_hashes)


def sort_unique(hashes: np.ndarray, threads: int = 0) -> np.ndarray:
    """Parallel sort + unique of a uint64 array; returns the unique sorted
    values (a view of the scratch copy)."""
    lib = get_lib()
    a = np.ascontiguousarray(hashes, dtype=np.uint64).copy()
    m = lib.kt_sort_unique(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(a),
        _threads(threads),
    )
    return a[:m]


def parse_search_tsv(buf: bytes, max_fpr: float, min_qcov: float) -> dict:
    """Columnar parse of one search-result TSV's decompressed content
    (row filters qCov >= min / FPR <= max, consecutive-query grouping,
    target interning — KMCP's cmd/util-profile.go:94-182 semantics).

    Returns a dict of arrays: group/target/frag/qlen/qcov per row,
    tgt_names (list[bytes]), tgt_idx_num, tgt_gsize per target,
    grp_off/grp_len per group (query-id spans in ``buf``), total_queries
    and matched_queries.  Raises ValueError on malformed rows.
    """
    lib = get_lib()
    # capacity: number of newlines bounds rows/groups/targets
    cap = max(buf.count(b"\n") + 1, 1)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    f64 = ctypes.POINTER(ctypes.c_double)
    row_group = np.empty(cap, dtype=np.int64)
    row_target = np.empty(cap, dtype=np.int32)
    row_frag = np.empty(cap, dtype=np.int32)
    row_qlen = np.empty(cap, dtype=np.int64)
    row_qcov = np.empty(cap, dtype=np.float64)
    tgt_off = np.empty(cap, dtype=np.int64)
    tgt_len = np.empty(cap, dtype=np.int64)
    tgt_idx_num = np.empty(cap, dtype=np.int32)
    tgt_gsize = np.empty(cap, dtype=np.int64)
    grp_off = np.empty(cap, dtype=np.int64)
    grp_len = np.empty(cap, dtype=np.int64)
    counts = np.zeros(5, dtype=np.int64)
    rc = lib.kt_parse_search_tsv(
        buf, len(buf), max_fpr, min_qcov,
        row_group.ctypes.data_as(i64), row_target.ctypes.data_as(i32),
        row_frag.ctypes.data_as(i32), row_qlen.ctypes.data_as(i64),
        row_qcov.ctypes.data_as(f64),
        tgt_off.ctypes.data_as(i64), tgt_len.ctypes.data_as(i64),
        tgt_idx_num.ctypes.data_as(i32), tgt_gsize.ctypes.data_as(i64),
        grp_off.ctypes.data_as(i64), grp_len.ctypes.data_as(i64),
        counts.ctypes.data_as(i64),
    )
    if rc != 0:
        raise ValueError("invalid kmcp search result format")
    n_rows, n_groups, n_targets, total_q, matched_q = (
        int(c) for c in counts
    )
    return {
        "group": row_group[:n_rows],
        "target": row_target[:n_rows],
        "frag": row_frag[:n_rows],
        "qlen": row_qlen[:n_rows],
        "qcov": row_qcov[:n_rows],
        "tgt_names": [
            buf[int(o) : int(o) + int(l)]
            for o, l in zip(tgt_off[:n_targets], tgt_len[:n_targets])
        ],
        "tgt_idx_num": tgt_idx_num[:n_targets].copy(),
        "tgt_gsize": tgt_gsize[:n_targets].copy(),
        "grp_off": grp_off[:n_groups].copy(),
        "grp_len": grp_len[:n_groups].copy(),
        "total_queries": total_q,
        "matched_queries": matched_q,
    }


def merge_scan(buf: bytes, score_col: int) -> dict:
    """Scan one search TSV for the k-way merge: per-row spans, hits-column
    spans, query-id lengths, queryIdx and score, plus the file's stat-line
    totals.  Raises ValueError on a row with fewer than 15 columns."""
    lib = get_lib()
    cap = max(buf.count(b"\n") + 1, 1)
    i64 = ctypes.POINTER(ctypes.c_int64)
    f64 = ctypes.POINTER(ctypes.c_double)
    row_off = np.empty(cap, dtype=np.int64)
    row_len = np.empty(cap, dtype=np.int64)
    hits_off = np.empty(cap, dtype=np.int64)
    hits_len = np.empty(cap, dtype=np.int64)
    qid_len = np.empty(cap, dtype=np.int64)
    qidx = np.empty(cap, dtype=np.int64)
    score = np.empty(cap, dtype=np.float64)
    counts = np.zeros(3, dtype=np.int64)
    rc = lib.kt_merge_scan(
        buf, len(buf), score_col,
        row_off.ctypes.data_as(i64), row_len.ctypes.data_as(i64),
        hits_off.ctypes.data_as(i64), hits_len.ctypes.data_as(i64),
        qid_len.ctypes.data_as(i64), qidx.ctypes.data_as(i64),
        score.ctypes.data_as(f64), counts.ctypes.data_as(i64),
    )
    if rc != 0:
        raise ValueError("invalid kmcp search result format")
    n = int(counts[0])
    return {
        "row_off": row_off[:n], "row_len": row_len[:n],
        "hits_off": hits_off[:n], "hits_len": hits_len[:n],
        "qid_len": qid_len[:n], "qidx": qidx[:n], "score": score[:n],
        "total_queries": int(counts[1]),
        "matched_queries": int(counts[2]),
    }


def merge_emit(buf: bytes, order, row_off, row_len, hits_off, hits_len,
               qid_len, qidx, hits) -> bytes:
    """Assemble merged output rows (hits column rewritten) in ``order``.
    Returns bytes, or raises SystemExit on a query-id mismatch within a
    queryIdx group (reporting the offending output position)."""
    lib = get_lib()
    n_out = len(order)
    bufsize = int(row_len.sum()) + n_out * 12 + 64
    out = _get_write_buf(bufsize)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    rc = lib.kt_merge_emit(
        buf, n_out,
        np.ascontiguousarray(order, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(row_off, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(row_len, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(hits_off, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(hits_len, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(qid_len, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(qidx, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(hits, dtype=np.int32).ctypes.data_as(i32),
        out.ctypes.data,
    )
    if rc < 0:
        i = -int(rc) - 2
        r = int(order[i])
        row = buf[int(row_off[r]) : int(row_off[r]) + int(row_len[r])]
        qid = row.split(b"\t", 1)[0].decode()
        raise SystemExit(
            f"[queryIdx: {int(qidx[r])}] unmatched sequence Ids: "
            f"'{qid}' — results must come from the same query file"
        )
    return out[:rc].tobytes()
