"""ctypes bridge to the port's host C++ (csrc/host/*.cpp): the rolling
ntHash scan, the Bloom word-column build, the union-screen fill, the
parallel sort + unique, read-batch packing and the TSV row writer.

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
