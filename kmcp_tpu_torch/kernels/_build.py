"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

The counterpart of the native C++ loader (kmcp_tpu/kmer/native.py:29-53,
``_build``/``get_lib``) for the CUDA sources under ``kmcp_tpu_torch/csrc/``.
At first use every ``csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a``, one process per file, all at once, and linked into one shared
library with a plain C interface, under
``kmcp_tpu_torch/build/<source hash>/``; a change to any source or to a
shared header (``csrc/*.cuh``) changes the hash and so triggers a
rebuild.  Nothing includes PyTorch's headers, so a build takes seconds.
A missing ``nvcc`` or a failed build raises with the compiler's output;
there is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
# Wall seconds of the build this process ran (None: the library was cached)
# and nvcc's output for it (ptxas register / spill report).
build_seconds: float | None = None
build_log = ""


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in sources() + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the toolkit's standard prefix
    if os.path.isfile(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of kmcp_tpu_torch are built from source at first use"
    )


def library_path() -> str:
    return os.path.join(BUILD_DIR, source_hash(), "libkmcp_cuda.so")


def compile_library(srcs: list[str], so: str) -> str:
    """nvcc each source to an object, all in parallel, then link them into
    the shared library ``so``; returns nvcc's output.  Raises with it on a
    failure."""
    nvcc = find_nvcc()
    objs = [f"{so}.{os.path.basename(src)}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(srcs, objs)]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        for cmd, p, out in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {p.returncode}): "
                                   f"{' '.join(cmd)}\n{out}")
        res = subprocess.run(link, capture_output=True, text=True)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    log = "".join(outs)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {res.returncode}): "
                           f"{' '.join(link)}\n{res.stderr}{res.stdout}")
    return log + res.stderr + res.stdout


def build() -> str:
    """Compile the sources unless the library for their hash exists;
    returns its path."""
    global build_seconds, build_log
    so = library_path()
    if os.path.isfile(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.time()
    log = compile_library(sources(), tmp)
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    build_seconds = time.time() - t0
    build_log = log
    return so


def load(so: str) -> ctypes.CDLL:
    """The kernel library at ``so``, its entry points typed."""
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    i64, u64 = ctypes.c_longlong, ctypes.c_ulonglong
    lib.kmcp_hash_loc.argtypes = [
        vp, i32, i32, i32, i64, u64, i32, u64, u64, u64, u64,
        i64, vp, vp, vp, vp, vp,
    ]
    lib.kmcp_hash_loc.restype = i32
    lib.kmcp_count_mask.argtypes = [
        vp, i32, i32, vp, i32, i32, i32, vp, vp, vp, vp, vp,
    ]
    lib.kmcp_count_mask.restype = i32
    lib.kmcp_pair_count.argtypes = [
        vp, i32, i32, i32, vp, i32, vp, vp, i32, vp, vp, vp, vp, vp,
        vp, vp,
    ]
    lib.kmcp_pair_count.restype = i32
    lib.kmcp_count_mask_variant.argtypes = [i32, i32, i32]
    lib.kmcp_count_mask_variant.restype = i32
    lib.kmcp_pair_count_variant.argtypes = [i32, i32]
    lib.kmcp_pair_count_variant.restype = i32
    lib.kmcp_group_count.argtypes = [
        vp, i32, i32, i32, i32, i32, vp, i32, vp, vp, vp, i32, vp, vp,
        vp, vp, vp,
    ]
    lib.kmcp_group_count.restype = i32
    lib.kmcp_compact.argtypes = [
        vp, vp, i64, i64, vp, i64, vp, i32, i32, i32, i32, vp, vp, vp, i32,
        i32, vp,
    ]
    lib.kmcp_compact.restype = i32
    lib.kmcp_compact_tiles.argtypes = [i64]
    lib.kmcp_compact_tiles.restype = i64
    ip = ctypes.POINTER(i32)
    lib.kmcp_dedup.argtypes = [
        vp, vp, i64, i32, i32, i32, vp, i32, ip, i32, vp, i32, ip, i32, vp,
        i64, vp, vp,
    ]
    lib.kmcp_dedup.restype = i32
    lib.kmcp_dedup_scratch.argtypes = [i64, i32]
    lib.kmcp_dedup_scratch.restype = i64
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def build_checkout(csrc_dir: str, so: str) -> ctypes.CDLL:
    """Build the ``*.cu`` of another checkout's ``csrc/`` (with the same
    entry points) into ``so`` and load it, for A/B timing tools."""
    srcs = sorted(glob.glob(os.path.join(csrc_dir, "*.cu")))
    if not srcs:
        raise SystemExit(f"no *.cu under {csrc_dir}")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    compile_library(srcs, so)
    return load(so)


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """Within the block the kernel wrappers launch from ``lib``."""
    global _lib
    saved = get_lib()
    _lib = lib
    try:
        yield lib
    finally:
        _lib = saved
