"""The slice counter's arithmetic for counts of 256 to 511 (paired rows),
built for the CPU with g++: ``kmcp_tpu_torch/csrc/bitslice_host.cpp``
compiles the 9-plane carry-save counter and its epilogue (the byte
transpose, the 9-bit compare against split floors, the count expansion)
from ``csrc/bitslice.cuh``, the header the CUDA kernels K2' and K5'
include.  Fed words laid out as Bloom rows, one row a window, it must give
``count_mask_plain``'s counts and mask exactly."""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from kmcp_tpu_torch.search.count import count_mask_plain
from kmcp_tpu_torch.search.device_step import FLOOR_NEVER

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), "..", "kmcp_tpu_torch", "csrc")
# floors at the 9-plane counter's edges; FLOOR_NEVER excludes
EDGES = np.array([0, 1, 255, 256, 257, 511, 512, FLOOR_NEVER], np.int32)


@pytest.fixture(scope="module")
def bs_host(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("bs") / "libbitslice_host.so")
    res = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so,
         os.path.join(CSRC, "bitslice_host.cpp")],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kmcp_bitslice9_host.argtypes = [vp, i32, i32, i32, i32, vp, vp, vp,
                                        vp]
    return lib


def _words(rng, B, K, W):
    """uint32 [B, K, W] window words whose per-(read, target) counts spread
    over 0..K: each count drawn uniformly, or next to a floor edge (one
    below, at, one above), or 0 or K, its hits on random windows."""
    T = 32 * W
    n = rng.integers(0, K + 1, (B, T))
    near = (EDGES[:6, None] + np.arange(-1, 2)).ravel()
    near = near[(near >= 0) & (near <= K)]
    pick = rng.random((B, T))
    n = np.where(pick < 0.3, rng.choice(near, (B, T)), n)
    n[:, :2] = (0, K)
    r = rng.random((B, T, K))
    cut = np.concatenate([np.sort(r, axis=2), np.full((B, T, 1), 2.0)], 2)
    hits = r < np.take_along_axis(cut, n[..., None], 2)  # exactly n hits
    assert (hits.sum(2) == n).all()
    packed = np.packbits(hits.transpose(0, 2, 1), axis=2, bitorder="little")
    return np.ascontiguousarray(packed).view(np.uint32), n  # [B, K, W]


def _floors(rng, n, K):
    """Floors from the edges, and near 0..K, at random."""
    return np.where(rng.random(n) < 0.5, rng.choice(EDGES, n),
                    rng.integers(0, K + 2, n)).astype(np.int32)


@pytest.mark.parametrize("K", [255, 256, 300, 511])
@pytest.mark.parametrize("kc", [64, 0])  # the slice chunk; 0: whole reads
def test_counter9_matches_plain(bs_host, K, kc):
    """CsaCounter<9> over K windows (in 64-window chunks as the slice
    variant stages them, or whole reads) and the 9-plane epilogue equal
    count_mask_plain on the same words, every floor edge on both sides."""
    rng = np.random.default_rng(K * 10 + kc)
    B, W = 24, 4
    words, n = _words(rng, B, K, W)
    cthr = _floors(rng, B, K)
    cthr[:len(EDGES)] = EDGES
    thr = _floors(rng, 32 * W, K)
    thr[:len(EDGES)] = EDGES
    counts = np.zeros((B, 32 * W), np.int32)
    mask = np.zeros((B, W), np.uint32)
    bs_host.kmcp_bitslice9_host(
        words.ctypes.data, B, K, W, kc or K, cthr.ctypes.data,
        thr.ctypes.data, counts.ctypes.data, mask.ctypes.data)

    rows = np.concatenate([words.reshape(B * K, W),
                           np.zeros((1, W), np.uint32)])  # zero sentinel
    loc = np.arange(B * K, dtype=np.int32).reshape(B, K, 1)
    want_c, want_m = count_mask_plain(
        torch.from_numpy(rows.view(np.int32)), torch.from_numpy(loc),
        torch.from_numpy(cthr), torch.from_numpy(thr))
    np.testing.assert_array_equal(want_c.numpy(), n)
    np.testing.assert_array_equal(counts, want_c.numpy())
    np.testing.assert_array_equal(mask.view(np.int32), want_m.numpy())
    if K > 255:
        assert (counts > 255).any()
    bits = np.unpackbits(mask.view(np.uint8)).sum()
    assert 0 < bits < mask.size * 32  # both outcomes occur
