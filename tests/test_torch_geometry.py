"""The slice counter's and the row ring's geometry, built for the CPU with
g++: ``kmcp_tpu_torch/csrc/geometry_host.cpp`` compiles
``csrc/geometry.cuh``, the header K2' (count_mask.cu) and K5'
(pair_count.cu) pick their variant from.  On an H100's 232,448 bytes of
shared memory a block: the row count where the slice tile stops holding
every row, and the variant chosen on either side of it; the ring's shared
memory within the limit (two CTAs an SM at one hash); and each ring
warp's copies covering every word of its row segments exactly once, for
every hash count and copy width, ragged slices included."""

import ctypes
import os
import subprocess

import numpy as np
import pytest

CSRC = os.path.join(os.path.dirname(__file__), "..", "kmcp_tpu_torch", "csrc")
H100_SMEM = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
H100_SM_SMEM = 233_472  # shared memory of one SM (228 KB)
RING_KC = 8
VARIANTS = ("gather", "slice", "ring")


@pytest.fixture(scope="module")
def geo(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("geo") / "libgeometry_host.so")
    res = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so,
         os.path.join(CSRC, "geometry_host.cpp")],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(so)
    i32 = ctypes.c_int
    lib.kmcp_geo_pick.argtypes = [i32] * 4
    lib.kmcp_geo_slice_smem.argtypes = [i32] * 2
    lib.kmcp_geo_slice_smem.restype = ctypes.c_longlong
    lib.kmcp_geo_ring_smem.argtypes = [i32] * 2
    lib.kmcp_geo_ring_smem.restype = ctypes.c_longlong
    lib.kmcp_geo_ring_span.argtypes = [i32]
    lib.kmcp_geo_ring_stage_hits.argtypes = [i32] * 3 + [ctypes.c_void_p]
    return lib


def _pick(geo, W, S_ext, h):
    return VARIANTS[geo.kmcp_geo_pick(H100_SMEM, W, S_ext, h)]


# the last rows + sentinel of the slice tile at each hash count
@pytest.mark.parametrize("h,last", [(1, 5078), (2, 5078), (3, 4054),
                                    (4, 3030)])
def test_slice_switches_to_ring_where_its_rows_stop_fitting(geo, h, last):
    for W in (8, 13, 4096):
        assert _pick(geo, W, last, h) == "slice"
        assert _pick(geo, W, last + 1, h) == "ring"
        assert _pick(geo, W, 1 << 20, h) == "ring"
    assert geo.kmcp_geo_slice_smem(last, h) <= H100_SMEM
    assert geo.kmcp_geo_slice_smem(last + 1, h) > H100_SMEM
    # rows narrower than one tile of 8 words take the gather at any count
    for s_ext in (61, last + 1, 1 << 25):
        assert _pick(geo, 7, s_ext, h) == "gather"


def test_store_stage_shares_a_location_buffer(geo):
    """4,053 rows and the sentinel filled the tile at h = 1 while the store
    stage had its own 32 KB; it shares a location buffer, so more fit."""
    assert _pick(geo, 4096, 4055, 1) == "slice"


@pytest.mark.parametrize("W,span", [(8, 32), (13, 32), (33, 64), (128, 128),
                                    (1000, 512), (4096, 512), (5, 32)])
def test_ring_span(geo, W, span):
    assert geo.kmcp_geo_ring_span(W) == span


@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_ring_smem_fits(geo, h):
    for span in (32, 64, 128, 256, 512):
        assert geo.kmcp_geo_ring_smem(span, h) <= H100_SMEM
    if h == 1:  # two CTAs an SM (1 KB of each CTA's is the system's)
        assert 2 * (geo.kmcp_geo_ring_smem(512, 1) + 1024) <= H100_SM_SMEM


@pytest.mark.parametrize("wpc", [4, 1])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
@pytest.mark.parametrize("nw", [32, 20, 8, 4])
def test_ring_stage_copies_cover_each_word_once(geo, nw, h, wpc):
    """A warp's stage: RING_KC windows x h rows of its 32 words; every word
    that lies in the rows (the first nw) copied by exactly one copy, none
    past them, none outside the stage."""
    hits = np.zeros(RING_KC * h * 32, dtype=np.int32)
    outside = geo.kmcp_geo_ring_stage_hits(h, nw, wpc, hits.ctypes.data)
    assert outside == 0
    per_seg = hits.reshape(RING_KC * h, 32)  # segment (window, hash)
    np.testing.assert_array_equal(per_seg[:, :nw], 1)
    np.testing.assert_array_equal(per_seg[:, nw:], 0)
