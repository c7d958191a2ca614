"""K1' hash_loc (kmcp_tpu_torch/search/hash_loc.py) against the Pallas
kernel it ports (kmcp_tpu/search/pallas_hash.py::make_pallas_hash_loc, run
in interpret mode as the JAX suite runs it, value planes included) and the
C++ scanner; and the CUDA kernel's per-window arithmetic
(kmcp_tpu_torch/csrc/nthash_window.cuh, built for the CPU with g++) against
the plain version.  Every output is an integer: compared exactly, position
by position."""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from kmcp_tpu.kmer import native
from kmcp_tpu.kmer.sketches import max_hash_for_scale
from kmcp_tpu.search.pallas_hash import make_pallas_hash_loc
from kmcp_tpu_torch.kmer.nthash import SEED_A, SEED_C, SEED_G, SEED_T
from kmcp_tpu_torch.search.hash_loc import hash_loc, hash_loc_plain

torch.set_num_threads(1)

B, L, K = 256, 64, 21
FULL = (1 << 64) - 1


def _reads(seed: int = 13):
    """256 reads over ACGTacgtN at lengths 64/50/25/21, zero padded."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
    reads = [
        rng.choice(bases, size=[64, 50, 25, 21][i % 4],
                   p=[0.118] * 8 + [0.056]).tobytes()
        for i in range(B)
    ]
    mat = np.zeros((B, L), dtype=np.uint8)
    for i, r in enumerate(reads):
        mat[i, : len(r)] = np.frombuffer(r, np.uint8)
    return reads, mat


def _pallas(mat, S, h, max_hash=FULL):
    """[B, K, h] loc and [B] nk from the interpret-mode Pallas kernel."""
    outs = make_pallas_hash_loc(K, L, S, max_hash, interpret=True,
                                num_hashes=h)(mat)
    loc = np.stack([np.asarray(o).T for o in outs[:h]], axis=-1)
    return loc, np.asarray(outs[h])[0]


@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("S", [99991, 4096, 3578, 65536])
def test_hash_loc_matches_pallas(S, h):
    _reads_list, mat = _reads()
    want_loc, want_nk = _pallas(mat, S, h)
    loc, nk = hash_loc(torch.from_numpy(mat), K, S, FULL, h)
    assert loc.dtype == torch.int32 and loc.shape == (B, L - K + 1, h)
    np.testing.assert_array_equal(loc.numpy(), want_loc)
    np.testing.assert_array_equal(nk.numpy(), want_nk)


def test_hash_loc_scaled_max_hash():
    """A FracMinHash scale drops windows with h > max_hash."""
    _reads_list, mat = _reads(7)
    max_hash = int(max_hash_for_scale(3))
    assert max_hash < FULL
    want_loc, want_nk = _pallas(mat, 99991, 1, max_hash)
    loc, nk = hash_loc_plain(torch.from_numpy(mat), K, 99991, max_hash, 1)
    np.testing.assert_array_equal(loc.numpy(), want_loc)
    np.testing.assert_array_equal(nk.numpy(), want_nk)
    full_nk = _pallas(mat, 99991, 1)[1]
    assert (want_nk <= full_nk).all() and want_nk.sum() < full_nk.sum()


@pytest.mark.parametrize("h", [1, 3])
def test_hash_loc_matches_native(h):
    """The C++ scanner packs each read's valid windows; as multisets per
    read and hash they equal the kernel's non-sentinel locations."""
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    reads, mat = _reads()
    S = 99991
    want, counts = native.hash_reads_loc(reads, K, L - K + 1, S, h)
    loc, nk = hash_loc(torch.from_numpy(mat), K, S, FULL, h)
    loc = loc.numpy()
    np.testing.assert_array_equal(nk.numpy(), counts)
    for i in range(B):
        for j in range(h):
            a = sorted(x for x in want[i, :, j].tolist() if x != S)
            b = sorted(x for x in loc[i, :, j].tolist() if x != S)
            assert a == b, (i, j)


def test_hash_loc_rejects_bad_input():
    """Wrong dtype, hash count or device raise; nothing falls back."""
    _reads_list, mat = _reads()
    t = torch.from_numpy(mat)
    with pytest.raises(ValueError):
        hash_loc(t.to(torch.int32), K, 4096, FULL, 1)
    with pytest.raises(ValueError):
        hash_loc(t, K, 4096, FULL, 5)
    with pytest.raises(ValueError):
        hash_loc(torch.empty((B, L), dtype=torch.uint8, device="meta"),
                 K, 4096, FULL, 1)


# The value plane: (S, h, screen plane), every modulus path of the loc and
# screen planes (power of two, < 2^16, Barrett) and h = 1..4.
VALUE_CASES = [(3578, 1, 1 << 25), (4096, 2, 0), (65536, 1, 999_983),
               (1_850_000, 3, 0), (2**31 - 1, 4, 0)]


@pytest.mark.parametrize("S,h,N", VALUE_CASES)
def test_value_plane_matches_pallas(S, h, N):
    """hash_loc(values=True) against make_pallas_hash_loc(emit_values=True)
    in interpret mode: vals == (hi << 32) | lo, and loc, nk and the screen
    plane equal the kernel's as without values."""
    _reads_list, mat = _reads(S % 101)
    outs = make_pallas_hash_loc(K, L, S, FULL, interpret=True, num_hashes=h,
                                screen_sigs=N, emit_values=True)(mat)
    n = h + (1 if N else 0)
    hi = np.asarray(outs[n + 1]).T.astype(np.uint64)
    lo = np.asarray(outs[n + 2]).T.astype(np.uint64)
    want_vals = ((hi << np.uint64(32)) | lo).view(np.int64)
    got = hash_loc(torch.from_numpy(mat), K, S, FULL, h, screen_sigs=N,
                   values=True)
    assert len(got) == (4 if N else 3) and got[-1].dtype == torch.int64
    np.testing.assert_array_equal(got[-1].numpy(), want_vals)
    np.testing.assert_array_equal(
        got[0].numpy(), np.stack([np.asarray(o).T for o in outs[:h]], -1))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(outs[n])[0])
    if N:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(outs[h]).T)
    assert (want_vals != 0).sum() == int(got[1].sum()) > 0
    # values off: the same planes, without vals
    plain = hash_loc(torch.from_numpy(mat), K, S, FULL, h, screen_sigs=N)
    assert len(plain) == len(got) - 1
    for a, b in zip(plain, got):
        assert torch.equal(a, b)


# -- the kernel's per-window arithmetic (csrc/nthash_window.cuh), built for
# -- the CPU with g++ through csrc/hash_loc_host.cpp

CSRC = os.path.join(os.path.dirname(__file__), "..", "kmcp_tpu_torch", "csrc")
SEEDS = (ctypes.c_ulonglong * 4)(*(int(s) for s in (SEED_A, SEED_C, SEED_G,
                                                     SEED_T)))


@pytest.fixture(scope="module")
def nt_host(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("nt") / "libnt_host.so")
    res = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so,
         os.path.join(CSRC, "hash_loc_host.cpp")],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kmcp_hash_loc_host.argtypes = [vp, i32, i32, i32, i64,
                                       ctypes.c_ulonglong, i32, vp, i64, i32,
                                       vp, vp, vp, vp]
    lib.kmcp_nt_direct.argtypes = [vp, i32, i32, i32, vp, vp]
    lib.kmcp_nt_mod.argtypes = [vp, i64, ctypes.c_uint, vp]
    return lib


def _host_hash_loc(lib, mat, k, S, max_hash, h, N, ls):
    B, lmax = mat.shape
    Kw = lmax - k + 1
    loc = np.zeros((B, Kw, h), np.int32)
    nk = np.zeros(B, np.int32)
    locu = np.zeros((B, Kw), np.int32) if N else None
    vals = np.zeros((B, Kw), np.int64)
    ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
    lib.kmcp_hash_loc_host(ptr(mat), B, lmax, k, S, max_hash, h, SEEDS, N, ls,
                           ptr(loc), ptr(locu), ptr(nk), ptr(vals))
    return (loc, nk) + ((locu,) if N else ()) + (vals,)


def _mixed_reads(seed, B, lmax):
    """Reads over ACGTacgt with N runs, a few shorter than k, zero padded."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTacgt", dtype=np.uint8)
    mat = rng.choice(alphabet, size=(B, lmax)).astype(np.uint8)
    for b in range(0, B, 3):  # N runs
        p = int(rng.integers(0, lmax))
        mat[b, p : p + int(rng.integers(1, 6))] = ord("N")
    lens = rng.integers(0, lmax + 1, B)
    lens[::7] = rng.integers(0, 21, len(lens[::7]))
    mat[np.arange(lmax)[None, :] >= lens[:, None]] = 0
    return np.ascontiguousarray(mat)


@pytest.mark.parametrize("k,lmax,S,h,N,ls", [
    (21, 160, 3578, 1, 1 << 25, 18),  # the screened path, 16-window strips
    (21, 320, 3578, 1, 1 << 25, 19),  # paired rows
    (21, 160, 1_850_000, 3, 0, 1),  # one window a strip
    (21, 96, 2**31 - 1, 1, 2**31 - 1, 7),
    (31, 64, 65536, 4, 0, 34),  # one strip a read
    (21, 64, 4096, 2, 0, 5),
])
def test_header_strips_match_plain(nt_host, k, lmax, S, h, N, ls):
    """The kernel's strips (warm-up from state 0, then rolling), run on the
    CPU, equal the plain version's rolling of whole reads: every plane."""
    mat = _mixed_reads(lmax + h, 64, lmax)
    max_hash = FULL if h != 3 else FULL // 5
    got = _host_hash_loc(nt_host, mat, k, S, max_hash, h, N, ls)
    want = hash_loc_plain(torch.from_numpy(mat), k, S, max_hash, h,
                          screen_sigs=N, values=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert int(want[1].sum()) > 0


@pytest.mark.parametrize("k", [21, 31, 64, 70])
def test_header_direct_formula_matches_rolling(nt_host, k):
    """nt_direct (each window hashed from its own k bases, rotations mod
    64) equals the rolling value of every valid window, and is 0 exactly
    where a window holds an invalid base."""
    lmax = 160
    mat = _mixed_reads(k, 48, lmax)
    Kw = lmax - k + 1
    out = np.zeros((48, Kw), np.uint64)
    nt_host.kmcp_nt_direct(mat.ctypes.data, 48, lmax, k, SEEDS,
                           out.ctypes.data)
    _, nk, vals = hash_loc_plain(torch.from_numpy(mat), k, 3578, FULL, 1,
                                 values=True)
    np.testing.assert_array_equal(out.view(np.int64), vals.numpy())
    assert int(nk.sum()) == int((out != 0).sum()) > 0


@pytest.mark.parametrize("d", [1, 2, 3, 7, 3578, 4096, 65535, 65536,
                               999_983, 1_850_000, 1 << 25, 2**31 - 1])
def test_header_moduli_exact(nt_host, d):
    """nt::mod (an AND for powers of two, Barrett otherwise) equals x % d
    for random 64-bit x and the edges of the range."""
    rng = np.random.default_rng(d)
    x = np.concatenate([
        rng.integers(0, 2**64, 20000, dtype=np.uint64),
        rng.integers(0, 2**32, 2000, dtype=np.uint64),
        np.array([0, 1, d - 1, d, d + 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
                  2**64 - 2, 2**64 - 1, (2**64 - 1) // d * d,
                  (2**64 - 1) // d * d - 1], dtype=np.uint64),
    ])
    out = np.zeros(len(x), np.uint32)
    nt_host.kmcp_nt_mod(x.ctypes.data, len(x), d, out.ctypes.data)
    want = np.array([int(v) % d for v in x.tolist()], dtype=np.uint32)
    np.testing.assert_array_equal(out, want)
