"""The CUDA kernels on the card against their plain PyTorch versions at
edge shapes the chip smoke does not reach (odd batch sizes, W = 1 and 33,
h = 2 and 4, K past 255, scaled max_hash, k = 31; K1''s screen plane; K5'
on narrow and wide blocks, unsorted pairs, empty and crowded blocks; K6'
at ragged S_pad and T, partial and padding tiles, multiplicity 256,
sentinel-only reads, FLOOR_NEVER floors, bit 31 and two sweeps; K1''s
value plane at single-end and paired row lengths, every modulus path and
rows too long to stage in shared memory), and the count and screened
tails, single-end and paired (in_dedup), on the card against their CPU
runs.  Marked ``cuda``:
they skip without a card and run on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from kmcp_tpu_torch.search.count import count_mask, count_mask_plain
from kmcp_tpu_torch.search.device_step import FLOOR_NEVER, count_tail
from kmcp_tpu_torch.search.group_count import (
    gemm_slabs,
    group_count,
    group_count_plain,
)
from kmcp_tpu_torch.search.hash_loc import hash_loc, hash_loc_plain
from kmcp_tpu_torch.search.pair_count import pair_count, pair_count_plain
from kmcp_tpu_torch.search.screen import screened_tail

pytestmark = pytest.mark.cuda

FULL = (1 << 64) - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _reads(rng, B, lmax):
    alphabet = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
    mat = rng.choice(alphabet, size=(B, lmax),
                     p=[0.124] * 8 + [0.008]).astype(np.uint8)
    lens = rng.integers(0, lmax + 1, B)
    mat[np.arange(lmax)[None, :] >= lens[:, None]] = 0
    return torch.from_numpy(mat)


@pytest.mark.parametrize("k,lmax,S,h,max_hash", [
    (21, 64, 99991, 1, FULL),
    (21, 608, 3578, 2, FULL),
    (31, 96, 65536, 4, FULL // 7),
    (21, 21, 7, 3, FULL),
    (21, 160, 2**31 - 1, 1, FULL),
])
def test_hash_loc_kernel_matches_plain(cuda, k, lmax, S, h, max_hash):
    reads = _reads(np.random.default_rng(lmax + h), 300, lmax).to(cuda)
    n0 = hash_loc.launches
    loc, nk = hash_loc(reads, k, S, max_hash, h)
    loc_p, nk_p = hash_loc_plain(reads, k, S, max_hash, h)
    torch.cuda.synchronize()
    assert hash_loc.launches == n0 + 1
    assert torch.equal(loc, loc_p) and torch.equal(nk, nk_p)
    assert int(nk.sum()) > 0


@pytest.mark.parametrize("W,K,h,B", [
    (1, 1, 1, 1), (5, 580, 2, 300), (33, 140, 4, 70), (4096, 140, 1, 40),
])
def test_count_mask_kernel_matches_plain(cuda, W, K, h, B):
    rng = np.random.default_rng(W * 7 + K)
    S = 997
    bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
    bits |= rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
    bits[-1] = 0
    loc = rng.integers(0, S + 1, (B, K, h)).astype(np.int32)
    thr = rng.integers(0, K + 2, 32 * W).astype(np.int32)
    thr[-3:] = FLOOR_NEVER
    cthr = rng.integers(0, K + 2, B).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in
            (bits.view(np.int32), loc, cthr, thr)]
    n0 = count_mask.launches
    counts, mask = count_mask(*args)
    counts_p, mask_p = count_mask_plain(*args)
    torch.cuda.synchronize()
    assert count_mask.launches == n0 + 1
    assert torch.equal(counts, counts_p) and torch.equal(mask, mask_p)


@pytest.mark.parametrize("W,S,K,h,B,variant", [
    (13, 997, 37, 1, 300, 1),     # W not a multiple of the 8-word tile
    (8, 997, 140, 2, 129, 1),     # one tile, a partial 128-read round
    (4096, 3578, 140, 1, 40, 1),  # the wide main path's rows
    (64, 500, 300, 3, 130, 1),    # K > 255: 16 planes
    (16, 50, 66000, 1, 2, 1),     # K > 65,535: 32 planes
    (24, 1000, 45, 4, 1, 1),      # h = 4, B = 1
    (40, 20000, 140, 2, 70, 0),   # wide rows too many for shared memory
    (1, 33_554, 140, 1, 1000, 0),  # pass 1's W = 1
    (5, 99_991, 141, 3, 257, 0),  # narrow rows, K not a multiple of 8
    (5, 997, 140, 1, 1, 0),       # B = 1
])
def test_count_mask_variants_match_plain(cuda, W, S, K, h, B, variant):
    """Both K2' variants (1: shared-memory slice, 0: gather) against the
    plain version, on words with bit 31 set, one read whose every window
    is on the sentinel row and one whose windows hit an all-ones row."""
    from kmcp_tpu_torch.kernels._build import get_lib

    assert get_lib().kmcp_count_mask_variant(W, S + 1, h) == variant
    rng = np.random.default_rng(W * 31 + K + h)
    bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
    bits |= np.uint32(1 << 31)
    bits[0] = 0xFFFFFFFF
    bits[-1] = 0
    loc = rng.integers(0, S + 1, (B, K, h)).astype(np.int32)
    loc[0] = S
    if B > 1:
        loc[1] = 0
    thr = rng.integers(0, K + 2, 32 * W).astype(np.int32)
    thr[-3:] = FLOOR_NEVER
    cthr = rng.integers(0, K + 2, B).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in
            (bits.view(np.int32), loc, cthr, thr)]
    counts, mask = count_mask(*args)
    counts_p, mask_p = count_mask_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(counts, counts_p) and torch.equal(mask, mask_p)
    assert not counts[0].any()
    if B > 1:
        assert (counts[1] == K).all() and (mask != 0).any()


def test_count_tail_cuda_matches_cpu(cuda):
    """The whole tail (thresholds, chunked K2', compaction, layout) on the
    card equals the CPU run of the plain versions."""
    rng = np.random.default_rng(3)
    S, W, K, B = 499, 40, 140, 512
    bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
    bits &= rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
    bits[-1] = 0
    arrays = (
        bits.view(np.int32), rng.integers(0, S + 1, (B, K, 1)).astype(np.int32),
        rng.integers(100, 140, B).astype(np.int32),
        rng.integers(120, 160, B).astype(np.int32),
        np.minimum(np.arange(193, dtype=np.int32) // 4 + 30, 192),
        np.full(32 * W, 1, dtype=np.int32),
    )
    outs = []
    for dev in (cuda, torch.device("cpu")):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        outs.append(count_tail(*t, 2048, 30, 256, chunk_reads=100))
    assert outs[0][0][0] > 0
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("S,N", [(3578, 1 << 23), (40, 999_983)])
def test_hash_loc_screen_plane_matches_plain(cuda, S, N):
    reads = _reads(np.random.default_rng(N % 97), 300, 160).to(cuda)
    n0 = hash_loc.launches
    loc, nk, loc_u = hash_loc(reads, 21, S, FULL, 1, screen_sigs=N)
    want = hash_loc_plain(reads, 21, S, FULL, 1, screen_sigs=N)
    torch.cuda.synchronize()
    assert hash_loc.launches == n0 + 1
    for got, exp in zip((loc, nk, loc_u), want):
        assert torch.equal(got, exp)
    assert bool((loc_u == N).any()) and bool((loc_u < N).any())


def _blocks(rng, nb, s_block, W):
    bits = rng.integers(0, 2**32, (nb * s_block + 1, W), dtype=np.uint32)
    bits &= rng.integers(0, 2**32, bits.shape, dtype=np.uint32)
    bits[-1] = 0
    return bits.view(np.int32)


@pytest.mark.parametrize("nb,s_block,W,B,K,P", [
    (3, 40, 128, 64, 12, 96), (5, 101, 1, 70, 140, 333),
    (4, 57, 2, 33, 300, 1),
])
def test_pair_count_kernel_matches_plain(cuda, nb, s_block, W, B, K, P):
    rng = np.random.default_rng(nb * 1000 + W)
    arrays = (
        _blocks(rng, nb, s_block, W),
        rng.integers(0, s_block + 1, (B, K)).astype(np.int32),
        rng.integers(0, B, P).astype(np.int32),
        rng.integers(0, nb, P).astype(np.int32),
        rng.integers(0, K // 3 + 2, B).astype(np.int32),
        np.where(rng.random((nb, 32 * W)) < 0.1, FLOOR_NEVER,
                 rng.integers(0, K // 3 + 2, (nb, 32 * W))).astype(np.int32),
    )
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    n0 = pair_count.launches
    counts, mask = pair_count(*args)
    counts_p, mask_p = pair_count_plain(*args)
    torch.cuda.synchronize()
    assert pair_count.launches == n0 + 1
    assert torch.equal(counts, counts_p) and torch.equal(mask, mask_p)
    assert int(counts.max()) > 0


@pytest.mark.parametrize("nb,s_block,W,B,K,P,empty", [
    (4, 3578, 128, 600, 140, 3000, 2),  # the main path's blocks, > 1 CTA each
    (3, 500, 8, 300, 300, 700, None),   # one tile, K = 300: 16 planes
    (6, 997, 13, 200, 141, 50, 0),      # W not a multiple of 8, few pairs
])
def test_pair_count_slice_matches_plain(cuda, nb, s_block, W, B, K, P, empty):
    """K5''s block-stationary slice variant on unsorted pairs, a block with
    no pairs (``empty``), blocks with more pairs than one CTA's round, words
    with bit 31 set, a read of sentinel windows only and one whose windows
    all hit an all-ones row."""
    from kmcp_tpu_torch.kernels._build import get_lib

    assert get_lib().kmcp_pair_count_variant(W, s_block) == 1
    rng = np.random.default_rng(nb * 100 + W)
    bits = _blocks(rng, nb, s_block, W).view(np.uint32)
    bits[:-1] |= np.uint32(1 << 31)
    bits[0] = 0xFFFFFFFF
    loc = rng.integers(0, s_block + 1, (B, K)).astype(np.int32)
    loc[0] = s_block
    loc[1] = 0
    pg = rng.integers(0, nb, P).astype(np.int32)
    if empty is not None:
        pg[pg == empty] = (empty + 1) % nb
    pg[:2] = 0
    pb = rng.integers(0, B, P).astype(np.int32)
    pb[:2] = (0, 1)
    arrays = (bits.view(np.int32), loc, pb, pg,
              rng.integers(0, K // 3 + 2, B).astype(np.int32),
              np.where(rng.random((nb, 32 * W)) < 0.1, FLOOR_NEVER,
                       rng.integers(0, K // 3 + 2, (nb, 32 * W))
                       ).astype(np.int32))
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    n0 = pair_count.launches
    counts, mask = pair_count(*args)
    counts_p, mask_p = pair_count_plain(*args)
    torch.cuda.synchronize()
    assert pair_count.launches == n0 + 1
    assert torch.equal(counts, counts_p) and torch.equal(mask, mask_p)
    assert not counts[0].any() and (counts[1] == K).all()


def _k6_case(rng, nb, s_block, W, B, K, P, S_pad, cuda):
    """Random blocks (bit 31 set on every word of block 0), locations and
    pairs; read 0 all sentinel windows, read 1 all on row 5 (multiplicity
    K), read 2 half on row 3; FLOOR_NEVER on some floors."""
    bits = _blocks(rng, nb, s_block, W).view(np.uint32)
    bits[:s_block] |= np.uint32(1 << 31)
    bits_t = torch.from_numpy(bits.view(np.int32)).to(cuda)
    loc = rng.integers(0, s_block + 1, (B, K)).astype(np.int32)
    loc[0] = s_block
    loc[1] = 5
    loc[2, ::2] = 3
    pb = rng.integers(0, B, P).astype(np.int32)
    pg = rng.integers(0, nb, P).astype(np.int32)
    pb[:3], pg[:3] = (0, 1, 2), 0
    cthr = rng.integers(0, K // 3 + 2, B).astype(np.int32)
    cthr[1] = K
    cthr[rng.random(B) < 0.1] = FLOOR_NEVER
    thr = np.where(rng.random((nb, 32 * W)) < 0.1, FLOOR_NEVER,
                   rng.integers(0, K // 3 + 2, (nb, 32 * W))).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (loc, pb, pg, cthr, thr)]
    return bits_t, gemm_slabs(bits_t, nb, s_block, S_pad), args


@pytest.mark.parametrize("nb,s_block,W,B,K,P,S_pad", [
    (3, 40, 128, 64, 12, 96, 64),       # one k-step, one partial tile
    (4, 90, 1, 70, 140, 333, 100),      # T = 32; S_pad 100: ragged k-step
    (2, 57, 13, 33, 300, 260, 75),      # T = 416, K = 300: two sweeps
    (5, 3578, 128, 300, 256, 900, 3584),  # the main path's blocks
    (5, 3578, 128, 300, 140, 900, 3584),
    (2, 5000, 16, 200, 140, 300, 5120),   # tall: S in chunks of k-steps
    (2, 9000, 8, 100, 300, 150, 9088),    # tall, two sweeps x three chunks
])
def test_group_count_kernel_matches_plain(cuda, nb, s_block, W, B, K, P,
                                          S_pad):
    """K6' on wgmma against its plain version (U by build_u, float32
    matmul, floors) and against K5''s counts and mask on the same unsorted
    pairs: S_pad not a multiple of 64, T below and not a multiple of 256,
    partial pair tiles and tiles past the last, multiplicity 256 (read 1
    at K = 256), a read of sentinel windows only, FLOOR_NEVER floors, bit 31
    set, K = 300 (two sweeps of windows), and blocks too tall for one
    bucketing of the windows (over 4,096 rows: S swept in chunks)."""
    rng = np.random.default_rng(s_block * 7 + K + P)
    bits, bits01, args = _k6_case(rng, nb, s_block, W, B, K, P, S_pad, cuda)
    n0 = group_count.launches
    got = group_count(bits01, *args, s_block)
    want = group_count_plain(bits01, *args, s_block)
    pair = pair_count(bits, *args)
    torch.cuda.synchronize()
    assert group_count.launches == n0 + 1
    for a, b, c in zip(got, want, pair):
        assert torch.equal(a, b) and torch.equal(a, c)
    counts, mask = got
    assert not counts[0].any() and int(counts[1].max()) == K
    assert bool((mask < 0).any())  # bit 31 of a mask word


@pytest.mark.parametrize("pass2", ["pair", "gemm"])
def test_screened_tail_cuda_matches_cpu(cuda, pass2):
    """The whole screened tail (pass 1, pairs, pass 2 in two chunks,
    compaction, split-id layout) on the card equals its CPU run."""
    rng = np.random.default_rng(7)
    nb, s_block, W, B, K, nu = 6, 300, 4, 512, 140, 4099
    u = rng.integers(0, 2**32, (nu + 1, 1), dtype=np.uint32)
    u[-1] = 0
    arrays = (
        _blocks(rng, nb, s_block, W), u.view(np.int32),
        rng.integers(0, s_block + 1, (B, K)).astype(np.int32),
        rng.integers(0, nu + 1, (B, K)).astype(np.int32),
        rng.integers(100, 140, B).astype(np.int32),
        rng.integers(120, 160, B).astype(np.int32),
        np.minimum(np.arange(193, dtype=np.int32) // 4 + 30, 192),
        rng.integers(60, 80, (nb, 193)).astype(np.int32),
        np.full((nb, 32 * W), 1, dtype=np.int32),
    )
    outs = []
    for dev in (cuda, torch.device("cpu")):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        bits01 = gemm_slabs(t[0], nb, s_block, 320) if pass2 == "gemm" else None
        outs.append(screened_tail(*t, 4096, 30, 256, pass2, bits01,
                                  chunk_pairs=200))
    assert outs[0][0][0] > 0
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("lmax,S,h,N,values", [
    (160, 3578, 1, 0, False),
    (160, 3578, 1, 1 << 25, True),  # the screened path
    (320, 3578, 1, 1 << 25, True),  # paired rows
    (320, 3578, 1, 0, True),  # the paired dense path
    (320, 1_850_000, 3, 0, True),
    (160, 65536, 2, 0, True),
    (96, 2**31 - 1, 4, 0, True),
    (160, 999_983, 1, 999_983, False),
    (12_000, 4099, 4, 0, True),  # no shared-memory staging
])
def test_hash_loc_value_plane_matches_plain(cuda, lmax, S, h, N, values):
    """K1' with and without the value plane, at single-end (160) and
    paired (320) rows, on reads with N runs and lower case."""
    rng = np.random.default_rng(lmax + S % 1000 + h)
    B = 64 if lmax > 1000 else 1000
    mat = _reads(rng, B, lmax).numpy()
    for b in range(0, B, 3):
        p = int(rng.integers(0, lmax))
        mat[b, p : p + 4] = ord("N")
    reads = torch.from_numpy(mat).to(cuda)
    n0 = hash_loc.launches
    got = hash_loc(reads, 21, S, FULL, h, screen_sigs=N, values=values)
    want = hash_loc_plain(reads, 21, S, FULL, h, screen_sigs=N,
                          values=values)
    torch.cuda.synchronize()
    assert hash_loc.launches == n0 + 1
    assert len(got) == len(want) == 2 + bool(N) + values
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got[1].sum()) > 0


def _paired_planes(rng, B, K, mods, thr):
    """Value plane int64 [B, K] from a small pool (duplicates common) and
    location planes that follow it, 15% invalid windows, every other read
    cut to thr - 2 windows."""
    pool = rng.integers(1, 2**62, 40, dtype=np.int64)
    pick = rng.integers(0, 40, (B, K))
    vals = pool[pick]
    invalid = rng.random((B, K)) < 0.15
    invalid |= (np.arange(B)[:, None] % 2 == 0) & (np.arange(K)[None] >= thr - 2)
    vals[invalid] = 0
    locs = []
    for m in mods:
        loc = (pool[pick] % m).astype(np.int32)
        loc[invalid] = m
        locs.append(loc)
    return vals, locs, (~invalid).sum(axis=1).astype(np.int32)


def test_count_tail_in_dedup_cuda_matches_cpu(cuda):
    """The dense tail's paired mode (dedup, then K2') on the card equals
    its CPU run."""
    rng = np.random.default_rng(12)
    S, W, B, K, thr = 3578, 64, 512, 300, 120
    bits = _blocks(rng, 1, S, W)
    vals, (loc,), nk = _paired_planes(rng, B, K, [S], thr)
    arrays = (bits, loc[..., None], nk,
              rng.integers(100, 160, B).astype(np.int32),
              np.minimum(np.arange(K + 1, dtype=np.int32) // 3 + 5, K),
              np.full(32 * W, 1, dtype=np.int32))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in arrays]
        outs.append(count_tail(*t, 1 << 20, 30, thr, chunk_reads=200,
                               in_dedup=True,
                               values=torch.from_numpy(vals).to(dev)))
    assert outs[0][0][0] > 0
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("pass2", ["pair", "gemm"])
def test_screened_tail_in_dedup_cuda_matches_cpu(cuda, pass2):
    """The screened tail's paired mode (both planes uniqued, then pass 1
    and pass 2) on the card equals its CPU run."""
    rng = np.random.default_rng(8)
    nb, s_block, W, B, K, nu, thr = 6, 300, 4, 512, 300, 4099, 120
    u = rng.integers(0, 2**32, (nu + 1, 1), dtype=np.uint32)
    u[-1] = 0
    vals, (loc, loc_u), nk = _paired_planes(rng, B, K, [s_block, nu], thr)
    arrays = (
        _blocks(rng, nb, s_block, W), u.view(np.int32), loc, loc_u, nk,
        rng.integers(120, 160, B).astype(np.int32),
        np.minimum(np.arange(K + 1, dtype=np.int32) // 8 + 10, K),
        rng.integers(2, 6, (nb, K + 1)).astype(np.int32),
        np.full((nb, 32 * W), 1, dtype=np.int32),
    )
    outs = []
    for dev in (cuda, torch.device("cpu")):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in arrays]
        bits01 = gemm_slabs(t[0], nb, s_block, 320) if pass2 == "gemm" else None
        outs.append(screened_tail(*t, 1 << 16, 30, thr, pass2, bits01,
                                  chunk_pairs=200, in_dedup=True,
                                  values=torch.from_numpy(vals).to(dev)))
    assert outs[0][0][0] > 0
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
