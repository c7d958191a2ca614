"""The CUDA kernels on the card against their plain PyTorch versions at
edge shapes the chip smoke does not reach (odd batch sizes, W = 1 and 33,
h = 2 and 4, K past 255, scaled max_hash, k = 31; K1''s screen plane; K5'
and K6' on narrow blocks, ragged S_pad and tiles of zeros), and the count
and screened tails on the card against their CPU runs.  Marked ``cuda``:
they skip without a card and run on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from kmcp_tpu_torch.search.count import count_mask, count_mask_plain
from kmcp_tpu_torch.search.device_step import FLOOR_NEVER, count_tail
from kmcp_tpu_torch.search.group_count import (
    TILE,
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


@pytest.mark.parametrize("nb,S_pad,T,tiles", [
    (3, 64, 4096, 5), (4, 88, 32, 3), (2, 3584, 64, 2), (5, 40, 96, 4),
])
def test_group_count_kernel_matches_plain(cuda, nb, S_pad, T, tiles):
    """Ragged S_pad (88, 40: not multiples of 32), T below the 64-target
    tile (32, 96), a tile of zeros (blk == nb) and multiplicities up to
    256."""
    rng = np.random.default_rng(S_pad + T)
    bits01 = torch.from_numpy(
        (rng.random((nb, S_pad, T)) < 0.4).astype(np.int8)).to(cuda)
    u = rng.integers(0, 4, (tiles * TILE, S_pad)).astype(np.float32)
    u[0, 1] = 256
    u[1, 2] = 200
    u = torch.from_numpy(u).to(torch.bfloat16).to(cuda)
    blk_np = rng.integers(0, nb, tiles).astype(np.int32)
    blk_np[-1] = nb
    blk = torch.from_numpy(blk_np).to(cuda)
    n0 = group_count.launches
    got = group_count(bits01, u, blk)
    want = group_count_plain(bits01, u, blk)
    torch.cuda.synchronize()
    assert group_count.launches == n0 + 1
    assert torch.equal(got, want)
    assert not bool(got[-TILE:].any()) and int(got.max()) > 256


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
