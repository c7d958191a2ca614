"""The CUDA kernels on the card against their plain PyTorch versions at
edge shapes the chip smoke does not reach (odd batch sizes, W = 1 and 33,
h = 2 and 4, K past 255, scaled max_hash, k = 31; every K2' and K5'
variant, the slice tile's last row and the next, rows to 2^17; K1''s
screen plane; K5' on narrow and wide blocks, unsorted pairs, empty and
crowded blocks; K6'
at ragged S_pad and T, partial and padding tiles, multiplicity 256,
sentinel-only reads, FLOOR_NEVER floors, bit 31 and two sweeps; K1''s
value plane at single-end and paired row lengths, every modulus path and
rows too long to stage in shared memory), the count and screened tails,
single-end and paired (in_dedup), a sketch DB's window selection after
K1' and the object engine's TorchBlockCounter (K2' on short, wide, folded
and -g rows), on the card against their CPU runs, the multi-rank
dry run on the card (a world of one rank on nccl, two ranks sharing the
card over gloo) against the single-device run, K5' and K6' on pair lists
padded as the screened tail pads them, and the streamer with batches in
flight (every tail flushed under ``set_sync_debug_mode("error")``, whole
runs at depths 1 and 4) against its CPU run, host-hashed batches
(``KMCP_TPU_DEVICE_HASH=0``) likewise, and locations outside the table
raising at ``result()`` with no fault on the card.  Marked ``cuda``:
they skip without a card and run on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from kmcp_tpu_torch.search.count import count_mask, count_mask_plain
from kmcp_tpu_torch.search.device import _copy_async
from kmcp_tpu_torch.search.device_step import (
    FLOOR_NEVER,
    count_tail,
    count_tail_async,
)
from kmcp_tpu_torch.search.group_count import (
    gemm_slabs,
    group_count,
    group_count_plain,
)
from kmcp_tpu_torch.search.hash_loc import hash_loc, hash_loc_plain
from kmcp_tpu_torch.search.pair_count import pair_count, pair_count_plain
from kmcp_tpu_torch.search.screen import screened_tail, screened_tail_async

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


def _near_255(rng, words, K, h):
    """For 255 <= K <= 512 (the 9-plane counter and its edges): ORs
    uniform words into ``words`` until a read's count of a target, the AND
    of h rows over K windows, sits past 255 (or at K = 256, mostly at 256)."""
    if not 255 <= K <= 512:
        return
    for _ in range(12):
        sample = np.unpackbits(words.ravel()[:1 << 16].view(np.uint8))
        if float(sample.mean()) ** h * K >= 262:
            break
        words |= rng.integers(0, 2**32, words.shape, dtype=np.uint32)


def _floors_past_255(rng, thr, cthr, K):
    """Half the floors between 256 and 511 and some reads FLOOR_NEVER, for
    the cases _near_255 makes dense."""
    if not 255 <= K <= 512:
        return
    for f in (thr, cthr):
        f[:] = np.where(rng.random(f.shape) < 0.5,
                        rng.integers(256, 512, f.shape), f)
    cthr[2::7] = FLOOR_NEVER


@pytest.mark.parametrize("W,S,K,h,B,variant", [
    (13, 997, 37, 1, 300, "slice"),     # W not a multiple of the 8-word tile
    (8, 997, 140, 2, 129, "slice"),     # one tile, a partial 128-read round
    (4096, 3578, 140, 1, 40, "slice"),  # the wide main path's rows
    (64, 500, 300, 3, 130, "slice"),    # K = 300, h = 3: 9 planes
    (16, 50, 66000, 1, 2, "slice"),     # K > 65,535: 32 planes
    (24, 1000, 45, 4, 1, "slice"),      # h = 4, B = 1
    (40, 20000, 140, 2, 70, "ring"),    # wide rows too many for a tile, h = 2
    (1, 33_554, 140, 1, 1000, "gather"),  # pass 1's W = 1
    (5, 99_991, 141, 3, 257, "gather"),  # narrow rows, K not a multiple of 8
    (5, 997, 140, 1, 1, "gather"),      # B = 1
    (256, 997, 255, 1, 200, "slice"),   # K = 255: the last of 8 planes
    (64, 997, 256, 1, 300, "slice"),    # K = 256: the first of 9 planes
    (4096, 3578, 300, 1, 300, "slice"),  # the paired dense tail's rows
    (16, 997, 300, 2, 129, "slice"),    # K = 300, h = 2, a partial round
    (40, 3000, 511, 1, 200, "slice"),   # K = 511: the last of 9 planes
    (24, 997, 511, 4, 64, "slice"),     # K = 511, h = 4
    (64, 500, 512, 1, 70, "slice"),     # K = 512: 16 planes
    (1, 33_554, 300, 1, 1000, "gather"),  # paired pass 1's W = 1
    (5, 99_991, 300, 3, 257, "gather"),  # narrow rows, K = 300
    # past the former switch (4,053 rows and the sentinel at h = 1), the
    # tile's last row and the next (5,077 at h = 1 and 2, 4,053 at h = 3),
    # and rows to 2^17 on the ring
    (128, 4053, 140, 1, 300, "slice"), (128, 4054, 140, 1, 300, "slice"),
    (128, 5077, 140, 1, 300, "slice"), (128, 5078, 140, 1, 300, "ring"),
    (13, 5077, 300, 2, 129, "slice"), (13, 5078, 300, 2, 129, "ring"),
    (128, 4053, 511, 3, 130, "slice"), (128, 4054, 511, 3, 130, "ring"),
    (8, 16_000, 140, 1, 1000, "ring"),   # one tile's width, 16 reads a round
    (4096, 16_000, 140, 1, 64, "ring"),  # the TPU's row-group range
    (4096, 16_000, 300, 2, 40, "ring"),
    (4096, 1 << 17, 140, 1, 40, "ring"),  # tall rows, 512-word spans
    (128, 1 << 17, 300, 1, 600, "ring"),  # one span a row, 4 reads a round
    (1024, 1 << 17, 140, 3, 64, "ring"),  # a multi-hash wide DB
    (8, 1 << 17, 300, 3, 300, "ring"),
    (13, 1 << 17, 511, 4, 129, "ring"),  # 4-byte copies, h = 4
    (40, 20000, 600, 1, 70, "ring"),    # K = 600: 16 planes in the ring
])
def test_count_mask_variants_match_plain(cuda, W, S, K, h, B, variant):
    """Every K2' variant (geometry.cuh: the gather, the slice, the row
    ring) against the plain version, on words
    with bit 31 set, one read whose every window is on the sentinel row and
    one whose windows hit an all-ones row; for K from 255 to 512 on rows
    dense enough that most counts pass 255, with floors past 255; the
    launch counted under its variant."""
    from kmcp_tpu_torch.search.count import count_mask_variant

    assert count_mask_variant(W, S + 1, h) == variant
    rng = np.random.default_rng(W * 31 + K + h)
    bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
    _near_255(rng, bits, K, h)
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
    _floors_past_255(rng, thr, cthr, K)
    args = [torch.from_numpy(a).to(cuda) for a in
            (bits.view(np.int32), loc, cthr, thr)]
    n0 = count_mask.by_variant[variant]
    counts, mask = count_mask(*args)
    counts_p, mask_p = count_mask_plain(*args)
    torch.cuda.synchronize()
    assert count_mask.by_variant[variant] == n0 + 1
    assert torch.equal(counts, counts_p) and torch.equal(mask, mask_p)
    assert not counts[0].any()
    if B > 1:
        assert (counts[1] == K).all() and (mask != 0).any()
    if 256 <= K <= 512:
        assert float((counts[2:] > 255).float().mean()) > 0.5


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


@pytest.mark.parametrize("nb,s_block,W,B,K,P,empty,variant", [
    # the main path's blocks, > 1 CTA each
    (4, 3578, 128, 600, 140, 3000, 2, "slice"),
    (3, 500, 8, 300, 300, 700, None, "slice"),  # one tile, K = 300: 9 planes
    (6, 997, 13, 200, 141, 50, 0, "slice"),  # W not a multiple of 8, few pairs
    # the paired screened tail's blocks
    (4, 3578, 128, 600, 300, 3000, 1, "slice"),
    (2, 997, 16, 100, 511, 300, None, "slice"),  # K = 511: the last of 9 planes
    # past the former switch, the tile's last row and the next, tall blocks
    (3, 4053, 128, 300, 140, 900, None, "slice"),
    (3, 4054, 128, 300, 140, 900, 2, "slice"),
    (2, 5077, 128, 300, 300, 900, None, "slice"),
    (2, 5078, 128, 300, 300, 900, None, "ring"),
    (3, 16_000, 128, 600, 140, 3000, 1, "ring"),  # the TPU's K5 slab range
    (2, 16_000, 13, 200, 511, 400, None, "ring"),
    (2, 33_524, 8, 300, 300, 700, None, "ring"),
    (4, 1 << 17, 128, 600, 140, 3000, 3, "ring"),
    (3, 1 << 17, 128, 600, 300, 3000, None, "ring"),
    (3, 1 << 17, 13, 200, 511, 500, 0, "ring"),  # 4-byte copies
    (2, 1 << 17, 40, 100, 600, 200, None, "ring"),  # K = 600: 16 planes
])
def test_pair_count_slice_matches_plain(cuda, nb, s_block, W, B, K, P, empty,
                                        variant):
    """K5''s block-stationary variants (the slice, the row ring) on
    unsorted pairs, a block with no pairs (``empty``), blocks
    with more pairs than one CTA's round, words with bit 31 set, a read of
    sentinel windows only and one whose windows all hit an all-ones row."""
    from kmcp_tpu_torch.search.pair_count import pair_count_variant

    assert pair_count_variant(W, s_block) == variant
    rng = np.random.default_rng(nb * 100 + W + (K if K > 255 else 0))
    bits = _blocks(rng, nb, s_block, W).view(np.uint32)
    _near_255(rng, bits, K, 1)
    bits[-1] = 0  # the sentinel row
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
    cthr = rng.integers(0, K // 3 + 2, B).astype(np.int32)
    thr = np.where(rng.random((nb, 32 * W)) < 0.1, FLOOR_NEVER,
                   rng.integers(0, K // 3 + 2, (nb, 32 * W))).astype(np.int32)
    _floors_past_255(rng, thr, cthr, K)
    arrays = (bits.view(np.int32), loc, pb, pg, cthr, thr)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    n0 = pair_count.by_variant[variant]
    counts, mask = pair_count(*args)
    counts_p, mask_p = pair_count_plain(*args)
    torch.cuda.synchronize()
    assert pair_count.by_variant[variant] == n0 + 1
    assert torch.equal(counts, counts_p) and torch.equal(mask, mask_p)
    assert not counts[0].any() and (counts[1] == K).all()
    if 255 < K <= 512:  # _near_255's rows
        assert float((counts[2:] > 255).float().mean()) > 0.5


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


@pytest.mark.parametrize("tail", ["dense", "pair", "gemm"])
def test_bad_rows_raise_at_result_on_card(cuda, tail):
    """A location plane with rows far outside its table (2^30 and -7)
    dispatches, its kernels read only clamped rows, and the handle raises
    check_rows's ValueError at ``result()``; the card has no fault after
    it: the same tail on good rows then equals its CPU run."""
    rng = np.random.default_rng(11)
    B, K = 256, 140
    if tail == "dense":
        S, W = 499, 40
        bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
        bits[-1] = 0
        arrays = (bits.view(np.int32),
                  rng.integers(0, S + 1, (B, K, 1)).astype(np.int32),
                  rng.integers(100, 140, B).astype(np.int32),
                  rng.integers(120, 160, B).astype(np.int32),
                  np.minimum(np.arange(193, dtype=np.int32) // 4 + 30, 192),
                  np.full(32 * W, 1, dtype=np.int32))
        n_rows, bad_plane = S + 1, 1

        def run(t):
            return count_tail_async(*t, 2048, 30, 256, chunk_reads=100)
    else:
        nb, s_block, W, nu = 6, 300, 4, 4099
        u = rng.integers(0, 2**32, (nu + 1, 1), dtype=np.uint32)
        u[-1] = 0
        arrays = (_blocks(rng, nb, s_block, W), u.view(np.int32),
                  rng.integers(0, s_block + 1, (B, K)).astype(np.int32),
                  rng.integers(0, nu + 1, (B, K)).astype(np.int32),
                  rng.integers(100, 140, B).astype(np.int32),
                  rng.integers(120, 160, B).astype(np.int32),
                  np.minimum(np.arange(193, dtype=np.int32) // 4 + 30, 192),
                  rng.integers(60, 80, (nb, 193)).astype(np.int32),
                  np.full((nb, 32 * W), 1, dtype=np.int32))
        n_rows, bad_plane = s_block + 1, 2

        def run(t):
            bits01 = (gemm_slabs(t[0], nb, s_block, 320) if tail == "gemm"
                      else None)
            return screened_tail_async(*t, 4096, 30, 256, tail, bits01)
    bad = [a.copy() for a in arrays]
    bad[bad_plane].reshape(-1)[5] = 2**30
    bad[bad_plane].reshape(-1)[-3] = -7
    handle = _copy_async(run([torch.from_numpy(a).to(cuda) for a in bad]))
    msg = rf"loc holds rows -7\.\.{2**30} outside 0\.\.{n_rows - 1}"
    with pytest.raises(ValueError, match=msg):
        handle.result()
    torch.cuda.synchronize()
    got = _copy_async(run([torch.from_numpy(a).to(cuda) for a in arrays]))
    want = _copy_async(run([torch.from_numpy(a) for a in arrays]))
    for a, b in zip(got.result(), want.result()):
        np.testing.assert_array_equal(a, b)


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


@pytest.mark.parametrize("kind,param,max_hash,h", [
    ("minimizer", 5, FULL, 1), ("minimizer", 15, FULL // 3, 3),
    ("syncmer", 11, FULL, 1), ("syncmer", 5, FULL // 2, 2),
])
def test_sketch_transform_on_card_matches_cpu(cuda, kind, param, max_hash,
                                              h):
    """A sketch DB's streaming selection on the card (K1' at k with values,
    at k = s for syncmers, then sketch_transform) equals the same calls on
    the CPU (the plain versions), with K1' launched once, twice for
    syncmers."""
    from kmcp_tpu_torch.search.hash_loc import _U64
    from kmcp_tpu_torch.search.sketch_device import sketch_transform

    rng = np.random.default_rng(param + h)
    k, S = 21, 3578
    reads = _reads(rng, 1000, 160)
    lens = (reads != 0).sum(dim=1).to(torch.int32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        hash_loc.launches = 0
        r = reads.to(dev)
        loc, _nk, vals = hash_loc(r, k, S, _U64, h, values=True)
        s_vals = (hash_loc(r, param, 1, _U64, 1, values=True)[2]
                  if kind == "syncmer" else None)
        outs.append([t.cpu() for t in sketch_transform(
            kind, k, param, S, max_hash, loc, vals, s_vals, lens.to(dev))])
        if dev.type == "cuda":
            assert hash_loc.launches == (2 if kind == "syncmer" else 1)
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    assert 0 < int(outs[0][1].sum()) < 1000 * 140


@pytest.mark.parametrize("W,h,B,K", [
    (5, 3, 300, 130), (130, 1, 2100, 160), (4, 1, 3, 1000),
    (8, 3, 1, 262_150),
])
def test_block_counter_on_card_matches_cpu(cuda, W, h, B, K):
    """The object engine's TorchBlockCounter launches K2' on the card and
    equals its CPU run (K2''s plain version) and the NumPy counter: short
    rows, a wide block, rows folded into pseudo-rows, one -g row."""
    from kmcp_tpu_torch.search.kernel import (
        TorchBlockCounter,
        count_matches_numpy,
    )

    rng = np.random.default_rng(W + K)
    S = 4001
    bits = (rng.integers(0, 2**32, (S, W), dtype=np.uint32)
            & rng.integers(0, 2**32, (S, W), dtype=np.uint32))
    hashes = rng.integers(0, 2**64, (B, K), dtype=np.uint64)
    mask = np.arange(K)[None, :] < rng.integers(0, K + 1, B)[:, None]
    mask[0] = True
    count_mask.launches = 0
    got = TorchBlockCounter(bits, h, cuda)(hashes, mask)
    assert count_mask.launches > 0
    np.testing.assert_array_equal(
        got, TorchBlockCounter(bits, h, "cpu")(hashes, mask))
    if B * K <= 300 * 1000:
        np.testing.assert_array_equal(
            got, count_matches_numpy(bits, hashes, mask, h))
    assert got[0].sum() > 0


@pytest.mark.parametrize("n_ranks,backend", [(1, "nccl"), (2, "gloo")])
def test_sharded_dryrun_on_card(cuda, n_ranks, backend):
    """The multi-rank dry run on the card: a world of one rank on nccl
    (mesh (1, 1)) and two ranks sharing the card over gloo (mesh (1, 2)),
    every configuration byte-identical to the single-device run on the
    card and equal to the host oracle."""
    from kmcp_tpu_torch.parallel.dryrun import dryrun_multichip

    lines = dryrun_multichip(n_ranks, device="cuda:0", backend=backend,
                             timeout_s=600)
    assert [ln.split(":")[0] for ln in lines] == [f"mesh(d=1,t={n_ranks})"]


@pytest.mark.parametrize("W,s_block", [(128, 3578), (1, 101), (128, 16_000),
                                       (128, 1 << 17)])
def test_padding_pairs_match_plain(cuda, W, s_block):
    """A pair list padded as ``screen.pair_list`` leaves it (pb = B - 1,
    pg = nb): K5' (the slice at W = 128 and 3,578 rows, the row ring at
    16,000 and 2^17, the gather at W = 1) and K6' give padding rows a zero
    mask and the real rows the plain versions' counts and mask, and the
    unpadded launch's."""
    from kmcp_tpu_torch.search.group_count import s_pad_for

    rng = np.random.default_rng(W)
    nb, B, K, P, pad = 4, 300, 140, 900, 700
    bits = torch.from_numpy(_blocks(rng, nb, s_block, W)).to(cuda)
    loc = rng.integers(0, s_block + 1, (B, K)).astype(np.int32)
    flat = np.sort(rng.choice(B * nb, size=P, replace=False))
    pb = np.r_[flat // nb, np.full(pad, B - 1)].astype(np.int32)
    pg = np.r_[flat % nb, np.full(pad, nb)].astype(np.int32)
    cthr = rng.integers(0, K // 3 + 2, B).astype(np.int32)
    thr = np.where(rng.random((nb, 32 * W)) < 0.1, FLOOR_NEVER,
                   rng.integers(0, K // 3 + 2, (nb, 32 * W))).astype(np.int32)
    loc_t, pb_t, pg_t, cthr_t, thr_t = (torch.from_numpy(a).to(cuda) for a
                                        in (loc, pb, pg, cthr, thr))
    bits01 = gemm_slabs(bits, nb, s_block, s_pad_for(s_block))
    runs = {
        "pair": lambda b, g, plain=False: (pair_count_plain if plain else
                                           pair_count)(
            bits, loc_t, b, g, cthr_t, thr_t),
        "gemm": lambda b, g, plain=False: (group_count_plain if plain else
                                           group_count)(
            bits01, loc_t, b, g, cthr_t, thr_t, s_block),
    }
    for name, run in runs.items():
        counts, mask = run(pb_t, pg_t)
        counts_p, mask_p = run(pb_t, pg_t, plain=True)
        counts_u, mask_u = run(pb_t[:P], pg_t[:P])
        torch.cuda.synchronize()
        assert torch.equal(mask, mask_p) and not mask[P:].any(), name
        assert torch.equal(counts[:P], counts_p[:P]), name
        assert torch.equal(counts[:P], counts_u), name
        assert torch.equal(mask[:P], mask_u) and mask_u.any(), name


def _port_db(root, genomes, num_hashes=1, **index_kw):
    """The port's own compute (k = 21, 3 chunks a genome) + tpu-native
    index of FASTA genomes; ``index_kw`` e.g. a block screen."""
    from kmcp_tpu_torch.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu_torch.index.build import run_index

    root.mkdir(parents=True, exist_ok=True)
    files = []
    for g, seq in enumerate(genomes):
        p = root / f"g{g}.fa"
        p.write_text(f">g{g}\n{seq.decode()}\n")
        files.append(str(p))
    sketch = {k: index_kw.pop(k) for k in ("minimizer_w",) if k in index_kw}
    run_compute(out_dir=str(root / "ks"), files=files,
                opt=ComputeOptions(ks=[21], split_number=3, split_overlap=100,
                                   **sketch), force=True, verbose=False)
    run_index(in_dir=str(root / "ks"), out_dir=str(root / "db"),
              num_hashes=num_hashes, fpr=0.3, force=True, tpu_native=True,
              verbose=False, **index_kw)
    return str(root / "db")


def _stream_reads(rng, genomes, n, paired):
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    out = []
    for i in range(n):
        g = genomes[i % len(genomes)]
        p = int(rng.integers(0, len(g) - 400))
        r2 = g[p + 200 : p + 350].translate(rc)[::-1] if paired else None
        out.append((f"r{i}", g[p : p + 150], r2))
    return out


def test_inflight_stream_on_card(cuda, tmp_path, monkeypatch):
    """Batches in flight on the card: one batch of every tail (dense,
    three hashes, paired dense, screened on K5' and K6', paired screened,
    a minimizer DB) flushed under ``set_sync_debug_mode("error")`` raises
    nothing, and drains to the CPU run's bytes; whole runs of 256-read
    batches at depths 1 and 4 write the CPU run's TSV."""
    import io

    from kmcp_tpu_torch.search import stream
    from kmcp_tpu_torch.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu_torch.search.stream import TorchStreamSearcher

    monkeypatch.setattr(stream, "MIN_BATCH", 256)
    rng = np.random.default_rng(9)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = [rng.choice(bases, size=30000).tobytes() for _ in range(4)]
    dbs = {
        "dense": _port_db(tmp_path / "d1", genomes),
        "three": _port_db(tmp_path / "d3", genomes, num_hashes=3),
        "screened": _port_db(tmp_path / "s", genomes, native_block_targets=4,
                             block_screen=True, uniform_sigs=True),
        "sketch": _port_db(tmp_path / "m", genomes, minimizer_w=5),
    }
    tails = [("dense", "auto", False), ("three", "auto", False),
             ("dense", "auto", True), ("screened", "pair", False),
             ("screened", "gemm", False), ("screened", "pair", True),
             ("sketch", "auto", False)]
    single = _stream_reads(rng, genomes, 1100, False)
    pairs = _stream_reads(rng, genomes, 1100, True)

    def streamer(name, pass2, paired, dev, depth=4):
        opt = SearchOptions(batch_size=256, paired_fpr_buf=paired)
        return TorchStreamSearcher(SearchEngine([dbs[name]], opt, dev), dev,
                                   pass2, in_flight=depth)

    def tsv(st, reads, paired):
        buf = io.StringIO()
        st.run(iter(reads), buf, paired=paired)
        return buf.getvalue()

    cpu = torch.device("cpu")
    sts = [streamer(n, p2, pd, cuda) for n, p2, pd in tails]
    states = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for st, (_n, _p2, paired) in zip(sts, tails):
            reads = pairs if paired else single
            states.append(st._flush(reads[:256], 256, 0, paired))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for st, state, (name, p2, paired) in zip(sts, states, tails):
        fmt = (stream._fmt_ratio_memo(), stream._fmt_ratio_memo(), {})
        got, want = io.StringIO(), io.StringIO()
        st._drain(state, got, fmt)
        reads = (pairs if paired else single)[:256]
        want = tsv(streamer(name, p2, paired, cpu), reads, paired)
        assert got.getvalue() == want, (name, p2, paired)
    for name, p2, paired in tails:
        reads = pairs if paired else single
        want = tsv(streamer(name, p2, paired, cpu), reads, paired)
        for depth in (1, 4):
            got = tsv(streamer(name, p2, paired, cuda, depth), reads, paired)
            assert got == want, (name, p2, paired, depth)


def test_host_hash_stream_on_card(cuda, tmp_path, monkeypatch):
    """Host hashing on the card (``KMCP_TPU_DEVICE_HASH=0``): one batch of
    the dense and three-hash DBs, single-end and paired, hashed by the C++
    into pinned memory and flushed under ``set_sync_debug_mode("error")``,
    raises nothing and drains to the CPU run's bytes; whole runs of
    256-read batches at depths 1 and 4 write the CPU run's TSV, which is
    also the device-hash run's."""
    import io

    from kmcp_tpu_torch.search import stream
    from kmcp_tpu_torch.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu_torch.search.stream import TorchStreamSearcher

    monkeypatch.setattr(stream, "MIN_BATCH", 256)
    monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", "0")
    rng = np.random.default_rng(10)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = [rng.choice(bases, size=30000).tobytes() for _ in range(4)]
    dbs = {"dense": _port_db(tmp_path / "d1", genomes),
           "three": _port_db(tmp_path / "d3", genomes, num_hashes=3)}
    cases = [("dense", False), ("three", False), ("dense", True)]
    single = _stream_reads(rng, genomes, 1100, False)
    pairs = _stream_reads(rng, genomes, 1100, True)

    def streamer(name, paired, dev, depth=4):
        opt = SearchOptions(batch_size=256, paired_fpr_buf=paired)
        return TorchStreamSearcher(SearchEngine([dbs[name]], opt, dev), dev,
                                   in_flight=depth)

    def tsv(st, reads, paired):
        buf = io.StringIO()
        st.run(iter(reads), buf, paired=paired)
        return buf.getvalue()

    cpu = torch.device("cpu")
    sts = [streamer(n, pd, cuda) for n, pd in cases]
    assert all(st.host_hash for st in sts)
    states = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for st, (_n, paired) in zip(sts, cases):
            reads = pairs if paired else single
            states.append(st._flush(reads[:256], 256, 0, paired))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for st, state, (name, paired) in zip(sts, states, cases):
        fmt = (stream._fmt_ratio_memo(), stream._fmt_ratio_memo(), {})
        got = io.StringIO()
        st._drain(state, got, fmt)
        reads = (pairs if paired else single)[:256]
        want = tsv(streamer(name, paired, cpu), reads, paired)
        assert got.getvalue() == want, (name, paired)
    for name, paired in cases:
        reads = pairs if paired else single
        want = tsv(streamer(name, paired, cpu), reads, paired)
        for depth in (1, 4):
            got = tsv(streamer(name, paired, cuda, depth), reads, paired)
            assert got == want, (name, paired, depth)
        monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", "1")
        assert tsv(streamer(name, paired, cuda), reads, paired) == want
        monkeypatch.setenv("KMCP_TPU_DEVICE_HASH", "0")
