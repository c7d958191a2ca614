"""K2' count_mask (kmcp_tpu_torch/search/count.py) against the JAX count
paths it ports: the masked Pallas ring kernel
(kmcp_tpu/search/pallas_count.py::make_pallas_count, interpret mode,
compared through its bit-major lane permutation perm_t_of_p) and, for
narrow rows the Pallas kernels do not take, the XLA tail's
device_step._unpack_count.  Counts and masks are integers: compared
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcp_tpu.search.device_step import _unpack_count
from kmcp_tpu.search.pallas_count import (
    make_pallas_count,
    perm_t_of_p,
    thr_table_ring,
)
from kmcp_tpu_torch.search.count import count_mask, count_mask_plain
from kmcp_tpu_torch.search.device_step import FLOOR_NEVER, target_floor

torch.set_num_threads(1)

RING_SHAPES = [(5, 128), (33, 128), (130, 1024)]


def _case(rng, S, W, B, K, h):
    bits = rng.integers(0, 2**32, size=(S + 1, W), dtype=np.uint32)
    bits[-1] = 0  # sentinel row
    loc = rng.integers(0, S + 1, size=(B, K, h)).astype(np.int32)
    T = 32 * W
    tmin = rng.integers(0, K // 2 + 2, T).astype(np.int32)
    sizes_pos = rng.random(T) > 0.05
    cthr = rng.integers(1, K // 2 + 2, B).astype(np.int32)
    cthr[1::5] = FLOOR_NEVER  # excluded reads
    return bits, loc, tmin, sizes_pos, cthr


def _torch_args(bits, loc, tmin, sizes_pos, cthr):
    return (
        torch.from_numpy(bits.view(np.int32)),
        torch.from_numpy(loc),
        torch.from_numpy(cthr),
        torch.from_numpy(target_floor(tmin, sizes_pos)),
    )


@pytest.mark.parametrize("K,W", RING_SHAPES)
def test_count_mask_matches_pallas_ring(K, W):
    check_against_pallas_ring(K, W, 1)


def check_against_pallas_ring(K, W, h, S=61):
    """count_mask vs the masked ring kernel at one grid step, on S rows;
    K > 255 on rows dense enough that counts pass 255 (_dense_case)."""
    rng = np.random.default_rng(K * 1000 + W + h + (S if S != 61 else 0))
    B = max(1, 128 // (W // 8))  # one grid step of the ring kernel
    make = _dense_case if K > 255 else _case
    bits, loc, tmin, sizes_pos, cthr = make(rng, S, W, B, K, h)
    if S != 61 and B == 1:
        cthr[0] = 1  # the per-target floors decide, so both outcomes occur
    perm = perm_t_of_p(W)
    fn = make_pallas_count(K, W, interpret=True, masked=True, num_hashes=h)
    counts_bm, mask_p = fn(
        jnp.asarray(bits).reshape(S + 1, 8, W // 8),
        jnp.asarray(loc[..., 0] if h == 1 else loc),
        jnp.asarray(cthr[:, None]),
        thr_table_ring(jnp.asarray(tmin[perm]), jnp.asarray(sizes_pos[perm]),
                       W),
    )
    want_counts = np.empty((B, 32 * W), dtype=np.int32)
    want_counts[:, perm] = np.asarray(counts_bm)
    # mask word w bit j is lane j*W + w, i.e. target 32 w + j: natural order
    want_mask = np.asarray(mask_p).view(np.int32)

    counts, mask = count_mask(*_torch_args(bits, loc, tmin, sizes_pos, cthr))
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    n_set = int(np.unpackbits(mask.numpy().view(np.uint8)).sum())
    assert 0 < n_set < mask.numel() * 32  # both outcomes occur


def _dense_case(rng, S, W, B, K, h):
    """_case with counts past 255: rows the OR of three uniform words (7/8
    of the bits set), row 0 all ones, every fourth read with a share of its
    windows (up to all of them) on row 0, and floors between 256 and 511
    beside low ones and FLOOR_NEVER."""
    bits, loc, tmin, sizes_pos, cthr = _case(rng, S, W, B, K, h)
    for _ in range(2):
        bits |= rng.integers(0, 2**32, size=bits.shape, dtype=np.uint32)
    bits[0] = 0xFFFFFFFF
    bits[-1] = 0
    share = rng.uniform(0.5, 1.0, B)
    share[::8] = 1.0
    on0 = (rng.random((B, K)) < share[:, None]) & (np.arange(B) % 4 == 0)[
        :, None]
    loc[on0] = 0
    T = 32 * W
    tmin = np.where(rng.random(T) < 0.6, rng.integers(256, 512, T),
                    rng.integers(0, K + 2, T)).astype(np.int32)
    cthr = np.where(rng.random(B) < 0.6, rng.integers(256, 512, B),
                    rng.integers(0, K // 2, B)).astype(np.int32)
    cthr[1::5] = FLOOR_NEVER
    return bits, loc, tmin, sizes_pos, cthr


# K = 130: single-end rows; 256 and 300: counts past 255 (paired rows)
@pytest.mark.parametrize("h,K", [
    pytest.param(1, 130, id="1"), pytest.param(3, 130, id="3"),
    pytest.param(1, 256, id="1-K256"), pytest.param(3, 256, id="3-K256"),
    pytest.param(1, 300, id="1-K300"), pytest.param(3, 300, id="3-K300"),
])
def test_count_mask_narrow_rows_match_unpack_count(h, K):
    """W = 5 (the demo DB's row width) against the XLA tail's gather +
    _unpack_count, the JAX path for rows that narrow; at K = 256 and 300
    on rows dense enough that counts pass 255."""
    check_against_unpack_count(997, 5, 64, K, h,
                               5 + h if K == 130 else K + h)


def check_against_unpack_count(S, W, B, K, h, seed):
    """count_mask vs the XLA tail's gather + _unpack_count on S rows of W
    words; K > 140 on _dense_case's rows."""
    rng = np.random.default_rng(seed)
    make = _case if K <= 140 else _dense_case
    bits, loc, tmin, sizes_pos, cthr = make(rng, S, W, B, K, h)
    jb = jnp.asarray(bits)
    rows = None
    for j in range(h):
        r = jnp.take(jb, jnp.asarray(loc[..., j].T), axis=0)  # [K, B, W]
        rows = r if rows is None else rows & r
    want = np.asarray(_unpack_count(rows))
    counts, mask = count_mask(*_torch_args(bits, loc, tmin, sizes_pos, cthr))
    np.testing.assert_array_equal(counts.numpy(), want)
    floor = np.maximum(target_floor(tmin, sizes_pos)[None, :], cthr[:, None])
    ok = (want >= floor).reshape(B, W, 32).astype(np.uint64)
    want_mask = (ok << np.arange(32, dtype=np.uint64)).sum(axis=2)
    np.testing.assert_array_equal(
        mask.numpy(), want_mask.astype(np.uint32).view(np.int32)
    )
    if K > 255:
        assert (want > 255).any() and (want == K).any()
        n_set = int(np.unpackbits(mask.numpy().view(np.uint8)).sum())
        assert 0 < n_set < mask.numel() * 32
        assert (want[ok.reshape(B, 32 * W) > 0] > 255).any()


def test_count_mask_bit31_words():
    """Words with bit 31 set are negative as int32: every bit, bit 31
    included, must count (ROADMAP A2 dtype trap)."""
    S, W, K, B = 3, 2, 4, 2
    bits = np.zeros((S + 1, W), dtype=np.uint32)
    bits[0] = 0xFFFFFFFF
    bits[1] = 0x80000000
    bits[2] = [0x80000001, 0x7FFFFFFF]
    loc = np.array([[[0], [1], [2], [3]], [[1], [1], [2], [0]]],
                   dtype=np.int32)
    bits_t = torch.from_numpy(bits.view(np.int32))
    thr = torch.ones(32 * W, dtype=torch.int32)
    cthr = torch.tensor([3, 2], dtype=torch.int32)
    counts, mask = count_mask(bits_t, torch.from_numpy(loc), cthr, thr)
    unpacked = (bits[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    want = unpacked[loc[..., 0]].sum(axis=1).reshape(B, 32 * W)
    np.testing.assert_array_equal(counts.numpy(), want)
    assert counts[0, 31] == 3 and counts[1, 31] == 4  # bit 31 of word 0
    ok = (want >= np.array([[3], [2]])).reshape(B, W, 32).astype(np.uint64)
    want_mask = (ok << np.arange(32, dtype=np.uint64)).sum(axis=2)
    np.testing.assert_array_equal(
        mask.numpy(), want_mask.astype(np.uint32).view(np.int32)
    )


def test_count_mask_rejects_bad_input():
    """Out-of-range rows, wrong dtypes and non-CPU/CUDA devices raise."""
    bits = torch.zeros((4, 2), dtype=torch.int32)
    loc = torch.zeros((2, 3, 1), dtype=torch.int32)
    cthr = torch.zeros(2, dtype=torch.int32)
    thr = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        count_mask(bits, loc + 4, cthr, thr)
    with pytest.raises(ValueError):
        count_mask(bits, loc.long(), cthr, thr)
    with pytest.raises(ValueError):
        count_mask_plain(bits, loc.repeat(1, 1, 5), cthr, thr)
    with pytest.raises(ValueError):
        count_mask(bits.to("meta"), loc.to("meta"), cthr.to("meta"),
                   thr.to("meta"))
