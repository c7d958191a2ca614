"""The CUDA kernels on the card against their plain PyTorch versions at
edge shapes the chip smoke does not reach (odd batch sizes, W = 1 and 33,
h = 2 and 4, K past 255, scaled max_hash, k = 31).  Marked ``cuda``: they
skip without a card and run on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from kmcp_tpu_torch.search.count import count_mask, count_mask_plain
from kmcp_tpu_torch.search.device_step import FLOOR_NEVER, count_tail
from kmcp_tpu_torch.search.hash_loc import hash_loc, hash_loc_plain

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
