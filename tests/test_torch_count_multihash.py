"""K2' count_mask with the fused row-AND of two hash functions against the
masked Pallas ring kernel (interpret mode); split from test_torch_count.py
so the slow interpret-mode cases spread over test workers."""

import pytest
import torch

from .test_torch_count import RING_SHAPES, check_against_pallas_ring

torch.set_num_threads(1)


@pytest.mark.parametrize("K,W", RING_SHAPES)
def test_count_mask_multihash_matches_pallas_ring(K, W):
    check_against_pallas_ring(K, W, 2)
