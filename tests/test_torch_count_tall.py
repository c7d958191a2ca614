"""K2' count_mask on rows past the slice counter's widest tile: 4,100 and
16,000 rows, the counterpart of the JAX package's resident row groups and
its DMA-ring kernel at production row counts (the port's narrower slice
tiles and row ring, whose plain version the CPU runs).  Against the masked
Pallas ring kernel (kmcp_tpu/search/pallas_count.py::make_pallas_count,
interpret mode, one grid step) where its interpret-mode build stays under
a minute (one read a grid step, W = 1,024, one hash; it unrolls K x
reads x hashes DMAs: three hashes build in about 50 s on one CPU core
at K = 140, 100 s at K = 300), and against the XLA tail's gather + _unpack_count at every width
of RING_SHAPES, one and three hashes, K = 140 and 300.  Split from
test_torch_count.py so the slow interpret-mode builds spread over test
workers."""

import pytest
import torch

from .test_torch_count import (
    RING_SHAPES,
    check_against_pallas_ring,
    check_against_unpack_count,
)

torch.set_num_threads(1)

TALL_ROWS = (4100, 16_000)


@pytest.mark.parametrize("K", [140, 300])
@pytest.mark.parametrize("S", TALL_ROWS)
def test_count_mask_tall_rows_match_pallas_ring(S, K):
    check_against_pallas_ring(K, 1024, 1, S)


@pytest.mark.parametrize("W", sorted({w for _, w in RING_SHAPES}))
@pytest.mark.parametrize("K", [140, 300])
@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("S", TALL_ROWS)
def test_count_mask_tall_rows_match_unpack_count(S, h, K, W):
    check_against_unpack_count(S, W, 16, K, h, S + 10 * h + K + W)
