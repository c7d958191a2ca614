"""Bloom-filter sizing.

The port's copy of kmcp_tpu/index/sizing.py, cut to what ``index`` and
``utils ref-info`` call (the location derivation lives in
csrc/host/nthash.cpp and, for the object engine, search/kernel.py): the
COBS formula ``ceil(n * (-h / ln(1 - fpr^(1/h))))`` and the actual FPR of
a filter holding fewer elements than it was sized for.
"""

from __future__ import annotations

import math


def calc_signature_size(num_elements: int, num_hashes: int, fpr: float) -> int:
    """Number of Bloom-filter rows for the biggest member of a block."""
    if num_elements == 0:
        num_elements = 1
    ratio = float(-num_hashes) / math.log(1.0 - math.pow(fpr, 1.0 / num_hashes))
    return int(math.ceil(float(num_elements) * ratio))


def calc_fpr(num_elements: int, num_hashes: int, signature_size: int) -> float:
    """Actual FPR of a filter with fewer elements than the sizing maximum."""
    return math.pow(
        1.0 - math.pow(math.e, -num_hashes * float(num_elements) / float(signature_size)),
        float(num_hashes),
    )
