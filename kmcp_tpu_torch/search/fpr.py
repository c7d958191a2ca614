"""Query false-positive statistics.

The port's copy of kmcp_tpu/search/fpr.py: Theorem 2 of the Sequence Bloom Tree paper (Solomon & Kingsford,
doi:10.1038/nbt.3442), the probability that >= k of n query k-mers hit a
Bloom filter with per-k-mer FPR p by chance, computed as
``1 - sum_{i<=k} C(n,i) p^i (1-p)^(n-i)`` in the reference's accumulation
order and early-outs, so float results are identical; and the Chernoff
bound that ``utils query-fpr -a`` prints beside it.
"""

from __future__ import annotations

import math
from functools import lru_cache


@lru_cache(maxsize=1 << 20)
def binomial_coeff(n: int, k: int) -> float:
    """C(n, k) with the reference's float semantics: every interleaved
    multiply/divide rounds like an IEEE double op, in the same order."""
    if k > n - k:
        k = n - k
    if k < 0:
        return 0.0
    res = 1.0
    for i in range(k):
        res = res * float(n - i)
        res = res / float(i + 1)
    return res


def query_fpr(n: int, k: int, fpr: float) -> float:
    """P(>= k of n k-mers are false positives)."""
    r = 1.0
    for i in range(k + 1):
        coeff = binomial_coeff(n, i)
        if coeff == math.inf:
            return 0.0
        r -= coeff * math.pow(fpr, float(i)) * math.pow(1.0 - fpr, float(n - i))
        if r < 0:
            return 0.0
    return r


class QueryFPRCache:
    """Memoized query_fpr for a constant per-k-mer FPR.  buf_size: 249
    single-end / 499 paired-end."""

    def __init__(self, fpr: float, buf_size: int = 499):
        self.fpr = fpr
        self.buf_size = buf_size
        self._cache: dict[tuple[int, int], float] = {}

    def __call__(self, n: int, k: int) -> float:
        # the reference caches by (n, min(k, n-k)) index, which merges the
        # k and n-k entries like its triangular buffer
        key = (n, min(k, n - k) if k > n - k else k)
        v = self._cache.get(key)
        if v is None:
            v = query_fpr(n, k, self.fpr)
            self._cache[key] = v
        return v


def chernoff_fpr(p: float, k: float, l: float) -> float:
    """Chernoff upper bound on query FPR."""
    return math.exp(-l * (k - p) * (k - p) / (2.0 * (1.0 - p)))
