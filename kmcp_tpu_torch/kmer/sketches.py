"""K-mer sketch generators: FracMinHash scaling, minimizers, closed syncmers.

The port's copy of kmcp_tpu/kmer/sketches.py:

- FracMinHash ("scaled minhash"): keep canonical ntHash values
  ``h <= floor(float(2^64-1) / scale)`` (the float round-trip replicates
  the reference's ``uint64(float64(^uint64(0)) / float64(scale))``).
- Minimizer sketch: minimum canonical k-mer hash over every window of
  ``w`` consecutive k-mers, consecutive duplicates (same chosen position)
  emitted once.
- Closed syncmer: a k-mer is selected when the minimum s-mer hash within it
  sits at the first or last s-mer position.

All generators drop hash value 0.
"""

from __future__ import annotations

import numpy as np

from .nthash import hash_all, hash_windows

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def max_hash_for_scale(scale: int) -> np.uint64:
    """Replicates Go's ``uint64(float64(^uint64(0)) / float64(scale))``."""
    if scale <= 1:
        return U64_MAX
    f = np.float64(18446744073709551615) / np.float64(scale)
    return np.uint64(f)


def scale_filter(hashes: np.ndarray, scale: int) -> np.ndarray:
    """FracMinHash down-sampling: keep ``h <= max_hash``."""
    if scale <= 1:
        return hashes
    return hashes[hashes <= max_hash_for_scale(scale)]


def _sliding_min(values: np.ndarray, w: int) -> tuple[np.ndarray, np.ndarray]:
    """(min, argmin-first-index) for each length-w window of ``values``."""
    view = np.lib.stride_tricks.sliding_window_view(values, w)
    am = view.argmin(axis=1)
    mn = view[np.arange(view.shape[0]), am]
    return mn, am + np.arange(view.shape[0])


def hash_kmers(
    seq,
    k: int,
    canonical: bool = True,
    circular: bool = False,
    scale: int = 1,
) -> np.ndarray:
    """Plain k-mer hashing + scaling + drop-zero (the non-sketch path)."""
    h, _ = hash_all(seq, k, canonical=canonical, circular=circular)
    h = scale_filter(h, scale)
    return h[h > 0]


def minimizer_sketch(
    seq,
    k: int,
    w: int,
    circular: bool = False,
    scale: int = 1,
) -> np.ndarray:
    """Minimizer sketch: min canonical hash per window of w k-mers."""
    _, _, can, valid = hash_windows(seq, k, circular=circular)
    n = can.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    if n < w:
        # Whole sequence shorter than one window: single window over what
        # exists (skip if any invalid k-mer present).
        if valid.all():
            mins = np.array([can.min()], dtype=np.uint64)
        else:
            mins = np.empty(0, dtype=np.uint64)
    else:
        # Invalid k-mers never win the minimum.
        vals = np.where(valid, can, U64_MAX)
        mn, am = _sliding_min(vals, w)
        # Keep one emission per distinct chosen position.
        keep = np.empty(mn.shape[0], dtype=bool)
        keep[0] = True
        keep[1:] = am[1:] != am[:-1]
        ok = mn != U64_MAX  # window entirely invalid otherwise
        mins = mn[keep & ok]
    mins = scale_filter(mins, scale)
    return mins[mins > 0]


def closed_syncmer_sketch(
    seq,
    k: int,
    s: int,
    circular: bool = False,
    scale: int = 1,
) -> np.ndarray:
    """Closed syncmer sketch: a k-mer is kept when the minimum canonical
    s-mer hash within it lies at offset 0 or k-s (value-based
    comparison)."""
    fh, rh, can_k, valid_k = hash_windows(seq, k, circular=circular)
    nk = can_k.shape[0]
    if nk == 0 or s > k:
        return np.empty(0, dtype=np.uint64)
    _, _, can_s, valid_s = hash_windows(seq, s, circular=circular)
    w = k - s + 1  # number of s-mers per k-mer
    vals = np.where(valid_s, can_s, U64_MAX)
    view = np.lib.stride_tricks.sliding_window_view(vals, w)[:nk]
    mn = view.min(axis=1)
    first = vals[:nk]
    last = vals[w - 1 : w - 1 + nk]
    sel = valid_k & ((mn == first) | (mn == last))
    out = can_k[sel]
    out = scale_filter(out, scale)
    return out[out > 0]


def generate_kmers(
    seq,
    k: int,
    canonical: bool = True,
    circular: bool = False,
    scale: int = 1,
    minimizer_w: int = 0,
    syncmer_s: int = 0,
) -> np.ndarray:
    """Dispatch on the sketch type."""
    if syncmer_s > 0:
        return closed_syncmer_sketch(seq, k, syncmer_s, circular, scale)
    if minimizer_w > 0:
        return minimizer_sketch(seq, k, minimizer_w, circular, scale)
    return hash_kmers(seq, k, canonical, circular, scale)


def unique_sorted(hashes: np.ndarray) -> np.ndarray:
    """Sort + dedup.  Large arrays route through the parallel native
    radix-bucket sort."""
    # crossover at ~1M: below, numpy's cache-resident sort wins
    if len(hashes) >= 1 << 20:
        from . import native

        return native.sort_unique(hashes)
    return np.unique(hashes)
