"""The object engine's match counter, on the host in NumPy.

The port's copy of ``derive_locations`` and ``count_matches_numpy`` from
kmcp_tpu/search/kernel.py:

    counts[b, t] = sum_k  AND_h bits[ loc(hash[b,k],h) , t ]

a row gather from the bit matrix, an AND-reduce over the ``h`` hash
functions, a bit-unpack along the word axis and a sum over the k-mer axis,
on a padded [B, K] uint64 hash batch with a validity mask.  It serves only
the reads the streamer hands to the object engine (those over the k-mer
dedup threshold); the device path counts with csrc/count_mask.cu.
"""

from __future__ import annotations

import numpy as np


def derive_locations(
    hashes: np.ndarray, num_hashes: int, num_sigs: int
) -> np.ndarray:
    """[B, K] uint64 -> [B, K, h] int64 Bloom row positions, with the
    multi-hash derivation ``loc_i = uint32(hi32 + lo32*i) mod num_sigs``
    (uint32 wraparound)."""
    if num_hashes <= 1:
        return (hashes % np.uint64(num_sigs)).astype(np.int64)[..., None]
    a = (hashes >> np.uint64(32)).astype(np.uint32)
    b = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    i = np.arange(num_hashes, dtype=np.uint32)
    vals = a[..., None] + b[..., None] * i  # uint32 wrap
    return (vals.astype(np.uint64) % np.uint64(num_sigs)).astype(np.int64)


def count_matches_numpy(
    bits: np.ndarray,      # [num_sigs, W] uint32
    hashes: np.ndarray,    # [B, K] uint64 (padded)
    mask: np.ndarray,      # [B, K] bool, True = real k-mer
    num_hashes: int,
) -> np.ndarray:
    """Returns [B, W*32] int32 match counts per target."""
    num_sigs = bits.shape[0]
    loc = derive_locations(hashes, num_hashes, num_sigs)  # [B,K,h]
    rows = bits[loc]  # [B,K,h,W]
    if num_hashes > 1:
        acc = rows[..., 0, :]
        for j in range(1, num_hashes):
            acc = acc & rows[..., j, :]
        rows = acc  # [B,K,W]
    else:
        rows = rows[..., 0, :]
    rows = np.where(mask[..., None], rows, np.uint32(0))
    # unpack words -> bits (little-endian within the uint32 word)
    by = rows.view(np.uint8)  # [B,K,4W] (little-endian platform)
    b_, k_, w4 = by.shape
    unpacked = np.unpackbits(by.reshape(b_ * k_, w4), axis=1, bitorder="little")
    counts = unpacked.reshape(b_, k_, w4 * 8).sum(axis=1, dtype=np.int32)
    return counts
