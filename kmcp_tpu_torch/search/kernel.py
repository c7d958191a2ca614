"""The object engine's match counter.

The port's copy of ``derive_locations`` and ``count_matches_numpy`` from
kmcp_tpu/search/kernel.py, and ``TorchBlockCounter``, the counterpart of
its ``JaxBlockCounter`` (:145, with ``make_jax_counter`` :79 and
``make_jax_counter_genome`` :112):

    counts[b, t] = sum_k  AND_h bits[ loc(hash[b,k],h) , t ]

a row gather from the bit matrix, an AND-reduce over the ``h`` hash
functions, a bit-unpack along the word axis and a sum over the k-mer axis,
on a padded [B, K] uint64 hash batch with a validity mask.  That is what
K2' computes (search/count.py), so ``TorchBlockCounter`` launches K2' on a
CUDA tensor and takes its plain version on a CPU tensor; the NumPy counter
stays as the oracle the tests hold it to.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kmer import native
from .count import check_rows, count_mask
from .device_step import COUNTS_BYTES, FLOOR_NEVER

# Windows per K2' row: a multiple of 32 under 256, so that K2' runs its
# 8-plane counter; longer rows fold into pseudo-rows of this many windows.
# The 9-plane counter (rows of up to 511 windows) does not spill either;
# whether pseudo-rows of up to 480 windows pay on this route is not
# measured (ROADMAP B).
ROW_WINDOWS = 224


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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class TorchBlockCounter:
    """One block's counter on a torch device: its bits, with the all-zero
    sentinel row appended, uploaded once.

    A call derives int32 locations on the host (``native.locations``),
    points masked windows at the sentinel row and counts with K2'
    (``count_mask``, floors set so that no mask bit is set).  Rows of more
    than ROW_WINDOWS windows (``-g`` genomes, long uniqued reads) fold into
    pseudo-rows of ROW_WINDOWS windows whose counts add up on the device
    per query; pseudo-rows without a valid window are not counted.  Rows
    pad to a multiple of 1,024 and windows to a multiple of 32, as in
    JaxBlockCounter, and K2' runs on chunks of rows whose counts stay near
    COUNTS_BYTES."""

    def __init__(self, bits: np.ndarray, num_hashes: int, device):
        self.num_sigs, self.num_words = bits.shape
        if self.num_sigs >= 2**31 - 1:
            raise ValueError(f"{self.num_sigs} Bloom rows: too many for "
                             "int32 locations")
        self.num_hashes = num_hashes
        self.device = torch.device(device)
        ext = np.zeros((self.num_sigs + 1, self.num_words), dtype=np.uint32)
        ext[:-1] = bits
        self.bits = torch.from_numpy(ext.view(np.int32)).to(self.device)
        self.thr = torch.full((32 * self.num_words,), FLOOR_NEVER,
                              dtype=torch.int32, device=self.device)

    def rows(self, hashes: np.ndarray, mask: np.ndarray):
        """[B, K] hashes + mask -> (loc int32 [R, Kr, h], owner int64 [R]):
        the K2' rows and the query each adds to (B for padding rows)."""
        B, K = hashes.shape
        S, h = self.num_sigs, self.num_hashes
        width = ROW_WINDOWS if K > ROW_WINDOWS else _round_up(max(K, 1), 32)
        n_sub = max(1, -(-K // width))
        loc = np.full((B, n_sub * width, h), S, dtype=np.int32)
        m = np.zeros((B, n_sub * width), dtype=bool)
        m[:, :K] = mask
        loc[:, :K] = native.locations(hashes, h, S)
        loc[~m] = S
        loc = loc.reshape(B * n_sub, width, h)
        owner = np.repeat(np.arange(B, dtype=np.int64), n_sub)
        live = m.reshape(B * n_sub, width).any(axis=1)
        loc, owner = loc[live], owner[live]
        R = _round_up(max(len(owner), 1), 1024)
        pad = R - len(owner)
        loc = np.concatenate([loc, np.full((pad, width, h), S, np.int32)])
        owner = np.concatenate([owner, np.full(pad, B, np.int64)])
        return loc, owner

    def __call__(self, hashes: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """[B, K] uint64 hashes + [B, K] bool mask -> host int32 [B, 32 W]
        counts."""
        loc, owner = self.rows(hashes, mask)
        return self.count_rows(loc, owner, hashes.shape[0]).cpu().numpy()

    def count_rows(self, loc_np: np.ndarray, owner_np: np.ndarray,
                   B: int) -> torch.Tensor:
        """``rows``' output -> int32 [B, 32 W] counts on the device."""
        T = 32 * self.num_words
        loc = torch.from_numpy(loc_np).to(self.device)
        owner = torch.from_numpy(owner_np).to(self.device)
        check_rows(loc, self.bits.shape[0])  # once, not per chunk
        step = max(1, COUNTS_BYTES // (4 * T))
        cthr = torch.full((min(step, loc.shape[0]),), FLOOR_NEVER,
                          dtype=torch.int32, device=self.device)
        out = torch.zeros((B + 1, T), dtype=torch.int32, device=self.device)
        for r0 in range(0, loc.shape[0], step):
            r1 = min(loc.shape[0], r0 + step)
            counts, _mask = count_mask(self.bits, loc[r0:r1],
                                       cthr[: r1 - r0], self.thr,
                                       rows_checked=True)
            out.index_add_(0, owner[r0:r1], counts)
        return out[:B]
