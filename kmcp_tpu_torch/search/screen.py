"""The two-pass screened tail of a multi-block search: pass 1 counts each
read against every block's union Bloom, pass 2 counts only the (read,
block) pairs above the junk band, through K5' ``pair_count`` or K6'
``group_count``.

Port of kmcp_tpu/search/device_screened.py:193 ``_make_screened_tail``
(single-end, and with ``in_dedup`` the paired mode that uniques each
over-threshold read's windows in both location planes before either pass,
search/dedup.py).  Pass 1 is K2' ``count_mask`` over the
packed union table (one 32-block word per k-mer).  The active pairs come
from ``torch.nonzero``, ascending (read, block); the JAX ``pair_budget``
existed only for XLA's static shapes, so there is none: pass 2 runs on pair
chunks whose int32 counts stay near ``COUNTS_BYTES``.  Candidates ascend by
(read, block, target), as the dense tail's do, and leave in the split-id
``(meta, aux)`` layout (``pack_result_split``).
"""

from __future__ import annotations

import numpy as np
import torch

from .count import check_rows, count_mask
from .dedup import dedup_planes
from .device_step import (
    COUNTS_BYTES,
    mask_hits,
    pack_result_split,
    read_floor,
)
from .group_count import TILE, group_count
from .pair_count import pair_count

PASS2 = ("pair", "gemm")


def pass2_kernel(n_blocks: int, w_block: int, s_block: int,
                 dedup_threshold: int) -> str:
    """"pair" (K5') or "gemm" (K6'): the pass-2 kernel for a DB of
    ``n_blocks`` blocks of ``w_block`` words and ``s_block`` rows.

    The rule is measured, not the TPU's (whose n_blocks > 64 cut and VMEM
    budget do not apply here).  On an NVIDIA H100 80GB HBM3 at its 700.00 W
    power limit, at 4,096 targets and 3,578 rows a block, after both
    kernels' Hopper redesigns, the whole K5' route (block sort + kernel +
    compaction) took 1.153 ms at 32 blocks and 20,480 pairs and 1.892 ms at
    128 blocks and 36,864 pairs, and the K6' route (block sort + kernel
    with fused floors + compaction) 2.030 ms and 3.445 ms (chip_smoke.py
    phase 3; tools/pass2_ab.py in the same call: 1.03-1.29 against
    1.66-1.68 ms, and 1.40-1.45 against 2.71-2.82 ms; PERF.md).  So K5' at
    every measured geometry; K6' runs only when asked for, and then only
    while every real row multiplicity fits the plain version's bf16 U
    exactly (dedup_threshold <= 256)."""
    return "pair"


def active_pairs(u_ext: torch.Tensor, loc_u: torch.Tensor, nk: torch.Tensor,
                 lens: torch.Tensor, theta: torch.Tensor, n_blocks: int,
                 min_len: int, dedup_threshold: int, in_dedup: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1: union-hit counts of every read against every block (K2'
    over u_ext int32 [num_bits+1, ceil(nb/32)] with loc_u int32 [B, K]),
    kept where they reach theta[g, min(nk, n_max)] for reads that are long
    enough and, unless ``in_dedup`` (their windows were uniqued instead),
    within the dedup threshold (device_screened.py:339-349).  Returns
    (pb, pg) int32 [P], ascending by (read, block)."""
    B, K = loc_u.shape
    Wu = u_ext.shape[1]
    dev = u_ext.device
    ucnt, _ = count_mask(
        u_ext, loc_u.reshape(B, K, 1),
        torch.zeros(B, dtype=torch.int32, device=dev),
        torch.zeros(32 * Wu, dtype=torch.int32, device=dev),
    )
    nkc = nk.clamp(0, theta.shape[1] - 1).long()
    th = theta.t()[nkc]  # [B, nb]
    read_ok = lens >= min_len
    if not in_dedup:
        read_ok = read_ok & (nk <= dedup_threshold)
    active = (ucnt[:, :n_blocks] >= th) & read_ok[:, None]
    pb, pg = torch.nonzero(active, as_tuple=True)
    return pb.to(torch.int32), pg.to(torch.int32)


def pass2_chunk(T_b: int) -> int:
    """Pairs per pass-2 launch: int32 counts [P, T_b] near COUNTS_BYTES."""
    return max(TILE, COUNTS_BYTES // (4 * T_b))


def _pass2_chunks(count, pb, pg, chunk):
    """count(pb, pg) -> (counts, mask) on read-major chunks of P > 0 pairs
    -> (pair ids, target lanes, counts) ascending by (pair, lane)."""
    ps, ts, cs = [], [], []
    for p0 in range(0, pb.shape[0], chunk):
        p1 = min(pb.shape[0], p0 + chunk)
        counts, mask = count(pb[p0:p1], pg[p0:p1])
        p, t = mask_hits(mask)
        ps.append(p + p0)
        ts.append(t)
        cs.append(counts[p, t])
    return torch.cat(ps), torch.cat(ts), torch.cat(cs)


def _pass2_pair(bits_ext, loc, pb, pg, cthr, thr, chunk):
    """K5' on read-major chunks of P > 0 pairs."""
    return _pass2_chunks(
        lambda b, g: pair_count(bits_ext, loc, b, g, cthr, thr,
                                rows_checked=True), pb, pg, chunk)


def _pass2_gemm(bits01, loc, pb, pg, cthr, thr, s_block, chunk):
    """K6' on read-major chunks of P > 0 pairs (it sorts each chunk by
    block itself and writes each pair's row in place)."""
    return _pass2_chunks(
        lambda b, g: group_count(bits01, loc, b, g, cthr, thr, s_block,
                                 rows_checked=True), pb, pg, chunk)


def screened_tail(bits_ext: torch.Tensor, u_ext: torch.Tensor,
                  loc: torch.Tensor, loc_u: torch.Tensor, nk: torch.Tensor,
                  lens: torch.Tensor, cmin: torch.Tensor, theta: torch.Tensor,
                  thr: torch.Tensor, budget: int, min_len: int,
                  dedup_threshold: int, pass2: str = "pair",
                  bits01: torch.Tensor | None = None,
                  chunk_pairs: int | None = None,
                  stats: dict | None = None, in_dedup: bool = False,
                  values: torch.Tensor | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """bits_ext int32 [nb*s_block+1, W_b] (row-stacked blocks, sentinel
    row last), u_ext int32 [num_bits+1, ceil(nb/32)], loc/loc_u int32
    [B, K] (block rows with sentinel s_block / union rows with sentinel
    num_bits), nk/lens int32 [B], cmin int32 [n_max+1], theta int32
    [nb, n_max+1], thr int32 [nb, 32 W_b] (FLOOR_NEVER on padding lanes)
    -> (meta, aux) in the split-id layout.  ``pass2`` "gemm" needs
    ``bits01`` (``gemm_slabs``).  Pass 2 runs on chunks of
    ``chunk_pairs`` pairs (default: int32 counts near COUNTS_BYTES).
    ``stats``, when given, has the batch's active pairs added to
    ``stats["pairs"]``.  With ``in_dedup`` (paired streaming) ``values``
    int64 [B, K] are the window values: reads over ``dedup_threshold``
    windows are uniqued in both planes before either pass (sentinels
    s_block and the union table's zero row num_bits, device_screened.py:
    324-331) instead of excluded, and theta, the floors and the reported
    k-mer counts take the unique counts."""
    if dedup_threshold >= 65535:
        raise ValueError(
            f"kmer_dedup_threshold {dedup_threshold} >= 65535 would "
            "overflow the uint16 aux layout"
        )
    if pass2 not in PASS2:
        raise ValueError(f"pass2 must be one of {PASS2}, got {pass2!r}")
    if pass2 == "gemm" and (bits01 is None or dedup_threshold > 256):
        raise ValueError("pass2='gemm' needs the unpacked slabs and a dedup "
                         "threshold <= 256 (bf16 multiplicities)")
    n_blocks, T_b = thr.shape
    s_block = (bits_ext.shape[0] - 1) // n_blocks
    if in_dedup:
        (loc, loc_u), nk = dedup_planes(values, [loc, loc_u], nk,
                                        dedup_threshold,
                                        (s_block, u_ext.shape[0] - 1))
    check_rows(loc, s_block + 1)  # once per batch, not per pair chunk
    pb, pg = active_pairs(u_ext, loc_u, nk, lens, theta, n_blocks, min_len,
                          dedup_threshold, in_dedup)
    cthr = read_floor(nk, lens, cmin, min_len, dedup_threshold, in_dedup)
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + int(pb.shape[0])
    if chunk_pairs is None:
        chunk_pairs = pass2_chunk(T_b)
    if pb.numel() == 0:
        none = torch.zeros(0, dtype=torch.int64, device=loc.device)
        return pack_result_split(none, none, none, nk, budget)
    if pass2 == "pair":
        p, t, cnt = _pass2_pair(bits_ext, loc, pb, pg, cthr, thr,
                                chunk_pairs)
    else:
        p, t, cnt = _pass2_gemm(bits01, loc, pb, pg, cthr, thr, s_block,
                                chunk_pairs)
    q = pb[p]
    tg = pg[p].long() * T_b + t
    return pack_result_split(q, tg, cnt, nk, budget)
