"""The two-pass screened tail of a multi-block search: pass 1 counts each
read against every block's union Bloom, pass 2 counts only the (read,
block) pairs above the junk band, through K5' ``pair_count`` or K6'
``group_count``.

Port of kmcp_tpu/search/device_screened.py:193 ``_make_screened_tail``
(single-end, and with ``in_dedup`` the paired mode that uniques each
over-threshold read's windows in both location planes before either pass,
search/dedup.py).  Pass 1 is K2' ``count_mask`` over the
packed union table (one 32-block word per k-mer).  The active pairs, as in
the JAX package, compact to a fixed ``pair_budget`` (``pair_list``:
``nonzero_asc``, ascending (read, block); device.py:872, :888), so the tail
never waits for the card: padding pairs carry block nb, which K5' and K6'
sort past every block and never count.  Pass 2 runs on pair chunks whose
int32 counts stay near ``COUNTS_BYTES``, each chunk compacted to the whole
candidate budget (``compact_mask``) and the chunks spliced in order.
Candidates ascend by (read, block, target), as the dense tail's do, and
leave in the split-id ``(meta, aux)`` layout (``pack_result_split``); the
total is exact unless the pairs overflowed their budget, which reports
budget + 1 (device_screened.py:608, :645-647), so the caller's 4x retry
scales both budgets.

``sharded_screened_tail`` is the same search on a ("d", "t") DeviceMesh,
from kmcp_tpu/search/device_screened.py:659 ``_make_screened_step_sharded``:
rank (i, j) holds blocks [j nb_l, (j + 1) nb_l) of the row-stacked matrix
(the JAX package stacks them on the word axis: only the layout differs)
and the whole union table, runs pass 1 for every block and keeps its own,
pass 2 over its own, and merges its candidates with every other rank's by
global id (device_step.py ``sharded_compact``).  Single-end only, as in
the JAX package.  A rank's pairs and candidates compact as on one device
(``pair_list`` with a slot for each of its B nb_l pairs, so its pair list
never overflows, then ``pass2_fixed``); the merge waits for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .count import check_rows, count_mask, defer_rows
from .dedup import dedup_planes
from .device_step import (
    COUNTS_BYTES,
    TailResult,
    all_gather_cat,
    check_dedup,
    compact_mask,
    host_result,
    mesh_place,
    nonzero_asc,
    pack_result_split,
    read_floor,
    sharded_compact,
    splice,
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
    1.66-1.68 ms, and 1.40-1.45 against 2.71-2.82 ms; PERF.md).  At 300
    windows a read (the joined rows of read pairs), with K5' on its 9-plane
    counter, the K5' route took 1.489-1.497 ms at 32 blocks and
    2.301-2.328 ms at 128, while K6' sweeps each pair's windows twice (its
    u8 multiplicities hold 255) and its route took 4.824-4.890 ms and
    8.325-8.334 ms (tools/pass2_ab.py, the same card).  So K5' at every
    measured geometry and row length, and the rule does not depend on K;
    K6' runs only when asked for, and then only while every real row
    multiplicity fits the plain version's bf16 U exactly (dedup_threshold
    <= 256)."""
    return "pair"


def pair_budget_for(n_reads: int, n_blocks: int, cand_budget: int,
                    pass2: str) -> int:
    """Pass 2's pair slots: min(B nb, max(256, 2 cand_budget)), or
    max(256, cand_budget) on the gemm route (device.py:872, :888)."""
    per = 1 if pass2 == "gemm" else 2
    return min(n_reads * n_blocks, max(256, per * cand_budget))


def active_mask(u_ext: torch.Tensor, loc_u: torch.Tensor, nk: torch.Tensor,
                lens: torch.Tensor, theta: torch.Tensor, n_blocks: int,
                min_len: int, dedup_threshold: int, in_dedup: bool = False,
                g0: int = 0) -> torch.Tensor:
    """Pass 1: union-hit counts of every read against every block (K2'
    over u_ext int32 [num_bits+1, ceil(nb/32)] with loc_u int32 [B, K]),
    kept for blocks g0 .. g0 + n_blocks - 1 where they reach theta[g,
    min(nk, n_max)] for reads that are long enough and, unless
    ``in_dedup`` (their windows were uniqued instead), within the dedup
    threshold (device_screened.py:339-349, :713-716) -> bool [B,
    n_blocks].  The caller has checked or clamped loc_u's rows."""
    B, K = loc_u.shape
    Wu = u_ext.shape[1]
    dev = u_ext.device
    ucnt, _ = count_mask(
        u_ext, loc_u.reshape(B, K, 1),
        torch.zeros(B, dtype=torch.int32, device=dev),
        torch.zeros(32 * Wu, dtype=torch.int32, device=dev),
        rows_checked=True,
    )
    nkc = nk.clamp(0, theta.shape[1] - 1).long()
    own = slice(g0, g0 + n_blocks)
    th = theta.t()[nkc][:, own]  # [B, n_blocks]
    read_ok = lens >= min_len
    if not in_dedup:
        read_ok = read_ok & (nk <= dedup_threshold)
    return (ucnt[:, own] >= th) & read_ok[:, None]


def active_pairs(u_ext: torch.Tensor, loc_u: torch.Tensor, nk: torch.Tensor,
                 lens: torch.Tensor, theta: torch.Tensor, n_blocks: int,
                 min_len: int, dedup_threshold: int, in_dedup: bool = False,
                 g0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``active_mask``'s pairs, every one of them: (pb, pg - g0) int32
    [P], ascending by (read, block), by ``pair_list`` with a slot for
    every pair.  Checks loc_u's rows and cuts the list at its count, so it
    waits for the device."""
    check_rows(loc_u, u_ext.shape[0])
    active = active_mask(u_ext, loc_u, nk, lens, theta, n_blocks, min_len,
                         dedup_threshold, in_dedup, g0)
    pb, pg, n = pair_list(active, active.numel())
    n = int(n)
    return pb[:n], pg[:n]


def pair_list(active: torch.Tensor, pair_budget: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first ``pair_budget`` set pairs of active bool [B, nb],
    ascending by (read, block) -> (pb int32, pg int32, the exact active
    pair count as a device scalar); padding slots hold (B - 1, nb), as
    the JAX tail's clamped ``_nonzero_asc`` indices do (device_screened.py:
    350-356), with the block key past every block."""
    B, nb = active.shape
    idx, n = nonzero_asc(active.reshape(-1), pair_budget, B * nb)
    real = idx < B * nb
    idx = idx.clamp(max=B * nb - 1)
    pb = (idx // nb).to(torch.int32)
    pg = torch.where(real, idx % nb, nb).to(torch.int32)
    return pb, pg, n


def pass2_chunk(T_b: int) -> int:
    """Pairs per pass-2 launch: int32 counts [P, T_b] near COUNTS_BYTES."""
    return max(TILE, COUNTS_BYTES // (4 * T_b))


def screened_tail_async(bits_ext: torch.Tensor, u_ext: torch.Tensor,
                        loc: torch.Tensor, loc_u: torch.Tensor,
                        nk: torch.Tensor, lens: torch.Tensor,
                        cmin: torch.Tensor, theta: torch.Tensor,
                        thr: torch.Tensor, budget: int, min_len: int,
                        dedup_threshold: int, pass2: str = "pair",
                        bits01: torch.Tensor | None = None,
                        chunk_pairs: int | None = None,
                        stats: dict | None = None, in_dedup: bool = False,
                        values: torch.Tensor | None = None,
                        pair_budget: int | None = None) -> TailResult:
    """bits_ext int32 [nb*s_block+1, W_b] (row-stacked blocks, sentinel
    row last), u_ext int32 [num_bits+1, ceil(nb/32)], loc/loc_u int32
    [B, K] (block rows with sentinel s_block / union rows with sentinel
    num_bits), nk/lens int32 [B], cmin int32 [n_max+1], theta int32
    [nb, n_max+1], thr int32 [nb, 32 W_b] (FLOOR_NEVER on padding lanes)
    -> the step's ``TailResult`` in the split-id layout, enqueued without
    waiting for the device.  ``pass2`` "gemm" needs ``bits01``
    (``gemm_slabs``).  The active pairs compact to ``pair_budget`` slots
    (default ``pair_budget_for``) and pass 2 runs on chunks of
    ``chunk_pairs`` of them (default: int32 counts near COUNTS_BYTES).
    ``stats``, when given, has the batch's active pairs (a device scalar)
    added to ``stats["pairs"]``.  With ``in_dedup`` (paired streaming)
    ``values`` int64 [B, K] are the window values: reads over
    ``dedup_threshold`` windows are uniqued in both planes before either
    pass (sentinels s_block and the union table's zero row num_bits,
    device_screened.py:324-331) instead of excluded, and theta, the floors
    and the reported k-mer counts take the unique counts."""
    _check_tail(dedup_threshold, pass2, bits01)
    n_blocks, T_b = thr.shape
    B = loc.shape[0]
    s_block = (bits_ext.shape[0] - 1) // n_blocks
    if in_dedup:
        (loc, loc_u), nk = dedup_planes(values, [loc, loc_u], nk,
                                        dedup_threshold,
                                        (s_block, u_ext.shape[0] - 1))
    loc, r_loc = defer_rows(loc, s_block + 1)
    loc_u, r_u = defer_rows(loc_u, u_ext.shape[0])
    if pair_budget is None:
        pair_budget = pair_budget_for(B, n_blocks, budget, pass2)
    pb, pg, n_pairs = pair_list(
        active_mask(u_ext, loc_u, nk, lens, theta, n_blocks, min_len,
                    dedup_threshold, in_dedup), pair_budget)
    cthr = read_floor(nk, lens, cmin, min_len, dedup_threshold, in_dedup)
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + n_pairs
    if chunk_pairs is None:
        chunk_pairs = pass2_chunk(T_b)
    n, (q, t, cnt), valid = pass2_fixed(pass2, bits_ext, bits01, loc, pb, pg,
                                        cthr, thr, s_block, budget,
                                        chunk_pairs)
    total = torch.where(n_pairs > pair_budget, budget + 1, n)
    meta, aux = pack_result_split(
        torch.where(valid, q, B), torch.where(valid, t, 0),
        torch.where(valid, cnt, 0), nk, budget, total)
    return TailResult(meta, aux, torch.cat([r_loc, r_u]),
                      (s_block + 1, u_ext.shape[0]))


def pass2_fixed(pass2, bits_ext, bits01, loc, pb, pg, cthr, thr, s_block,
                budget, chunk):
    """Pass 2 over a fixed-size pair list (``pair_list``) on chunks of
    ``chunk`` pairs, each compacted to ``budget`` candidates and spliced ->
    (the exact candidate total, [read ids, target lanes g T_b + t, counts]
    [budget] each, valid lanes), as ``splice`` returns them."""
    T_b = thr.shape[1]
    parts = []
    for p0 in range(0, pb.shape[0], chunk):
        b, g = pb[p0 : p0 + chunk], pg[p0 : p0 + chunk]
        if pass2 == "pair":
            counts, mask = pair_count(bits_ext, loc, b, g, cthr, thr,
                                      rows_checked=True)
        else:
            counts, mask = group_count(bits01, loc, b, g, cthr, thr, s_block,
                                       rows_checked=True)
        idx, n = compact_mask(mask, budget, 0)
        p = idx // T_b  # padding lanes read pair 0: spliced away
        parts.append((n, b[p], g[p].long() * T_b + idx % T_b,
                      counts.reshape(-1)[idx]))
        del counts, mask  # the next chunk may reuse them (~1 GB)
    return splice(parts, budget)


def screened_tail(*args, **kwargs) -> tuple[np.ndarray, np.ndarray]:
    """``screened_tail_async`` waited for -> (meta int32, aux uint16) host
    arrays."""
    return host_result(screened_tail_async(*args, **kwargs))


def _check_tail(dedup_threshold: int, pass2: str, bits01):
    check_dedup(dedup_threshold)
    if pass2 not in PASS2:
        raise ValueError(f"pass2 must be one of {PASS2}, got {pass2!r}")
    if pass2 == "gemm" and (bits01 is None or dedup_threshold > 256):
        raise ValueError("pass2='gemm' needs the unpacked slabs and a dedup "
                         "threshold <= 256 (bf16 multiplicities)")


def sharded_screened_tail(bits_l: torch.Tensor, u_ext: torch.Tensor,
                          loc: torch.Tensor, loc_u: torch.Tensor,
                          nk: torch.Tensor, lens: torch.Tensor,
                          cmin: torch.Tensor, theta: torch.Tensor,
                          thr_l: torch.Tensor, budget: int, min_len: int,
                          dedup_threshold: int, mesh, n_reads: int,
                          pass2: str = "pair",
                          bits01: torch.Tensor | None = None,
                          stats: dict | None = None) -> TailResult:
    """``screened_tail_async`` on a mesh, single-end.  bits_l int32
    [nb_l*s_block+1, W_b] holds this rank's blocks (row-stacked, sentinel
    row last), thr_l int32 [nb_l, 32 W_b] their floors, u_ext and theta
    [nb, n_max+1] are whole, and loc / loc_u / nk / lens are this rank's
    ``d`` slice (``batch_slice``) of a batch of ``n_reads`` reads (padding
    rows give no pair).  Returns screened_tail's result for the whole
    batch on every rank (this rank's row ranges in it): byte-identical,
    meta[0] the true total (device_screened.py:659-803)."""
    _check_tail(dedup_threshold, pass2, bits01)
    _d, t_size, di, ti = mesh_place(mesh)
    nb_l, T_b = thr_l.shape
    s_block = (bits_l.shape[0] - 1) // nb_l
    B_d = loc.shape[0]
    n_valid = min(max(n_reads - di * B_d, 0), B_d)
    loc, r_loc = defer_rows(loc, s_block + 1)
    loc_u, r_u = defer_rows(loc_u, u_ext.shape[0])
    active = active_mask(u_ext, loc_u, nk, lens, theta, nb_l, min_len,
                         dedup_threshold, g0=ti * nb_l)
    active[n_valid:] = False
    pb, pg, n_pairs = pair_list(active, B_d * nb_l)
    cthr = read_floor(nk, lens, cmin, min_len, dedup_threshold)
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + n_pairs
    n, (q, tl, cnt), valid = pass2_fixed(pass2, bits_l, bits01, loc, pb, pg,
                                         cthr, thr_l, s_block, budget,
                                         pass2_chunk(T_b))
    T = nb_l * t_size * T_b
    tg = ti * nb_l * T_b + torch.arange(nb_l * T_b, device=loc.device)
    total, ids, cnt = sharded_compact(n, q, tl, cnt, valid, tg, T, di * B_d,
                                      budget, mesh)
    nk_all = all_gather_cat(nk, mesh, "d")[:n_reads]
    meta, aux = pack_result_split(ids // T, ids % T, cnt, nk_all, budget,
                                  total)
    return TailResult(meta, aux, torch.cat([r_loc, r_u]),
                      (s_block + 1, u_ext.shape[0]))
