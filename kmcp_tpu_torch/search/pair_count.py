"""Pass 2 of the two-pass screened search, one (read, block) pair at a time:
Bloom-row gather from the pair's block + positional popcount + fused
threshold mask (kernel K5').

Port of the Pallas kernel kmcp_tpu/search/pallas_count.py:658
``make_pallas_pair_count``.  The CUDA kernel is
``kmcp_tpu_torch/csrc/pair_count.cu``; ``pair_count_plain`` is the same
function in plain PyTorch, which CPU tensors take.  Like the TPU kernel it
counts a block's pairs against that block's rows held on chip (a word tile
of them in shared memory, or for blocks too tall for a tile the rows its
pairs hit, streamed through a ring), but it takes pairs in any order and the
row-stacked matrix as it is: the wrapper sorts the pairs by block on the
device (``block_order``) and the kernel writes row p of its outputs for
pair p.  A pair whose block is ``nb`` is padding (the fixed-size pair list
of the screened tail, search/screen.py ``pair_list``): it sorts past every
block, so no variant gathers a row for it; its mask row is 0 and its counts
row is left unwritten.
"""

from __future__ import annotations

import torch

from ..kernels._build import get_lib
from .count import VARIANTS, check_rows, variant_name


def _check(bits, loc, pb, pg, cthr, thr) -> int:
    """Validate the arguments; returns s_block."""
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bits.device}")
    for name, t in (("bits", bits), ("loc", loc), ("pb", pb), ("pg", pg),
                    ("cthr", cthr), ("thr", thr)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != bits.device:
            raise ValueError(f"{name} is on {t.device}, bits on {bits.device}")
    if bits.dim() != 2 or loc.dim() != 2 or thr.dim() != 2:
        raise ValueError("bits must be [nb*s_block+1, W], loc [B, K] and "
                         "thr [nb, 32 W]")
    n_blocks, W = thr.shape[0], bits.shape[1]
    if thr.shape[1] != 32 * W or n_blocks < 1:
        raise ValueError(f"thr must be [nb, {32 * W}], got {tuple(thr.shape)}")
    if (bits.shape[0] - 1) % n_blocks:
        raise ValueError(f"{bits.shape[0] - 1} rows do not split into "
                         f"{n_blocks} blocks")
    if pb.dim() != 1 or pb.shape != pg.shape:
        raise ValueError("pb and pg must be [P]")
    if tuple(cthr.shape) != (loc.shape[0],):
        raise ValueError(f"cthr must be [{loc.shape[0]}]")
    return (bits.shape[0] - 1) // n_blocks


def check_pairs(loc: torch.Tensor, pb: torch.Tensor, pg: torch.Tensor,
                s_block: int, n_blocks: int):
    """Raise unless loc lies in 0..s_block, pb in 0..B-1 and pg in 0..nb
    (nb: a padding pair); each check waits for the device on a CUDA
    tensor."""
    check_rows(loc, s_block + 1)
    check_rows(pb, loc.shape[0])
    check_rows(pg, n_blocks + 1)


def block_order(pg: torch.Tensor, n_blocks: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairs' blocks pg int32 [P] -> (order int32 [P], seg int32 [nb+1]):
    the pairs stably sorted by block, block g's at order[seg[g] ..
    seg[g+1]], padding pairs (block nb) past seg[nb].  On the device, no
    host sync."""
    order = torch.argsort(pg, stable=True)
    blocks = torch.arange(n_blocks + 1, dtype=pg.dtype, device=pg.device)
    seg = torch.searchsorted(pg[order], blocks)
    return order.to(torch.int32), seg.to(torch.int32)


def floor_mask(counts: torch.Tensor, thr_rows: torch.Tensor,
               cthr_rows: torch.Tensor) -> torch.Tensor:
    """counts int32 [P, 32 W], per-target floors thr_rows [P, 32 W] and
    per-read floors cthr_rows [P] -> mask int32 [P, W], bit j of word w set
    iff counts[p, 32 w + j] >= max(thr_rows[p, 32 w + j], cthr_rows[p])."""
    P, T = counts.shape
    shifts = torch.arange(32, dtype=torch.int64, device=counts.device)
    floor = torch.maximum(thr_rows, cthr_rows[:, None])
    ok = (counts >= floor).reshape(P, T // 32, 32).long()
    words = (ok << shifts).sum(dim=2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pair_count_variant(W: int, s_block: int) -> str:
    """The variant K5' runs for blocks of s_block rows of W words on the
    current CUDA device."""
    return variant_name(get_lib().kmcp_pair_count_variant(W, s_block),
                        "pair_count")


def pair_count(bits: torch.Tensor, loc: torch.Tensor, pb: torch.Tensor,
               pg: torch.Tensor, cthr: torch.Tensor, thr: torch.Tensor,
               rows_checked: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """bits int32 [nb*s_block+1, W] (the row-stacked blocks, all-zero
    sentinel row last), loc int32 [B, K] (rows in the block modulus,
    sentinel s_block), pb/pg int32 [P] (read and block of each pair), cthr
    int32 [B] per-read floor, thr int32 [nb, 32 W] per-target floor ->
    (counts int32 [P, 32 W], mask int32 [P, W] with bit j of word w set iff
    counts[p, 32 w + j] >= max(thr[pg[p], 32 w + j], cthr[pb[p]])); a
    padding pair (pg[p] = nb) has mask row 0 and counts row unwritten.  A
    CPU tensor takes ``pair_count_plain``; a CUDA tensor launches the
    kernel or raises.  ``rows_checked=True`` skips ``check_pairs`` (device
    syncs) for a caller that has built pb and pg itself and checked or
    clamped loc (count.py ``defer_rows``)."""
    if bits.device.type == "cpu":
        return pair_count_plain(bits, loc, pb, pg, cthr, thr)
    s_block = _check(bits, loc, pb, pg, cthr, thr)
    n_blocks, W = thr.shape[0], bits.shape[1]
    if not rows_checked:
        check_pairs(loc, pb, pg, s_block, n_blocks)
    P, K = pb.shape[0], loc.shape[1]
    counts = torch.empty((P, 32 * W), dtype=torch.int32, device=bits.device)
    mask = torch.zeros((P, W), dtype=torch.int32, device=bits.device)
    if P == 0:
        return counts, mask
    variant = pair_count_variant(W, s_block)
    # every variant but the gather counts each block's pairs together
    order, seg = ((pb, pb) if variant == "gather"
                  else block_order(pg, n_blocks))
    stream = torch.cuda.current_stream(bits.device).cuda_stream
    rc = get_lib().kmcp_pair_count(
        bits.data_ptr(), W, n_blocks, s_block, loc.data_ptr(), K,
        pb.data_ptr(), pg.data_ptr(), P, order.data_ptr(), seg.data_ptr(),
        cthr.data_ptr(), thr.data_ptr(), counts.data_ptr(), mask.data_ptr(),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"pair_count kernel launch failed: cuda error {rc}")
    pair_count.launches += 1
    pair_count.by_variant[variant] += 1
    return counts, mask


pair_count.launches = 0
pair_count.by_variant = dict.fromkeys(VARIANTS, 0)


def pair_count_plain(bits: torch.Tensor, loc: torch.Tensor, pb: torch.Tensor,
                     pg: torch.Tensor, cthr: torch.Tensor, thr: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: per window, each real pair's row of its
    block (the global sentinel row for sentinel windows) -> unpack bits ->
    add, then threshold; padding pairs count 0 and set no bit."""
    s_block = _check(bits, loc, pb, pg, cthr, thr)
    n_blocks, W = thr.shape[0], bits.shape[1]
    check_pairs(loc, pb, pg, s_block, n_blocks)
    P = pb.shape[0]
    counts = torch.zeros((P, 32 * W), dtype=torch.int32, device=bits.device)
    mask = torch.zeros((P, W), dtype=torch.int32, device=bits.device)
    real = torch.nonzero(pg < n_blocks).squeeze(1)
    b, g = pb[real].long(), pg[real].long()
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    lp = loc[b].long()  # [P_real, K]
    rows = torch.where(lp == s_block, n_blocks * s_block,
                       lp + g[:, None] * s_block)
    c = torch.zeros((real.shape[0], W, 32), dtype=torch.int32,
                    device=bits.device)
    for i in range(loc.shape[1]):
        # arithmetic shift then & 1 reads bit 31 of negative words right
        c += (bits[rows[:, i]][..., None] >> shifts) & 1
    c = c.reshape(-1, 32 * W)
    counts[real] = c
    mask[real] = floor_mask(c, thr[g], cthr[b])
    return counts, mask
