"""The count tail after device hashing: thresholds -> K2' -> compaction ->
the ``(meta, aux)`` result layout.

Port of the single-block count tail kmcp_tpu/search/device_step.py:559
``_make_count_tail`` (single-end, and with ``in_dedup`` the paired mode
that uniques each over-threshold read's windows first, search/dedup.py)
and of its compaction, ``_nonzero_asc`` / ``_compact_candidates``
(:97-137).  The kernel is K2' (search/count.py); thresholding inputs and
compaction are plain torch, as the JAX package leaves them to XLA.

Result layout (device_step.py:578-583), as host numpy arrays:
  meta int32 [1 + budget] = [n_cand, flat ids b*T + t ascending...], padded
       with min(B*T, 2^31-1); n_cand is the EXACT total even past the
       budget, so the stream layer retries with 4x the budget;
  aux  uint16 [budget + B] = [counts..., nkmers...], both clipped to 65535.
The screened multi-block tail (search/screen.py) leaves in the split-id
layout (device_screened.py:498-504, read by stream.py ``_unpack_result``):
  meta int32 [1 + 2 budget] = [n_cand, read ids..., global target ids...],
       padded with B and 0; aux as above.
"""

from __future__ import annotations

import numpy as np
import torch

from .count import check_rows, count_mask
from .dedup import dedup_planes

FLOOR_NEVER = 2**30  # a floor no count reaches (and max() cannot overflow)
COUNTS_BYTES = 1 << 30  # int32 counts per read chunk stay near 1 GB


def target_floor(tmin: np.ndarray, sizes_pos: np.ndarray) -> np.ndarray:
    """thr[t] = tmin[t] on real targets, FLOOR_NEVER on padding lanes."""
    return np.where(sizes_pos, tmin, FLOOR_NEVER).astype(np.int32)


def read_floor(nk: torch.Tensor, lens: torch.Tensor, cmin: torch.Tensor,
               min_len: int, dedup_threshold: int, in_dedup: bool = False
               ) -> torch.Tensor:
    """cthr[b] = cmin[min(nk, len(cmin)-1)], or FLOOR_NEVER for reads that
    are too short or, unless ``in_dedup`` (their windows were uniqued
    instead), over the dedup threshold (device_step.py:672-680)."""
    c = cmin[nk.clamp(0, cmin.shape[0] - 1).long()]
    excl = lens < min_len
    if not in_dedup:
        excl = excl | (nk > dedup_threshold)
    return torch.where(excl, FLOOR_NEVER, c).to(torch.int32)


def mask_hits(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Set bits of mask int32 [R, W] -> (rows, target lanes 32 w + j)
    int64, ascending by (row, lane): nonzero words, then their bits."""
    W = mask.shape[1]
    words = mask.reshape(-1)
    wid = torch.nonzero(words).squeeze(1)  # ascending (row, w)
    shifts = torch.arange(32, dtype=torch.int32, device=mask.device)
    bits = ((words[wid][:, None] >> shifts) & 1).bool()
    row, j = torch.nonzero(bits, as_tuple=True)  # row-major: ascending
    w_flat = wid[row]
    return w_flat // W, (w_flat % W) * 32 + j


def compact_plain(mask: torch.Tensor, counts: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Set bits of mask int32 [B, W] -> (ascending flat ids b*32W + t
    int64, their counts int32)."""
    rows, t = mask_hits(mask)
    ids = rows * (32 * mask.shape[1]) + t
    return ids, counts.reshape(-1)[ids]


def pack_result(ids: torch.Tensor, cnt: torch.Tensor, nk: torch.Tensor,
                budget: int, n_flat: int) -> tuple[np.ndarray, np.ndarray]:
    """(meta, aux) host arrays from all candidates of a batch."""
    n = int(ids.numel())
    keep = min(n, budget)
    meta = np.full(1 + budget, min(n_flat, 2**31 - 1), dtype=np.int32)
    meta[0] = min(n, 2**31 - 1)
    meta[1 : 1 + keep] = ids[:keep].cpu().numpy()
    aux = np.zeros(budget + nk.shape[0], dtype=np.uint16)
    aux[:keep] = cnt[:keep].clamp(0, 65535).cpu().numpy()
    aux[budget:] = nk.clamp(0, 65535).cpu().numpy()
    return meta, aux


def pack_result_split(q: torch.Tensor, t: torch.Tensor, cnt: torch.Tensor,
                      nk: torch.Tensor, budget: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(meta, aux) host arrays in the split-id layout from all candidates
    of a batch: read ids q, global target ids t, counts cnt."""
    n = int(q.numel())
    keep = min(n, budget)
    meta = np.zeros(1 + 2 * budget, dtype=np.int32)
    meta[0] = min(n, 2**31 - 1)
    meta[1 : 1 + budget] = nk.shape[0]
    meta[1 : 1 + keep] = q[:keep].cpu().numpy()
    meta[1 + budget : 1 + budget + keep] = t[:keep].cpu().numpy()
    aux = np.zeros(budget + nk.shape[0], dtype=np.uint16)
    aux[:keep] = cnt[:keep].clamp(0, 65535).cpu().numpy()
    aux[budget:] = nk.clamp(0, 65535).cpu().numpy()
    return meta, aux


def count_tail(bits_ext: torch.Tensor, loc: torch.Tensor, nk: torch.Tensor,
               lens: torch.Tensor, cmin: torch.Tensor, thr: torch.Tensor,
               budget: int, min_len: int, dedup_threshold: int,
               chunk_reads: int | None = None, in_dedup: bool = False,
               values: torch.Tensor | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """bits_ext int32 [S+1, W], loc int32 [B, K, h], nk/lens int32 [B],
    cmin int32 [n_max+1], thr int32 [32 W] -> (meta, aux).

    K2' runs on read chunks of ``chunk_reads`` (default: counts near
    COUNTS_BYTES); chunk-major concatenation keeps the flat ids
    ascending.  With ``in_dedup`` (paired streaming) ``values`` int64
    [B, K] are the window values: reads over ``dedup_threshold`` windows
    are uniqued (``dedup_planes``, sentinel row S) instead of excluded, and
    their nk, floors and reported k-mer counts are the unique counts."""
    if dedup_threshold >= 65535:
        raise ValueError(
            f"kmer_dedup_threshold {dedup_threshold} >= 65535 would "
            "overflow the uint16 aux layout"
        )
    B = loc.shape[0]
    T = 32 * bits_ext.shape[1]
    if chunk_reads is None:
        chunk_reads = max(1, COUNTS_BYTES // (4 * T))
    if in_dedup:
        (loc,), nk = dedup_planes(values, [loc], nk, dedup_threshold,
                                  bits_ext.shape[0] - 1)
    cthr = read_floor(nk, lens, cmin, min_len, dedup_threshold, in_dedup)
    check_rows(loc, bits_ext.shape[0])  # once per batch, not per chunk
    ids, cnts = [], []
    for b0 in range(0, B, chunk_reads):
        b1 = min(B, b0 + chunk_reads)
        counts, mask = count_mask(bits_ext, loc[b0:b1], cthr[b0:b1], thr,
                                  rows_checked=True)
        i, c = compact_plain(mask, counts)
        ids.append(i + b0 * T)
        cnts.append(c)
    return pack_result(torch.cat(ids), torch.cat(cnts), nk, budget, B * T)
