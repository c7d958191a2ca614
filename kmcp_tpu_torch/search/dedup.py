"""In-step k-mer dedup of paired streaming: per read, one window per 64-bit
value, for reads whose raw window count exceeds the dedup threshold.

Port of kmcp_tpu/search/device_step.py:458 ``_dedup_value_planes``, the
reference's >256-k-mer unique step (util-db-search.go:874-908) on the
device.  Reads at or under the threshold keep their duplicate windows, as
the reference does.  The JAX package sorts with ``lax.sort`` (no Pallas
kernel), so the port sorts with ``torch.sort``: one function for CPU and
CUDA tensors.
"""

from __future__ import annotations

import torch


def dedup_planes(vals: torch.Tensor, locs: list[torch.Tensor],
                 nk: torch.Tensor, threshold: int, sentinels
                 ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """vals int64 [B, K] window values (0 for invalid windows; a valid
    window never hashes to 0), locs location planes int32 [B, K] or
    [B, K, h], nk int32 [B] raw valid-window counts, ``sentinels`` one row
    for every plane or one per plane -> (planes, nk).

    In every read with nk > threshold, each repeated value keeps one window
    and its other windows point at the plane's sentinel; such a read's nk
    becomes its count of distinct values.  Windows come back in value
    order, in every read: the count tails sum over windows, so their order
    is free, and duplicates need only land next to each other, for which
    signed int64 order serves as well as unsigned.  Every copy of a value
    carries the same locations, so which copy survives does not matter."""
    sents = (list(sentinels) if isinstance(sentinels, (list, tuple))
             else [sentinels] * len(locs))
    v_s, order = torch.sort(vals, dim=1)
    dup = torch.zeros_like(v_s, dtype=torch.bool)
    dup[:, 1:] = (v_s[:, 1:] == v_s[:, :-1]) & (v_s[:, 1:] != 0)
    apply = nk > threshold
    drop = dup & apply[:, None]
    nk_eff = torch.where(apply, nk - dup.sum(dim=1, dtype=nk.dtype), nk)
    out = []
    for loc, s in zip(locs, sents):
        idx = order if loc.dim() == 2 else order[..., None].expand_as(loc)
        d = drop if loc.dim() == 2 else drop[..., None]
        out.append(torch.where(d, s, torch.gather(loc, 1, idx)).to(loc.dtype))
    return out, nk_eff
