"""The count tail after device hashing: thresholds -> K2' -> compaction ->
the ``(meta, aux)`` result layout.

Port of the single-block count tail kmcp_tpu/search/device_step.py:559
``_make_count_tail`` (single-end, and with ``in_dedup`` the paired mode
that uniques each over-threshold read's windows first, search/dedup.py)
and of its compaction, ``_nonzero_asc`` / ``_compact_candidates``
(:97-137).  The kernel is K2' (search/count.py); thresholding inputs and
compaction are plain torch, as the JAX package leaves them to XLA.

The streaming tails never make the host wait for the card: every shape is
fixed by the budget.  ``compact_mask`` finds the first ``budget`` set bits
of K2''s mask words by a popcount, a cumsum and a ``searchsorted`` for each
output slot (the word-then-bit pass of device_screened.py:455-498), with
the exact total as a device scalar; the read chunks of the dense tail each
get slots for the whole budget and are spliced on the device
(``splice``), so the total stays exact past the budget (the JAX chunked
tail, :845-889, gives each chunk a share and reports budget + 1 instead).
``count_tail_async`` returns a ``TailResult`` of device tensors, the row
range of ``loc`` among them: the tail gathers with ``loc`` clamped into the
table (``count.defer_rows``) and ``host_result`` raises on the range once
the result is on the host.  The caller copies it there behind an event
(device.py ``_copy_async``).  ``count_tail`` is the same tail waited for.

On a ``("d", "t")`` DeviceMesh (parallel/sharding.py), ``sharded_count_tail``
is the mesh branch of ``_make_search_step`` (:892-987): each rank counts its
``d`` slice of the batch against its ``t`` shard of the target words,
compacts its own candidates to global flat ids (``sharded_compact``,
:353) and the packed segments, O(budget) whatever T is, are all-gathered
and merged by global id (``merge_segments``, :390), so every rank holds
the single-device tail's bytes whenever the budget holds.  A rank compacts
as the single-device tail does (``compact_candidates`` on each read chunk,
``splice``); the merge waits for the card (collectives under gloo cross
the host).

Result layout (device_step.py:578-583), as host numpy arrays:
  meta int32 [1 + budget] = [n_cand, flat ids b*T + t ascending...], padded
       with min(B*T, 2^31-1); n_cand is the EXACT total even past the
       budget, so the stream layer retries with 4x the budget;
  aux  uint16 [budget + B] = [counts..., nkmers...], both clipped to 65535
       (int32 on the device, narrowed on the host).
The screened multi-block tail (search/screen.py) leaves in the split-id
layout (device_screened.py:498-504, read by stream.py ``_unpack_result``):
  meta int32 [1 + 2 budget] = [n_cand, read ids..., global target ids...],
       padded with B and 0; aux as above.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .count import check_range, count_mask, defer_rows
from .dedup import dedup_planes

FLOOR_NEVER = 2**30  # a floor no count reaches (and max() cannot overflow)
COUNTS_BYTES = 1 << 30  # int32 counts per read chunk stay near 1 GB


class TailResult(NamedTuple):
    """A search step's result on its device: meta int32, aux int32 (the
    layouts above), ``ranges`` int32 [2 m] the (min, max) of each location
    plane the step was given, which must lie in 0..n_rows[i]-1."""
    meta: torch.Tensor
    aux: torch.Tensor
    ranges: torch.Tensor
    n_rows: tuple


def host_result(res: TailResult) -> tuple[np.ndarray, np.ndarray]:
    """A step's result -> (meta int32, aux uint16) host arrays, after the
    row-range checks the step deferred (``check_rows``'s ValueError).
    Device tensors are copied here, which waits for the device."""
    for (lo, hi), n in zip(res.ranges.cpu().reshape(-1, 2).tolist(),
                           res.n_rows):
        check_range(lo, hi, n)
    return res.meta.cpu().numpy(), res.aux.cpu().numpy().astype(np.uint16)


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


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word of x [..., W] -> int32 [..., W]: the
    SWAR count on the words' bytes as uint8 (unsigned, so no shift or
    overflow depends on the sign), summed per word."""
    b = x.contiguous().view(torch.uint8)
    b = b - ((b >> 1) & 0x55)
    b = (b & 0x33) + ((b >> 2) & 0x33)
    b = (b + (b >> 4)) & 0x0F
    return b.reshape(*x.shape, 4).sum(dim=-1, dtype=torch.int32)


def _slots(weights: torch.Tensor, budget: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """weights [N > 0] (units per element) -> for each slot j = 1..budget the
    element holding the j-th unit (clamped to N - 1 past the total) and
    the unit's 1-based rank within it, and the total as a device scalar:
    a cumsum and a ``searchsorted`` (``_nonzero_asc``'s lowering)."""
    c = torch.cumsum(weights, 0, dtype=torch.int64)
    j = torch.arange(1, budget + 1, dtype=torch.int64, device=c.device)
    e = torch.searchsorted(c, j).clamp(max=c.shape[0] - 1)
    return e, j - (c[e] - weights[e]), c[-1]


def nonzero_asc(flat_ok: torch.Tensor, budget: int, fill: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ascending indices of the set lanes of a flat bool vector, padded
    with ``fill`` -> (idx int64 [budget], the true set-lane count as an
    int64 device scalar): ``_nonzero_asc`` (device_step.py:97-116), with
    no host sync."""
    e, _rank, n = _slots(flat_ok.to(torch.int32), budget)
    j = torch.arange(1, budget + 1, device=flat_ok.device)
    return torch.where(j <= n, e, fill), n


def compact_mask(mask: torch.Tensor, budget: int, fill: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ``budget`` set bits of mask int32 [R, W] as ascending flat
    ids r*32W + 32w + j int64, padded with ``fill``, and their exact total
    as an int64 device scalar: popcount the words, pick each slot's word by
    the cumsum and its bit by the rank within the word.  No host sync."""
    words = mask.reshape(-1)
    w, rank, n = _slots(popcount32(words), budget)
    shifts = torch.arange(32, dtype=torch.int32, device=mask.device)
    bits = (words[w][:, None] >> shifts) & 1
    # the rank-th set bit sits past every position whose prefix holds less
    pos = (torch.cumsum(bits, 1) < rank[:, None]).sum(1)
    j = torch.arange(1, budget + 1, device=mask.device)
    return torch.where(j <= n, w * 32 + pos, fill), n


def compact_candidates(mask: torch.Tensor, counts: torch.Tensor,
                       budget: int, cnt_fill: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_compact_candidates`` (device_step.py:119-137) on K2''s mask words
    int32 [B, W] and counts int32 [B, 32 W]: (ascending flat ids int64
    [budget] padded with B*32W, their counts int32 padded with
    ``cnt_fill``, the exact total as a device scalar)."""
    n_flat = counts.numel()
    idx, n = compact_mask(mask, budget, n_flat)
    cnt = counts.reshape(-1)[idx.clamp(max=max(n_flat - 1, 0))]
    return idx, torch.where(idx < n_flat, cnt, cnt_fill), n


def splice(parts: list, budget: int
           ) -> tuple[torch.Tensor, list, torch.Tensor]:
    """Chunks of a batch, each (n_c device scalar, payloads [budget]...)
    with its first min(n_c, budget) lanes valid, in ascending order ->
    (the total, each payload's first ``budget`` valid lanes in chunk order,
    the valid lanes bool [budget]).  Every chunk had slots for the whole
    budget, so the spliced lanes are the batch's first ``budget`` and the
    total is exact (device_step.py:868-889's scatter, without the per-chunk
    share)."""
    lane = torch.arange(budget, device=parts[0][0].device)
    n = torch.stack([p[0] for p in parts])
    n_eff = n.clamp(max=budget)
    if len(parts) == 1:
        return n[0], list(parts[0][1:]), lane < n_eff[0]
    ok = lane[None, :] < n_eff[:, None]
    pos, _ = nonzero_asc(ok.reshape(-1), budget, ok.numel())
    pos = pos.clamp(max=ok.numel() - 1)
    out = [torch.stack(x).reshape(-1)[pos]
           for x in zip(*(p[1:] for p in parts))]
    return n.sum(), out, lane < n_eff.sum().clamp(max=budget)


def mask_hits(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Set bits of mask int32 [R, W] -> (rows, target lanes 32 w + j)
    int64, ascending by (row, lane): nonzero words, then their bits.  The
    exact-size reference the fixed-budget compaction is tested against (it
    waits for the device)."""
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
    int64, their counts int32): every candidate, by ``mask_hits``."""
    rows, t = mask_hits(mask)
    ids = rows * (32 * mask.shape[1]) + t
    return ids, counts.reshape(-1)[ids]


def _total(total, n: int):
    """meta[0]: the total (an int or a device scalar) clamped to int32."""
    if isinstance(total, torch.Tensor):
        return total.clamp(max=2**31 - 1)
    return min(n if total is None else total, 2**31 - 1)


def pack_result(ids: torch.Tensor, cnt: torch.Tensor, nk: torch.Tensor,
                budget: int, n_flat: int, total=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(meta, aux) int32 on the device from a batch's ascending candidates:
    the first ``budget`` of ``ids`` (padded with min(n_flat, 2^31-1)) and
    of ``cnt``, with ``total`` (an int or a device scalar; default every
    id) in meta[0].  Lanes of ``ids`` past the total must hold the fill and
    those of ``cnt`` 0, as ``compact_mask`` and ``splice`` leave them."""
    keep = min(ids.numel(), budget)
    dev = nk.device
    meta = torch.full((1 + budget,), min(n_flat, 2**31 - 1),
                      dtype=torch.int32, device=dev)
    meta[0] = _total(total, ids.numel())
    meta[1 : 1 + keep] = ids[:keep]
    aux = torch.zeros(budget + nk.shape[0], dtype=torch.int32, device=dev)
    aux[:keep] = cnt[:keep].clamp(0, 65535)
    aux[budget:] = nk.clamp(0, 65535)
    return meta, aux


def pack_result_split(q: torch.Tensor, t: torch.Tensor, cnt: torch.Tensor,
                      nk: torch.Tensor, budget: int, total=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(meta, aux) int32 on the device in the split-id layout from a
    batch's candidates (read ids q, global target ids t, counts cnt; their
    first ``budget``), with ``total`` (an int or a device scalar; default
    every candidate) in meta[0].  Lanes past the total must hold B, 0 and
    0."""
    keep = min(q.numel(), budget)
    dev = nk.device
    meta = torch.zeros(1 + 2 * budget, dtype=torch.int32, device=dev)
    meta[0] = _total(total, q.numel())
    meta[1 : 1 + budget] = nk.shape[0]
    meta[1 : 1 + keep] = q[:keep]
    meta[1 + budget : 1 + budget + keep] = t[:keep]
    aux = torch.zeros(budget + nk.shape[0], dtype=torch.int32, device=dev)
    aux[:keep] = cnt[:keep].clamp(0, 65535)
    aux[budget:] = nk.clamp(0, 65535)
    return meta, aux


def check_dedup(dedup_threshold: int):
    if dedup_threshold >= 65535:
        raise ValueError(
            f"kmer_dedup_threshold {dedup_threshold} >= 65535 would "
            "overflow the uint16 aux layout"
        )


def count_tail_async(bits_ext: torch.Tensor, loc: torch.Tensor,
                     nk: torch.Tensor, lens: torch.Tensor, cmin: torch.Tensor,
                     thr: torch.Tensor, budget: int, min_len: int,
                     dedup_threshold: int, chunk_reads: int | None = None,
                     in_dedup: bool = False,
                     values: torch.Tensor | None = None) -> TailResult:
    """bits_ext int32 [S+1, W], loc int32 [B, K, h], nk/lens int32 [B],
    cmin int32 [n_max+1], thr int32 [32 W] -> the step's ``TailResult``,
    enqueued without waiting for the device.

    K2' runs on read chunks of ``chunk_reads`` (default: counts near
    COUNTS_BYTES); each chunk compacts to the whole budget and the chunks
    splice in order, so the flat ids ascend.  With ``in_dedup`` (paired
    streaming) ``values`` int64 [B, K] are the window values: reads over
    ``dedup_threshold`` windows are uniqued (``dedup_planes``, sentinel
    row S) instead of excluded, and their nk, floors and reported k-mer
    counts are the unique counts."""
    check_dedup(dedup_threshold)
    B = loc.shape[0]
    T = 32 * bits_ext.shape[1]
    if chunk_reads is None:
        chunk_reads = max(1, COUNTS_BYTES // (4 * T))
    if in_dedup:
        (loc,), nk = dedup_planes(values, [loc], nk, dedup_threshold,
                                  bits_ext.shape[0] - 1)
    cthr = read_floor(nk, lens, cmin, min_len, dedup_threshold, in_dedup)
    loc, ranges = defer_rows(loc, bits_ext.shape[0])
    parts = []
    for b0 in range(0, B, chunk_reads):
        b1 = min(B, b0 + chunk_reads)
        counts, mask = count_mask(bits_ext, loc[b0:b1], cthr[b0:b1], thr,
                                  rows_checked=True)
        idx, cnt, n = compact_candidates(mask, counts, budget, 0)
        parts.append((n, idx + b0 * T, cnt))
        del counts, mask  # the next chunk may reuse them (~1 GB)
    n, (ids, cnt), valid = splice(parts, budget)
    ids = torch.where(valid, ids, min(B * T, 2**31 - 1))
    meta, aux = pack_result(ids, torch.where(valid, cnt, 0), nk, budget,
                            B * T, n)
    return TailResult(meta, aux, ranges, (bits_ext.shape[0],))


def count_tail(*args, **kwargs) -> tuple[np.ndarray, np.ndarray]:
    """``count_tail_async`` waited for -> (meta int32, aux uint16) host
    arrays."""
    return host_result(count_tail_async(*args, **kwargs))


# ------------------------------------------------------------------ mesh

def mesh_place(mesh) -> tuple[int, int, int, int]:
    """(d_size, t_size, d_index, t_index) of this rank in a ("d", "t")
    DeviceMesh."""
    if tuple(mesh.mesh_dim_names or ()) != ("d", "t"):
        raise ValueError(f"the mesh's dims must be ('d', 't'), got "
                         f"{mesh.mesh_dim_names}")
    di, ti = mesh.get_coordinate()
    return mesh.size(0), mesh.size(1), int(di), int(ti)


def batch_slice(x: torch.Tensor, d_size: int, d_index: int, fill
                ) -> torch.Tensor:
    """Rows [i B_d, (i + 1) B_d) of a batch x [B, ...], B_d = ceil(B / d),
    padded with ``fill`` past B: rank i's ``d`` slice (JAX ``bval``
    padding, device_step.py:973-986)."""
    B = x.shape[0]
    B_d = -(-B // d_size)
    part = x[d_index * B_d : (d_index + 1) * B_d]
    if part.shape[0] == B_d:
        return part.contiguous()
    out = torch.full((B_d, *x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    out[: part.shape[0]] = part
    return out


def all_gather_cat(x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """Every rank's x along mesh dim ``dim``, concatenated in index order
    on axis 0.  Under gloo the tensors cross on the host (``.cpu()``);
    under nccl they stay on the card.  The backend is the process group's,
    as the caller initialised it."""
    group = mesh.get_group(dim)
    host = dist.get_backend(group) == "gloo"
    src = x.cpu() if host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(
        mesh.mesh_dim_names.index(dim)))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def global_target_ids(nb: int, W_t: int, t_size: int, t_index: int,
                      device=None) -> torch.Tensor:
    """Global target ids int64 of a ``t`` shard's [nb, W_t, 32] local
    targets, blocks stacked on the word axis before sharding
    (device_step.py:427-441)."""
    W = W_t * t_size
    g = torch.arange(nb, dtype=torch.int64, device=device)[:, None, None]
    w = torch.arange(W_t, dtype=torch.int64, device=device)[None, :, None]
    j = torch.arange(32, dtype=torch.int64, device=device)[None, None, :]
    return ((g * W + t_index * W_t + w) * 32 + j).reshape(-1)


def merge_segments(n_local: torch.Tensor, ids: torch.Tensor,
                   cnt: torch.Tensor, valid: torch.Tensor, budget: int, mesh
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each rank's packed candidate segment (its first ``budget`` global
    flat ids int64, ascending, their counts, the valid lanes bool
    [budget], and its true count ``n_local``, a device scalar)
    all-gathered over ``t`` and then ``d``, and merged: (the global total
    as a device scalar, every gathered id sorted ascending, their counts
    int32), the same on every rank (device_step.py:390-424).  A read's
    targets interleave across ``t`` shards, so the merge sorts by global
    id; it holds every candidate whenever the total is within budget."""
    seg = torch.cat([n_local.reshape(1).to(torch.int64),
                     torch.where(valid, ids, -1),
                     torch.where(valid, cnt.to(torch.int64), -1)])
    segs = all_gather_cat(all_gather_cat(seg, mesh, "t"), mesh, "d")
    segs = segs.reshape(-1, 1 + 2 * budget)
    lane = torch.arange(budget, device=segs.device)
    ok = lane[None, :] < segs[:, :1].clamp(max=budget)
    ids_all = segs[:, 1 : 1 + budget][ok]
    cnt_all = segs[:, 1 + budget :][ok]
    order = torch.argsort(ids_all)
    return segs[:, 0].sum(), ids_all[order], cnt_all[order].to(torch.int32)


def sharded_compact(n_local: torch.Tensor, rows: torch.Tensor,
                    lanes: torch.Tensor, cnt: torch.Tensor,
                    valid: torch.Tensor, tg: torch.Tensor, T: int, row0: int,
                    budget: int, mesh
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A rank's first ``budget`` candidates as ``splice`` leaves them (rows
    of its batch slice starting at global read ``row0``, local target
    lanes, counts, the valid lanes) and its true count -> global flat ids
    (row0 + row) T + tg[lane], int64, merged across the mesh
    (``merge_segments``; device_step.py:353-387).  Lanes past the valid
    ones hold anything (a padding pair's block lies past ``tg``)."""
    ids = (row0 + rows.long()) * T + tg[torch.where(valid, lanes.long(), 0)]
    return merge_segments(n_local, ids, cnt, valid, budget, mesh)


def sharded_count_tail(bits_l: torch.Tensor, loc: torch.Tensor,
                       nk: torch.Tensor, lens: torch.Tensor,
                       cmin: torch.Tensor, thr_l: torch.Tensor, budget: int,
                       min_len: int, dedup_threshold: int, mesh,
                       n_reads: int, in_dedup: bool = False,
                       values: torch.Tensor | None = None) -> TailResult:
    """``count_tail_async`` on a mesh.  bits_l int32 [S+1, W_t] is this
    rank's word shard, thr_l int32 [32 W_t] its targets' floors, and loc /
    nk / lens / values its ``d`` slice (``batch_slice``) of a batch of
    ``n_reads`` reads; rows past ``n_reads`` are padding and give no
    candidate.  K2' counts the slice in read chunks compacted and spliced
    as on one device, the candidates turn into global flat ids and merge
    across ranks, and nk gathers over ``d``.  Returns count_tail's result
    for the whole batch, on every rank (this rank's row range in it):
    byte-identical whenever the budget holds, and meta[0] the true global
    total either way, so the 4x retry fires as it would there."""
    check_dedup(dedup_threshold)
    _d, t_size, di, ti = mesh_place(mesh)
    B_d = loc.shape[0]
    T_l = 32 * bits_l.shape[1]
    T = T_l * t_size
    n_valid = min(max(n_reads - di * B_d, 0), B_d)
    chunk_reads = max(1, COUNTS_BYTES // (4 * T_l))
    if in_dedup:
        (loc,), nk = dedup_planes(values, [loc], nk, dedup_threshold,
                                  bits_l.shape[0] - 1)
    cthr = read_floor(nk, lens, cmin, min_len, dedup_threshold, in_dedup)
    cthr[n_valid:] = FLOOR_NEVER
    loc, ranges = defer_rows(loc, bits_l.shape[0])
    parts = []
    for b0 in range(0, B_d, chunk_reads):
        b1 = min(B_d, b0 + chunk_reads)
        counts, mask = count_mask(bits_l, loc[b0:b1], cthr[b0:b1], thr_l,
                                  rows_checked=True)
        idx, cnt, n = compact_candidates(mask, counts, budget, 0)
        parts.append((n, idx + b0 * T_l, cnt))
        del counts, mask
    n, (idx, cnt), valid = splice(parts, budget)
    tg = global_target_ids(1, bits_l.shape[1], t_size, ti, bits_l.device)
    total, ids, cnt = sharded_compact(n, idx // T_l, idx % T_l, cnt, valid,
                                      tg, T, di * B_d, budget, mesh)
    nk_all = all_gather_cat(nk, mesh, "d")[:n_reads]
    meta, aux = pack_result(ids, cnt, nk_all, budget, n_reads * T, total)
    return TailResult(meta, aux, ranges, (bits_l.shape[0],))
