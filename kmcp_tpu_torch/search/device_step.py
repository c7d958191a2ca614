"""The count tail after device hashing: thresholds -> K2' -> compaction ->
the ``(meta, aux)`` result layout.

Port of the single-block count tail kmcp_tpu/search/device_step.py:559
``_make_count_tail`` (single-end, and with ``in_dedup`` the paired mode
that uniques each over-threshold read's windows first, search/dedup.py)
and of its compaction, ``_nonzero_asc`` / ``_compact_candidates``
(:97-137).  The kernel is K2' (search/count.py); thresholding inputs and
compaction are plain torch, as the JAX package leaves them to XLA.

On a ``("d", "t")`` DeviceMesh (parallel/sharding.py), ``sharded_count_tail``
is the mesh branch of ``_make_search_step`` (:892-987): each rank counts its
``d`` slice of the batch against its ``t`` shard of the target words,
compacts its own candidates to global flat ids (``sharded_compact``,
:353) and the packed segments, O(budget) whatever T is, are all-gathered
and merged by global id (``merge_segments``, :390), so every rank holds
the single-device tail's bytes whenever the budget holds.

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
import torch.distributed as dist

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
                budget: int, n_flat: int, total: int | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """(meta, aux) host arrays from the candidates of a batch: all of them,
    or the first ``budget`` of ``total`` (the merged segments of a mesh)."""
    n = int(ids.numel()) if total is None else total
    keep = min(int(ids.numel()), budget)
    meta = np.full(1 + budget, min(n_flat, 2**31 - 1), dtype=np.int32)
    meta[0] = min(n, 2**31 - 1)
    meta[1 : 1 + keep] = ids[:keep].cpu().numpy()
    aux = np.zeros(budget + nk.shape[0], dtype=np.uint16)
    aux[:keep] = cnt[:keep].clamp(0, 65535).cpu().numpy()
    aux[budget:] = nk.clamp(0, 65535).cpu().numpy()
    return meta, aux


def pack_result_split(q: torch.Tensor, t: torch.Tensor, cnt: torch.Tensor,
                      nk: torch.Tensor, budget: int, total: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(meta, aux) host arrays in the split-id layout from the candidates
    of a batch (all, or the first ``budget`` of ``total``): read ids q,
    global target ids t, counts cnt."""
    n = int(q.numel()) if total is None else total
    keep = min(int(q.numel()), budget)
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


def merge_segments(n_local: int, ids: torch.Tensor, cnt: torch.Tensor,
                   budget: int, mesh
                   ) -> tuple[int, torch.Tensor, torch.Tensor]:
    """Each rank's packed candidate segment (its first ``budget`` global
    flat ids int64, ascending, their counts, and its true count
    ``n_local``) all-gathered over ``t`` and then ``d``, and merged:
    (the global total, every gathered id sorted ascending, their counts
    int32), the same on every rank (device_step.py:390-424).  A read's
    targets interleave across ``t`` shards, so the merge sorts by global
    id; it holds every candidate whenever the total is within budget."""
    keep = min(n_local, budget)
    seg = torch.full((1 + 2 * budget,), -1, dtype=torch.int64,
                     device=ids.device)
    seg[0] = n_local
    seg[1 : 1 + keep] = ids[:keep]
    seg[1 + budget : 1 + budget + keep] = cnt[:keep]
    segs = all_gather_cat(all_gather_cat(seg, mesh, "t"), mesh, "d")
    segs = segs.reshape(-1, 1 + 2 * budget)
    total = int(segs[:, 0].sum())
    lane = torch.arange(budget, device=segs.device)
    valid = lane[None, :] < segs[:, :1].clamp(max=budget)
    ids_all = segs[:, 1 : 1 + budget][valid]
    cnt_all = segs[:, 1 + budget :][valid]
    order = torch.argsort(ids_all)
    return total, ids_all[order], cnt_all[order].to(torch.int32)


def sharded_compact(rows: torch.Tensor, lanes: torch.Tensor,
                    cnt: torch.Tensor, tg: torch.Tensor, T: int, row0: int,
                    budget: int, mesh
                    ) -> tuple[int, torch.Tensor, torch.Tensor]:
    """A rank's candidates (rows of its batch slice starting at global read
    ``row0``, local target lanes, counts; ascending by (row, lane)) ->
    global flat ids (row0 + row) T + tg[lane], int64, merged across the
    mesh (``merge_segments``; device_step.py:353-387)."""
    ids = (row0 + rows.long()) * T + tg[lanes.long()]
    return merge_segments(int(ids.numel()), ids, cnt, budget, mesh)


def sharded_count_tail(bits_l: torch.Tensor, loc: torch.Tensor,
                       nk: torch.Tensor, lens: torch.Tensor,
                       cmin: torch.Tensor, thr_l: torch.Tensor, budget: int,
                       min_len: int, dedup_threshold: int, mesh,
                       n_reads: int, in_dedup: bool = False,
                       values: torch.Tensor | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """``count_tail`` on a mesh.  bits_l int32 [S+1, W_t] is this rank's
    word shard, thr_l int32 [32 W_t] its targets' floors, and loc / nk /
    lens / values its ``d`` slice (``batch_slice``) of a batch of
    ``n_reads`` reads; rows past ``n_reads`` are padding and give no
    candidate.  K2' counts the slice in read chunks, the candidates
    compact to global flat ids and merge across ranks, and nk gathers over
    ``d``.  Returns count_tail's (meta, aux) for the whole batch, on every
    rank: byte-identical whenever the budget holds, and meta[0] the true
    global total either way, so the 4x retry fires as it would there."""
    if dedup_threshold >= 65535:
        raise ValueError(
            f"kmer_dedup_threshold {dedup_threshold} >= 65535 would "
            "overflow the uint16 aux layout"
        )
    _d, t_size, di, ti = mesh_place(mesh)
    B_d = loc.shape[0]
    W_t = bits_l.shape[1]
    T = 32 * W_t * t_size
    n_valid = min(max(n_reads - di * B_d, 0), B_d)
    chunk_reads = max(1, COUNTS_BYTES // (4 * 32 * W_t))
    if in_dedup:
        (loc,), nk = dedup_planes(values, [loc], nk, dedup_threshold,
                                  bits_l.shape[0] - 1)
    cthr = read_floor(nk, lens, cmin, min_len, dedup_threshold, in_dedup)
    cthr[n_valid:] = FLOOR_NEVER
    check_rows(loc, bits_l.shape[0])
    rows, lanes, cnts = [], [], []
    for b0 in range(0, B_d, chunk_reads):
        b1 = min(B_d, b0 + chunk_reads)
        counts, mask = count_mask(bits_l, loc[b0:b1], cthr[b0:b1], thr_l,
                                  rows_checked=True)
        r, t = mask_hits(mask)
        rows.append(r + b0)
        lanes.append(t)
        cnts.append(counts[r, t])
    tg = global_target_ids(1, W_t, t_size, ti, bits_l.device)
    total, ids, cnt = sharded_compact(torch.cat(rows), torch.cat(lanes),
                                      torch.cat(cnts), tg, T, di * B_d,
                                      budget, mesh)
    nk_all = all_gather_cat(nk, mesh, "d")[:n_reads]
    return pack_result(ids, cnt, nk_all, budget, n_reads * T, total)
