"""In-step k-mer dedup of paired streaming: per read, one window per 64-bit
value, for reads whose raw window count exceeds the dedup threshold.

Port of kmcp_tpu/search/device_step.py:458 ``_dedup_value_planes``, the
reference's >256-k-mer unique step (util-db-search.go:874-908) on the
device.  Reads at or under the threshold keep their duplicate windows, as
the reference does.  The JAX package sorts with ``lax.sort`` (no Pallas
kernel); the port uniques on the card with K8' (``csrc/dedup.cu``: a
hash table a row in shared memory, no sort), and its plain version,
``dedup_planes_plain``, sorts with ``torch.sort`` for CPU tensors.

While tracing is on, each call adds the rows it uniqued and the windows it
dropped to its device's tally (int64 [2], on the device: K8' adds to it
once a CTA); ``take_tally`` reads the tallies once the work is done.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels._build import get_lib
from ..utils import trace

# device -> int64 [2]: rows uniqued, windows dropped, while tracing is on
_TALLY: dict = {}


def _tally(device) -> torch.Tensor:
    t = _TALLY.get(device)
    if t is None:
        t = _TALLY[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return t


def take_tally() -> tuple[int, int]:
    """(rows uniqued, windows dropped) over every device since the last
    call, and the tallies zeroed.  Reads each device's tally once, so it
    waits for the card: call it after the work is drained."""
    got = [t.tolist() for t in _TALLY.values()]
    _TALLY.clear()
    return sum(g[0] for g in got), sum(g[1] for g in got)


def _per_plane(sentinels, n: int) -> list:
    return (list(sentinels) if isinstance(sentinels, (list, tuple))
            else [sentinels] * n)


def dedup_planes(vals: torch.Tensor, locs: list[torch.Tensor],
                 nk: torch.Tensor, threshold: int, sentinels
                 ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """vals int64 [B, K] window values (0 for invalid windows; a valid
    window never hashes to 0), locs location planes int32 [B, K] or
    [B, K, h], nk int32 [B] raw valid-window counts, ``sentinels`` one for
    every plane or one per plane, each an int or one per column -> (planes,
    nk).

    In every read with nk > threshold, each repeated value keeps its first
    window (the lowest index) and its later windows point at the plane's
    sentinel; such a read's nk loses the windows dropped, which makes it
    its count of distinct values.  Windows keep their places, so the result
    is the same on every run and device.

    A CPU tensor takes ``dedup_planes_plain``; a CUDA tensor launches K8'
    (one or two planes, any K, at most 32 per-column sentinels a plane),
    which updates the planes and nk in place and returns them, or raises.
    ``dedup_planes.launches`` counts its launches; with tracing on, so does
    the counter ``dedup_launches``."""
    if vals.device.type == "cpu":
        return dedup_planes_plain(vals, locs, nk, threshold, sentinels)
    sents = [torch.as_tensor(s).reshape(-1).tolist()
             for s in _per_plane(sentinels, len(locs))]
    _check(vals, locs, nk, sents)
    lib = get_lib()
    B, K = vals.shape
    dev = vals.device
    n_scratch = lib.kmcp_dedup_scratch(B, K)
    scratch = (torch.empty(n_scratch, dtype=torch.uint8, device=dev)
               if n_scratch else None)
    tally = _tally(dev) if trace.TRACER.on else None
    planes = []  # two (pointer, h, sentinels, their count), unused last
    for loc, s in zip(locs, sents):
        planes += [loc.data_ptr(), _columns(loc), (ctypes.c_int * len(s))(*s),
                   len(s)]
    planes += [None, 1, None, 0] * (2 - len(locs))
    rc = lib.kmcp_dedup(
        vals.data_ptr(), nk.data_ptr(), B, K, threshold, len(locs), *planes,
        scratch.data_ptr() if scratch is not None else None, n_scratch,
        tally.data_ptr() if tally is not None else None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dedup kernel launch failed: cuda error {rc}")
    dedup_planes.launches += 1
    if trace.TRACER.on:
        trace.count("dedup_launches", 1)
    return locs, nk


dedup_planes.launches = 0


def _columns(loc: torch.Tensor) -> int:
    return loc.shape[2] if loc.dim() == 3 else 1


def _check(vals, locs, nk, sents) -> None:
    if vals.device.type != "cuda":
        raise ValueError(f"the dedup kernel needs a CUDA device, got "
                         f"{vals.device}")
    if vals.dtype != torch.int64 or vals.dim() != 2:
        raise ValueError(f"vals must be int64 [B, K], got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if not 1 <= len(locs) <= 2:
        raise ValueError(f"the dedup kernel takes one or two planes, got "
                         f"{len(locs)}")
    if tuple(nk.shape) != vals.shape[:1]:
        raise ValueError(f"nk must be [{vals.shape[0]}], got "
                         f"{tuple(nk.shape)}")
    for name, t in [("nk", nk)] + [(f"plane {p}", loc)
                                   for p, loc in enumerate(locs)]:
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous() or t.device != vals.device:
            raise ValueError(f"{name} must be contiguous on {vals.device}")
    if not vals.is_contiguous():
        raise ValueError("vals must be contiguous")
    for p, (loc, s) in enumerate(zip(locs, sents)):
        h = _columns(loc)
        if loc.dim() not in (2, 3) or tuple(loc.shape[:2]) != tuple(
                vals.shape):
            raise ValueError(f"plane {p} must be [B, K] or [B, K, h] with "
                             f"[B, K] = {tuple(vals.shape)}, got "
                             f"{tuple(loc.shape)}")
        if len(s) not in (1, h) or len(s) > 32:
            raise ValueError(f"plane {p}: {len(s)} sentinels for {h} "
                             "columns (1, or one a column up to 32)")


def dedup_planes_plain(vals: torch.Tensor, locs: list[torch.Tensor],
                       nk: torch.Tensor, threshold: int, sentinels
                       ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """``dedup_planes`` in plain PyTorch, on any device, into new tensors:
    a stable sort of each read's values puts a value's copies side by side
    in window order, every copy after the first is a duplicate, and the
    duplicates scatter back to their windows.  Signed int64 order serves
    as well as unsigned."""
    v_s, order = torch.sort(vals, dim=1, stable=True)
    dup = torch.zeros_like(v_s, dtype=torch.bool)
    dup[:, 1:] = (v_s[:, 1:] == v_s[:, :-1]) & (v_s[:, 1:] != 0)
    apply = nk > threshold
    drop = torch.zeros_like(dup).scatter_(1, order, dup) & apply[:, None]
    n_drop = drop.sum(dim=1, dtype=nk.dtype)
    if trace.TRACER.on:
        _tally(vals.device).add_(torch.stack([apply.sum(), n_drop.sum()]))
    out = []
    for loc, s in zip(locs, _per_plane(sentinels, len(locs))):
        if not isinstance(s, int):
            s = torch.as_tensor(s, dtype=loc.dtype, device=loc.device)
        d = drop if loc.dim() == 2 else drop[..., None]
        out.append(torch.where(d, s, loc).to(loc.dtype))
    return out, nk - n_drop
