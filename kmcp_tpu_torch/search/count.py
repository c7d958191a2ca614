"""Bloom-row gather + row-AND + positional popcount + threshold mask
(kernel K2').

Port of the dense count family kmcp_tpu/search/pallas_count.py:146
``make_pallas_count`` (ring, ``masked=``), :363
``make_pallas_count_resident`` and :488 ``make_pallas_count_masked``: one
entry point, ``kmcp_tpu_torch/csrc/count_mask.cu``, serves all three and
every row width and count, through CUDA variants it picks from the
shapes (``VARIANTS``: a shared-memory tile of every row for wide rows of
up to 5,077 rows, a ring of streamed row segments for taller ones, a
gather for rows narrower than 8 words).  Targets are in natural order
(t = 32 w + j); the TPU's bit-major lane layout is not ported.  ``count_mask_plain`` is the same
function in plain PyTorch, which CPU tensors take.

Bloom words travel as int32 views of the uint32 words (torch lacks most
uint32 ops); the kernel reinterprets them.  Row ``S`` (the last) of
``bits`` is the all-zero sentinel that invalid windows point at.
"""

from __future__ import annotations

import torch

from ..kernels._build import get_lib


def _check(bits, loc, cthr, thr):
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bits.device}")
    for name, t in (("bits", bits), ("loc", loc), ("cthr", cthr),
                    ("thr", thr)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != bits.device:
            raise ValueError(f"{name} is on {t.device}, bits on {bits.device}")
    if bits.dim() != 2 or loc.dim() != 3:
        raise ValueError("bits must be [S_ext, W] and loc [B, K, h]")
    B, _K, h = loc.shape
    W = bits.shape[1]
    if not 1 <= h <= 4:
        raise ValueError(f"num_hashes must be in 1..4, got {h}")
    if tuple(cthr.shape) != (B,) or tuple(thr.shape) != (32 * W,):
        raise ValueError(
            f"cthr must be [{B}] and thr [{32 * W}], got "
            f"{tuple(cthr.shape)} and {tuple(thr.shape)}"
        )


def check_range(lo: int, hi: int, n_rows: int):
    """Raise unless rows lo..hi lie in 0..n_rows-1."""
    if lo < 0 or hi >= n_rows:
        raise ValueError(f"loc holds rows {lo}..{hi} outside 0..{n_rows - 1}")


def row_range(loc: torch.Tensor) -> torch.Tensor:
    """(min, max) of ``loc`` as an int32 [2] tensor on its device ([0, 0]
    when empty), computed without waiting for the device."""
    if not loc.numel():
        return torch.zeros(2, dtype=torch.int32, device=loc.device)
    return torch.stack(torch.aminmax(loc)).to(torch.int32)


def defer_rows(loc: torch.Tensor, n_rows: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loc clamped into 0..n_rows-1, loc's ``row_range``): what a
    streaming tail gathers with while its row check waits for the host.
    The tail carries the range in its result and ``check_range`` raises on
    it there; meanwhile no kernel reads a row outside the table.  One pass
    over loc, no device sync."""
    return loc.clamp(0, n_rows - 1), row_range(loc)


def check_rows(loc: torch.Tensor, n_rows: int):
    """Raise unless every row in ``loc`` lies in 0..n_rows-1.  On a CUDA
    tensor this waits for the device, so callers that launch K2' on many
    slices of one ``loc`` check it once, and the streaming tails defer it
    (``defer_rows``)."""
    if loc.numel():
        lo, hi = row_range(loc).tolist()
        check_range(lo, hi, n_rows)


# The variants kmcp_count_mask and kmcp_pair_count pick, by the code their
# ``*_variant`` entry points return (csrc/geometry.cuh ``geo::Variant``).
VARIANTS = ("gather", "slice", "ring")


def variant_name(code: int, what: str) -> str:
    """The name of variant ``code``; raises on a failed device query (a
    negative code: minus the CUDA error)."""
    if code < 0:
        raise RuntimeError(f"{what} device query failed: cuda error {-code}")
    return VARIANTS[code]


def count_mask_variant(W: int, S_ext: int, h: int) -> str:
    """The variant K2' runs for rows of W words, S_ext of them, h hashes,
    on the current CUDA device."""
    return variant_name(get_lib().kmcp_count_mask_variant(W, S_ext, h),
                        "count_mask")


def count_mask(bits: torch.Tensor, loc: torch.Tensor, cthr: torch.Tensor,
               thr: torch.Tensor, rows_checked: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """bits int32 [S_ext, W], loc int32 [B, K, h] (rows < S_ext), cthr int32
    [B] per-read floor, thr int32 [32 W] per-target floor -> (counts int32
    [B, 32 W], mask int32 [B, W] with bit j of word w set iff
    counts[b, 32 w + j] >= max(thr[32 w + j], cthr[b])).  A CPU tensor takes
    ``count_mask_plain``; a CUDA tensor launches the kernel or raises.
    ``rows_checked=True`` skips the row-range check (a device sync) for a
    caller that has checked ``loc`` already or clamped it (``defer_rows``)."""
    if bits.device.type == "cpu":
        return count_mask_plain(bits, loc, cthr, thr)
    _check(bits, loc, cthr, thr)
    if not rows_checked:
        check_rows(loc, bits.shape[0])
    B, K, h = loc.shape
    W = bits.shape[1]
    counts = torch.empty((B, 32 * W), dtype=torch.int32, device=bits.device)
    mask = torch.empty((B, W), dtype=torch.int32, device=bits.device)
    variant = count_mask_variant(W, bits.shape[0], h)
    stream = torch.cuda.current_stream(bits.device).cuda_stream
    rc = get_lib().kmcp_count_mask(
        bits.data_ptr(), W, bits.shape[0], loc.data_ptr(), B, K, h,
        cthr.data_ptr(), thr.data_ptr(), counts.data_ptr(), mask.data_ptr(),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"count_mask kernel launch failed: cuda error {rc}")
    count_mask.launches += 1
    count_mask.by_variant[variant] += 1
    return counts, mask


count_mask.launches = 0
count_mask.by_variant = dict.fromkeys(VARIANTS, 0)


def count_mask_plain(bits: torch.Tensor, loc: torch.Tensor,
                     cthr: torch.Tensor, thr: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: per window gather -> AND -> unpack bits ->
    add, then threshold."""
    _check(bits, loc, cthr, thr)
    check_rows(loc, bits.shape[0])
    B, K, h = loc.shape
    W = bits.shape[1]
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    counts = torch.zeros((B, W, 32), dtype=torch.int32, device=bits.device)
    for i in range(K):
        x = bits[loc[:, i, 0].long()]
        for jj in range(1, h):
            x = x & bits[loc[:, i, jj].long()]
        # arithmetic shift then & 1 reads bit 31 of negative words right
        counts += (x[..., None] >> shifts) & 1
    counts = counts.reshape(B, 32 * W)
    floor = torch.maximum(thr[None, :], cthr[:, None])
    ok = (counts >= floor).reshape(B, W, 32).long()
    words = (ok << shifts.long()).sum(dim=2)
    mask = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return counts, mask
