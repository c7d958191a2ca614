"""Minimizer and closed-syncmer window selection on the device.

Port of kmcp_tpu/search/sketch_device.py (``_shift_up`` :33,
``_shift_down`` :44, ``_lex_take`` :55, ``_window_lexmin`` :67,
``_mask_invalid`` :90, ``minimizer_selected`` :100, ``syncmer_selected``
:137, ``apply_selection`` :161 and ``make_sketch_transform`` :185) as torch
ops on the read-major layout [B, K] (the JAX planes are [K, B]; shifts run
along dim 1).  The input is K1''s int64 value plane (``hash_loc(...,
values=True)``): each window's 64-bit canonical hash, its bits held in
int64, and 0 for an invalid window.

KMCP takes unsigned minima, so every compare runs on keys with bit 63
flipped (``v ^ _BIT63``), whose signed order is the values' unsigned
order; an invalid window's key is the largest (u64::MAX), so it never wins
a minimum.  Ties go to the lower position.  As in the JAX package, a window
whose canonical hash is exactly 0 counts as invalid (probability 2^-64 a
window), where the host's selection lets it take part in minima before it
is dropped.  The FracMinHash scale filter applies after selection, as on
the host (``mins = scale_filter(mins)``).
"""

from __future__ import annotations

import torch

from .hash_loc import _BIT63, _signed

_KEY_MAX = (1 << 63) - 1  # the key of u64::MAX: invalid windows
_POS_FILL = 2**30  # the position of a window past the row's end


def _shift_up(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x[:, i] <- x[:, i + d], the tail filled (all of it for d >= K)."""
    if d == 0:
        return x
    d = min(d, x.shape[1])
    pad = torch.full((x.shape[0], d), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, d:], pad], dim=1)


def _shift_down(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x[:, i] <- x[:, i - d], the head filled (all of it for d >= K)."""
    if d == 0:
        return x
    d = min(d, x.shape[1])
    pad = torch.full((x.shape[0], d), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:, : x.shape[1] - d]], dim=1)


def _lex_take(ak, ap, bk, bp):
    """Elementwise lexicographic min of (key, pos) pairs."""
    tb = (bk < ak) | ((bk == ak) & (bp < ap))
    return torch.where(tb, bk, ak), torch.where(tb, bp, ap)


def _window_lexmin(key: torch.Tensor, w: int):
    """(mk, mp)[:, i] = lexicographic min of (key, pos) over the window
    [i, i + w) along dim 1 (log-doubling span composition)."""
    B, K = key.shape
    mp = torch.arange(K, dtype=torch.int32, device=key.device).expand(B, K)
    mk = key
    span = 1
    while span < w:
        d = min(span, w - span)
        mk, mp = _lex_take(mk, mp, _shift_up(mk, d, _KEY_MAX),
                           _shift_up(mp, d, _POS_FILL))
        span += d
    return mk, mp


def _mask_invalid(vals: torch.Tensor):
    """int64 values -> (keys in unsigned order with the kernel's 0 invalid
    encoding remapped to u64::MAX, the invalid mask)."""
    inv = vals == 0
    return torch.where(inv, _KEY_MAX, vals ^ _BIT63), inv


def _windows(lens: torch.Tensor, k: int, K: int):
    """(windows per read [B, 1], positions [1, K])."""
    n = (lens.to(torch.int64) - (k - 1)).clamp(min=0)[:, None]
    return n, torch.arange(K, dtype=torch.int64, device=lens.device)[None, :]


def minimizer_selected(vals: torch.Tensor, lens: torch.Tensor, k: int,
                       w: int) -> torch.Tensor:
    """int64 value plane [B, K] + read lengths [B] -> selected bool [B, K]
    (the device twin of sketches.minimizer_sketch; the scale applies
    later).  A position is selected when any in-range window of w windows
    has its first argmin there; a read of fewer than w windows selects its
    first argmin only when every one of its windows is valid."""
    B, K = vals.shape
    key, inv = _mask_invalid(vals)
    n, pos = _windows(lens, k, K)

    # windows i in [0, n - w]; a window whose min is MAX was wholly invalid
    mk, mp = _window_lexmin(key, w)
    wv = (pos <= n - w) & (mk != _KEY_MAX)
    sel = torch.zeros((B, K), dtype=torch.bool, device=vals.device)
    for d in range(w):
        sel |= _shift_down(wv, d, False) & (_shift_down(mp, d, -1) == pos)

    # reads of n < w windows: one window over [0, n)
    in_read = pos < n
    n_inv = (inv & in_read).sum(dim=1)
    first = torch.where(in_read, key, _KEY_MAX).argmin(dim=1)
    sel_short = (pos == first[:, None]) & (n_inv == 0)[:, None] & (n > 0)
    return torch.where(n >= w, sel, sel_short)


def syncmer_selected(vals: torch.Tensor, s_vals: torch.Tensor,
                     lens: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """k-mer value plane [B, K] + s-mer value plane [B, K_s >= K + k - s]
    -> selected bool [B, K] (the device twin of
    sketches.closed_syncmer_sketch): a valid k-mer whose smallest s-mer is
    its first or its last."""
    K = vals.shape[1]
    w = k - s + 1
    skey, _ = _mask_invalid(s_vals)
    mk = _window_lexmin(skey, w)[0][:, :K]
    first = skey[:, :K]
    last = _shift_up(skey, w - 1, _KEY_MAX)[:, :K]
    sel = (vals != 0) & ((mk == first) | (mk == last))
    n, pos = _windows(lens, k, K)
    return sel & (pos < n)


def apply_selection(selected: torch.Tensor, vals: torch.Tensor,
                    loc: torch.Tensor, num_sigs: int, max_hash: int):
    """Selected mask + scale filter -> (loc int32 [B, K, h] with the windows
    not kept at the sentinel row ``num_sigs``, nk int32 [B], keep bool
    [B, K]).  The device query then carries the host's sketch multiset."""
    in_scale = (vals ^ _BIT63) <= (_signed(max_hash) ^ _BIT63)
    keep = selected & in_scale
    out = torch.where(keep[..., None], loc, num_sigs).to(loc.dtype)
    return out, keep.sum(dim=1, dtype=torch.int32), keep


def sketch_transform(kind: str, k: int, param: int, num_sigs: int,
                     max_hash: int, loc: torch.Tensor, vals: torch.Tensor,
                     s_vals: torch.Tensor | None, lens: torch.Tensor):
    """Window selection + scale filter + sentinel masking of a sketch DB's
    streaming path -> (loc', nk', vals'): ``kind`` "minimizer" (``param``
    = w) or "syncmer" (``param`` = s, ``s_vals`` K1''s value plane at
    k = s); K1' hashed at k unscaled with values.  Windows not kept read 0
    in vals'."""
    if kind == "minimizer":
        sel = minimizer_selected(vals, lens, k, param)
    elif kind == "syncmer":
        sel = syncmer_selected(vals, s_vals, lens, k, param)
    else:
        raise ValueError(f"unknown sketch kind {kind!r}")
    loc, nk, keep = apply_selection(sel, vals, loc, num_sigs, max_hash)
    return loc, nk, torch.where(keep, vals, 0)
