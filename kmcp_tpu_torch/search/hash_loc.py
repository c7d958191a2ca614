"""Rolling canonical ntHash1 -> Bloom row locations (kernel K1').

Port of the Pallas kernel kmcp_tpu/search/pallas_hash.py:36
``make_pallas_hash_loc`` (loc planes, per-read valid-window count and, with
``screen_sigs``, the screen plane of the two-pass screened search; with
``values``, the window values of ``emit_values``).  The CUDA kernel is
``kmcp_tpu_torch/csrc/hash_loc.cu`` (its per-window arithmetic in
``csrc/nthash_window.cuh``); ``hash_loc_plain`` is the same function in
plain PyTorch, which CPU tensors take and which the tests and the chip
smoke hold the kernel against.

Output layout is read-major: ``loc`` int32 [B, K, h] (K = lmax - k + 1
windows, invalid windows -> sentinel row ``num_sigs``) and ``nk`` int32 [B];
with ``screen_sigs`` > 0 (one hash only, as ``_screen_geometry`` requires,
kmcp_tpu/search/device_screened.py:38) also ``loc_u`` int32 [B, K], the
full 64-bit ``h mod screen_sigs`` of the same windows with sentinel
``screen_sigs`` (pallas_hash.py:282-286); with ``values`` also ``vals``
int64 [B, K], each valid window's 64-bit canonical hash (its bits; values
past 2^63 read negative) and 0 for invalid windows: ``emit_values``'s
(hi, lo) planes joined as (hi << 32) | lo (pallas_hash.py:287-289), the
dedup key of paired streaming (search/dedup.py).
"""

from __future__ import annotations

import torch

from ..kernels._build import get_lib
from ..kmer.nthash import SEED_A, SEED_C, SEED_G, SEED_T

_U64 = (1 << 64) - 1
_BIT63 = -(1 << 63)  # int64 with only bit 63 set: flips unsigned order


def _check(reads: torch.Tensor, k: int, num_sigs: int, num_hashes: int,
           screen_sigs: int):
    if reads.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {reads.device}")
    if reads.dtype != torch.uint8 or reads.dim() != 2:
        raise ValueError(f"reads must be uint8 [B, lmax], got {reads.dtype} "
                         f"{tuple(reads.shape)}")
    if not reads.is_contiguous():
        raise ValueError("reads must be contiguous")
    if not 1 <= num_hashes <= 4:
        raise ValueError(f"num_hashes must be in 1..4, got {num_hashes}")
    if not 1 <= k <= reads.shape[1]:
        raise ValueError(f"k={k} needs 1 <= k <= lmax={reads.shape[1]}")
    if not 1 <= num_sigs < 2**31:
        raise ValueError(f"num_sigs={num_sigs} must be in 1..2^31-1")
    if not 0 <= screen_sigs < 2**31:
        raise ValueError(f"screen_sigs={screen_sigs} must be in 0..2^31-1")
    if screen_sigs and num_hashes != 1:
        raise ValueError("the screen plane needs num_hashes == 1")


def _outputs(loc, nk, loc_u, vals) -> tuple:
    """(loc, nk), then loc_u and vals where they were asked for."""
    return (loc, nk) + tuple(t for t in (loc_u, vals) if t is not None)


def hash_loc(reads: torch.Tensor, k: int, num_sigs: int, max_hash: int,
             num_hashes: int = 1, screen_sigs: int = 0,
             values: bool = False) -> tuple:
    """reads uint8 [B, lmax] (zero padded ASCII) -> (loc int32
    [B, lmax-k+1, num_hashes], nk int32 [B]), then loc_u int32
    [B, lmax-k+1] when ``screen_sigs`` > 0 and vals int64 [B, lmax-k+1]
    when ``values`` (one launch emits every plane).  A CPU tensor takes
    ``hash_loc_plain``; a CUDA tensor launches the kernel or raises."""
    if reads.device.type == "cpu":
        return hash_loc_plain(reads, k, num_sigs, max_hash, num_hashes,
                              screen_sigs, values)
    _check(reads, k, num_sigs, num_hashes, screen_sigs)
    B, lmax = reads.shape
    K = lmax - k + 1
    dev = reads.device
    loc = torch.empty((B, K, num_hashes), dtype=torch.int32, device=dev)
    nk = torch.empty((B,), dtype=torch.int32, device=dev)
    loc_u = (torch.empty((B, K), dtype=torch.int32, device=dev)
             if screen_sigs else None)
    vals = torch.empty((B, K), dtype=torch.int64, device=dev) if values else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = get_lib().kmcp_hash_loc(
        reads.data_ptr(), B, lmax, k, num_sigs, max_hash & _U64, num_hashes,
        int(SEED_A), int(SEED_C), int(SEED_G), int(SEED_T), screen_sigs,
        loc.data_ptr(), ptr(loc_u), nk.data_ptr(), ptr(vals), stream,
    )
    if rc != 0:
        raise RuntimeError(f"hash_loc kernel launch failed: cuda error {rc}")
    hash_loc.launches += 1
    return _outputs(loc, nk, loc_u, vals)


hash_loc.launches = 0


def _signed(v: int) -> int:
    v &= _U64
    return v - (1 << 64) if v >= 1 << 63 else v


def _lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 lanes by 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rol(x: torch.Tensor, r: int) -> torch.Tensor:
    r %= 64
    return x if r == 0 else (x << r) | _lsr(x, 64 - r)


def _ror(x: torch.Tensor, r: int) -> torch.Tensor:
    return _rol(x, (64 - r % 64) % 64)


def _seed_tables(device):
    """Per-byte forward seed, complement seed and validity, folding case
    with & 0xDF as the kernels do."""
    fwd = [0] * 256
    comp = [0] * 256
    ok = [False] * 256
    pairs = {"A": (SEED_A, SEED_T), "C": (SEED_C, SEED_G),
             "G": (SEED_G, SEED_C), "T": (SEED_T, SEED_A)}
    for byte in range(256):
        base = chr(byte & 0xDF)
        if base in pairs:
            fwd[byte] = _signed(int(pairs[base][0]))
            comp[byte] = _signed(int(pairs[base][1]))
            ok[byte] = True
    as_t = lambda v, dt: torch.tensor(v, dtype=dt, device=device)  # noqa: E731
    return as_t(fwd, torch.int64), as_t(comp, torch.int64), as_t(ok, torch.bool)


def _mod_u64(h: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned 64-bit lanes (held in int64) modulo m < 2^31, through the
    32-bit halves: every intermediate stays below 2^62."""
    hi, lo = _lsr(h, 32), h & 0xFFFFFFFF
    return ((hi % m) * ((1 << 32) % m) + lo % m) % m


def hash_loc_plain(reads: torch.Tensor, k: int, num_sigs: int, max_hash: int,
                   num_hashes: int = 1, screen_sigs: int = 0,
                   values: bool = False) -> tuple:
    """Plain PyTorch version of the kernel: a loop over positions,
    vectorised across reads.  torch has no unsigned 64-bit shifts or
    compares, so the values live in int64 with masked shifts and
    bit-63-flipped compares."""
    _check(reads, k, num_sigs, num_hashes, screen_sigs)
    dev = reads.device
    B, lmax = reads.shape
    fwd_tab, comp_tab, ok_tab = _seed_tables(dev)
    idx = reads.long()
    s_f, s_c, okm = fwd_tab[idx], comp_tab[idx], ok_tab[idx]
    mh = _signed(max_hash) ^ _BIT63
    fh = torch.zeros(B, dtype=torch.int64, device=dev)
    rh = torch.zeros_like(fh)
    run = torch.zeros(B, dtype=torch.int32, device=dev)
    nk = torch.zeros(B, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(fh)
    j_off = torch.arange(num_hashes, dtype=torch.int64, device=dev)
    locs, locs_u, vals = [], [], []
    for i in range(lmax):
        ok = okm[:, i]
        run = torch.where(ok, run + 1, 0)
        if i >= k:
            use_out = run > k
            out_f = torch.where(use_out, _rol(s_f[:, i - k], k), zero)
            out_c = torch.where(use_out, _ror(s_c[:, i - k], 1), zero)
        else:
            out_f = out_c = zero
        fh = torch.where(ok, _rol(fh, 1) ^ out_f ^ s_f[:, i], zero)
        rh = torch.where(ok, _ror(rh, 1) ^ out_c ^ _rol(s_c[:, i], k - 1),
                         zero)
        if i < k - 1:
            continue
        hv = torch.where((rh ^ _BIT63) < (fh ^ _BIT63), rh, fh)
        valid = (run >= k) & (hv != 0) & ((hv ^ _BIT63) <= mh)
        if num_hashes == 1:
            loc = _mod_u64(hv, num_sigs)[:, None]
        else:
            hi, lo = _lsr(hv, 32), hv & 0xFFFFFFFF
            v = (hi[:, None] + lo[:, None] * j_off) & 0xFFFFFFFF
            loc = v % num_sigs
        locs.append(torch.where(valid[:, None], loc, num_sigs))
        if screen_sigs:
            locs_u.append(torch.where(valid, _mod_u64(hv, screen_sigs),
                                      screen_sigs))
        if values:
            vals.append(torch.where(valid, hv, zero))
        nk += valid.to(torch.int32)
    loc = torch.stack(locs, dim=1).to(torch.int32)
    loc_u = (torch.stack(locs_u, dim=1).to(torch.int32) if screen_sigs
             else None)
    return _outputs(loc, nk, loc_u,
                    torch.stack(vals, dim=1) if values else None)
