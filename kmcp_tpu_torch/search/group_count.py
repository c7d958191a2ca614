"""Pass 2 of the two-pass screened search as a grouped GEMM on the tensor
cores (kernel K6'), and the torch helpers that feed it.

Port of the Pallas kernel kmcp_tpu/search/pallas_count.py:823
``make_pallas_group_count``: counts[p, t] = sum_s U[p, s] *
bits01[pg[p], s, t], where U holds each pair's Bloom-row multiplicities
and bits01 the blocks' bits as 0/1, with the floors of K5' fused: the
wrapper takes and returns what ``pair_count`` does (counts at the pair's
own row, the threshold mask), from the unpacked slabs in place of the
packed rows.  The CUDA kernel is ``kmcp_tpu_torch/csrc/group_count.cu``
(u8 wgmma with U built in registers from the locations, exact for any
multiplicity); ``group_count_plain`` is the same function in plain PyTorch
(``build_u``, a float32 matmul per block, the floors), which CPU tensors
take.

Helpers, with their JAX counterparts:
  ``gemm_slabs``  the blocks' bits as u8 0/1 (``pack_gemm_blocks``,
                  pallas_count.py:801), pre-tiled for the kernel as [nb,
                  T/256, S_pad/128, 256, 128]: one 32 KB tile per (target
                  tile, k-step), K-major in the 128-byte swizzle that wgmma
                  reads, so a TMA bulk copy lands it ready; built once per
                  DB on the device: 470 MB at 32 blocks of 4,096 targets
                  and S_pad = 3,584;
  ``build_u``     the row-multiplicity matrix U (``_build_u_digit``,
                  device_screened.py:85) as an int32 ``scatter_add_`` cast
                  to bf16 (exact up to 256), for the plain version.
The JAX route's block sort and per-block padding to whole tiles
(device_screened.py:366-404) become ``block_order`` and tiles the kernel
finds itself from the block starts; no pair moves.
"""

from __future__ import annotations

import torch

from ..kernels._build import get_lib
from .pair_count import block_order, check_pairs, floor_mask

TILE = 128  # pairs per CUDA tile: 64 per consumer warpgroup of the kernel
BN = 256  # targets per tile (wgmma N)
BK = 128  # Bloom rows per k-step (a 128-byte row of u8)


def s_pad_for(s_block: int) -> int:
    """Slab rows: the block's rows plus the zero row that sentinel windows
    hit (local row s_block), rounded up to whole k-steps."""
    return -(-(s_block + 1) // BK) * BK


def _swizzle(tiles: torch.Tensor) -> torch.Tensor:
    """[..., rows, 128 bytes] -> the 128-byte swizzle: row r's 16-byte
    chunk c moves to chunk c ^ (r % 8).  Its own inverse."""
    shape = tiles.shape
    per = shape[-1] // 8  # elements a chunk
    x = tiles.reshape(*shape[:-1], 8, per)
    r = torch.arange(shape[-2], device=tiles.device)
    idx = (torch.arange(8, device=tiles.device)[None, :] ^ (r[:, None] & 7))
    idx = idx[:, :, None].expand(shape[-2], 8, per)
    return x.gather(-2, idx.expand_as(x)).reshape(shape)


def gemm_slabs(bits_ext: torch.Tensor, n_blocks: int, s_block: int,
               S_pad: int) -> torch.Tensor:
    """Row-stacked blocks int32 [nb*s_block+1, W] -> u8 [nb, NT, KT, 256,
    128] (NT = ceil(32 W / 256), KT = ceil(S_pad / 128)): tile [g, n, k]
    holds bit (row 128 k + c, target 256 n + r) of block g at row r, column
    c, swizzled (``_swizzle``); rows s_block and up and targets past 32 W
    are zero.  Unpacked one block at a time to bound the temporaries."""
    W = bits_ext.shape[1]
    T = 32 * W
    NT, KT = -(-T // BN), -(-S_pad // BK)
    dev = bits_ext.device
    out = torch.empty((n_blocks, NT, KT, BN, BK), dtype=torch.uint8,
                      device=dev)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    for g in range(n_blocks):
        b = bits_ext[g * s_block : (g + 1) * s_block]
        dense = torch.zeros((KT * BK, NT * BN), dtype=torch.uint8,
                            device=dev)
        dense[:s_block, :T] = ((b[..., None] >> shifts) & 1).reshape(
            s_block, T)
        tiles = dense.reshape(KT, BK, NT, BN).permute(2, 0, 3, 1)
        out[g] = _swizzle(tiles.contiguous())
    return out


def slab_dense(bits01: torch.Tensor, g: int) -> torch.Tensor:
    """Block g of ``gemm_slabs``'s tiles as float32 [KT*128, NT*256] (rows,
    targets)."""
    _nb, NT, KT, _bn, _bk = bits01.shape
    tiles = _swizzle(bits01[g]).float()  # [NT, KT, 256, 128]
    return tiles.permute(1, 3, 0, 2).reshape(KT * BK, NT * BN)


def build_u(loc: torch.Tensor, S_pad: int) -> torch.Tensor:
    """loc int [P, K] Bloom rows (< S_pad) -> U bf16 [P, S_pad], U[p, s] =
    the number of windows of row p at row s (counted in int32, then cast:
    exact up to 256)."""
    u = torch.zeros((loc.shape[0], S_pad), dtype=torch.int32,
                    device=loc.device)
    u.scatter_add_(1, loc.long(), torch.ones(loc.shape, dtype=torch.int32,
                                             device=loc.device))
    return u.to(torch.bfloat16)


def n_tiles(P: int, n_blocks: int, tile: int = TILE) -> int:
    """A bound of the pair tiles when each block's pairs fill whole tiles of
    their own: sum_g ceil(P_g / tile) <= P // tile + min(nb, P)."""
    return P // tile + min(n_blocks, P)


def _check(bits01, loc, pb, pg, cthr, thr, s_block):
    if bits01.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bits01.device}")
    if bits01.dtype != torch.uint8 or not bits01.is_contiguous():
        raise ValueError("bits01 must be contiguous uint8 (gemm_slabs)")
    for name, t in (("loc", loc), ("pb", pb), ("pg", pg), ("cthr", cthr),
                    ("thr", thr)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != bits01.device:
            raise ValueError(f"{name} is on {t.device}, bits01 on "
                             f"{bits01.device}")
    if bits01.dim() != 5 or tuple(bits01.shape[3:]) != (BN, BK):
        raise ValueError(f"bits01 must be [nb, NT, KT, {BN}, {BK}], got "
                         f"{tuple(bits01.shape)}")
    if loc.dim() != 2 or thr.dim() != 2 or pb.dim() != 1 or pb.shape != pg.shape:
        raise ValueError("loc must be [B, K], thr [nb, T], pb and pg [P]")
    nb, NT, KT = bits01.shape[:3]
    T = thr.shape[1]
    if thr.shape[0] != nb or T % 32 or -(-T // BN) != NT:
        raise ValueError(f"thr {tuple(thr.shape)} does not fit slabs of "
                         f"{nb} blocks x {NT} target tiles")
    if not 0 <= s_block < KT * BK:
        raise ValueError(f"s_block {s_block} outside the slabs' {KT * BK} rows")
    if tuple(cthr.shape) != (loc.shape[0],):
        raise ValueError(f"cthr must be [{loc.shape[0]}]")


def group_count(bits01: torch.Tensor, loc: torch.Tensor, pb: torch.Tensor,
                pg: torch.Tensor, cthr: torch.Tensor, thr: torch.Tensor,
                s_block: int, rows_checked: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """bits01 u8 [nb, NT, KT, 256, 128] (``gemm_slabs``), loc int32 [B, K]
    (rows in the block modulus, sentinel s_block), pb/pg int32 [P] (read
    and block of each pair), cthr int32 [B] per-read floor, thr int32 [nb,
    T] per-target floor -> (counts int32 [P, T], mask int32 [P, T/32]), as
    ``pair_count``: counts[p, t] = sum over the read's windows of bit t of
    their row in block pg[p], and bit j of mask word w set iff counts[p, 32
    w + j] >= max(thr[pg[p], 32 w + j], cthr[pb[p]]); a padding pair
    (pg[p] = nb) falls in no tile: mask row 0, counts row unwritten.  A CPU
    tensor takes ``group_count_plain``; a CUDA tensor launches the kernel
    (pairs in tiles of ``TILE``) or raises.  ``rows_checked=True`` skips
    ``check_pairs`` (device syncs) for a caller that has built pb and pg
    itself and checked or clamped loc (count.py ``defer_rows``)."""
    if bits01.device.type == "cpu":
        return group_count_plain(bits01, loc, pb, pg, cthr, thr, s_block)
    _check(bits01, loc, pb, pg, cthr, thr, s_block)
    if bits01.data_ptr() % 16:
        raise ValueError("bits01 must be 16-byte aligned")
    nb, NT, KT = bits01.shape[:3]
    T = thr.shape[1]
    if not rows_checked:
        check_pairs(loc, pb, pg, s_block, nb)
    P, K = pb.shape[0], loc.shape[1]
    counts = torch.empty((P, T), dtype=torch.int32, device=bits01.device)
    mask = torch.zeros((P, T // 32), dtype=torch.int32, device=bits01.device)
    if P == 0:
        return counts, mask
    order, seg = block_order(pg, nb)
    stream = torch.cuda.current_stream(bits01.device).cuda_stream
    rc = get_lib().kmcp_group_count(
        bits01.data_ptr(), nb, NT, KT, T, s_block, loc.data_ptr(), K,
        pb.data_ptr(), order.data_ptr(), seg.data_ptr(), n_tiles(P, nb),
        cthr.data_ptr(), thr.data_ptr(), counts.data_ptr(), mask.data_ptr(),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"group_count kernel launch failed: cuda error {rc}")
    group_count.launches += 1
    return counts, mask


group_count.launches = 0


def group_count_plain(bits01: torch.Tensor, loc: torch.Tensor,
                      pb: torch.Tensor, pg: torch.Tensor, cthr: torch.Tensor,
                      thr: torch.Tensor, s_block: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: U by ``build_u`` (sentinel windows on the
    zero row s_block), one float32 matmul per block (TF32 off: it would
    round; float32 sums of these integers are exact below 2^24), then the
    floors; padding pairs count 0 and set no bit."""
    _check(bits01, loc, pb, pg, cthr, thr, s_block)
    nb, _NT, KT = bits01.shape[:3]
    check_pairs(loc, pb, pg, s_block, nb)
    T = thr.shape[1]
    P = pb.shape[0]
    counts = torch.zeros((P, T), dtype=torch.int32, device=bits01.device)
    mask = torch.zeros((P, T // 32), dtype=torch.int32,
                       device=bits01.device)
    real = torch.nonzero(pg < nb).squeeze(1)  # padding pairs count nothing
    b, g_r = pb[real].long(), pg[real].long()
    u = build_u(loc[b], KT * BK)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for g in torch.unique(g_r).tolist():
            r = torch.nonzero(g_r == g).squeeze(1)
            counts[real[r]] = (u[r].float() @ slab_dense(bits01, g)[:, :T]
                               ).to(torch.int32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    mask[real] = floor_mask(counts[real], thr[g_r], cthr[b])
    return counts, mask
