"""Pass 2 of the two-pass screened search as a grouped GEMM on the tensor
cores (kernel K6'), and the torch helpers that feed it.

Port of the Pallas kernel kmcp_tpu/search/pallas_count.py:823
``make_pallas_group_count``: counts[p, t] = sum_s U[p, s] *
bits01[blk(p), s, t], where U holds each pair's Bloom-row multiplicities
(bf16, exact up to 256) and bits01 the blocks' bits unpacked to 0/1 bytes.
The CUDA kernel is ``kmcp_tpu_torch/csrc/group_count.cu``;
``group_count_plain`` is the same function in plain PyTorch, which CPU
tensors take.

Helpers, with their JAX counterparts:
  ``gemm_slabs``  the unpacked [nb, S_pad, 32 W] int8 block slabs
                  (``pack_gemm_blocks``, pallas_count.py:801), built once
                  per DB on the device: 470 MB at 32 blocks of 4,096
                  targets and S_pad = 3,584;
  ``build_u``     the row-multiplicity matrix U (``_build_u_digit``,
                  device_screened.py:85) as an int32 ``scatter_add_`` cast
                  to bf16 (the digit one-hot product was an MXU device);
  ``block_tiles`` the block sort and per-block padding to whole tiles
                  (device_screened.py:366-404).
"""

from __future__ import annotations

import torch

from ..kernels._build import get_lib

TILE = 64  # pairs per tile: PT in csrc/group_count.cu
S_ALIGN = 32  # S_pad granularity: BK in csrc/group_count.cu


def s_pad_for(s_block: int) -> int:
    """Slab rows: the block's rows plus the zero row that sentinel windows
    hit (local row s_block), rounded up to the kernel's depth step."""
    return -(-(s_block + 1) // S_ALIGN) * S_ALIGN


def gemm_slabs(bits_ext: torch.Tensor, n_blocks: int, s_block: int,
               S_pad: int) -> torch.Tensor:
    """Row-stacked blocks int32 [nb*s_block+1, W] -> int8 [nb, S_pad, 32 W]
    of 0/1, target 32 w + j of block g at [g, :, 32 w + j]; rows s_block
    and up are zero.  Unpacked one block at a time to bound the
    temporaries."""
    W = bits_ext.shape[1]
    out = torch.zeros((n_blocks, S_pad, 32 * W), dtype=torch.int8,
                      device=bits_ext.device)
    shifts = torch.arange(32, dtype=torch.int32, device=bits_ext.device)
    for g in range(n_blocks):
        b = bits_ext[g * s_block : (g + 1) * s_block]
        out[g, :s_block] = ((b[..., None] >> shifts) & 1).to(
            torch.int8).reshape(s_block, 32 * W)
    return out


def build_u(loc: torch.Tensor, S_pad: int) -> torch.Tensor:
    """loc int [P, K] Bloom rows (< S_pad) -> U bf16 [P, S_pad], U[p, s] =
    the number of windows of row p at row s (counted in int32, then cast:
    exact up to 256)."""
    u = torch.zeros((loc.shape[0], S_pad), dtype=torch.int32,
                    device=loc.device)
    u.scatter_add_(1, loc.long(), torch.ones(loc.shape, dtype=torch.int32,
                                             device=loc.device))
    return u.to(torch.bfloat16)


def block_tiles(pg: torch.Tensor, n_blocks: int, tile: int = TILE):
    """Pairs -> (slot int64 [P], blk int32 [P_pad // tile]): pair i goes
    to row slot[i] of a block-sorted layout in which each block's pairs
    fill whole tiles (in their given order) and tile r holds block blk[r].
    Padding slots belong to no pair."""
    order = torch.argsort(pg, stable=True)
    cnt = torch.bincount(pg.long(), minlength=n_blocks)
    padded = (cnt + tile - 1) // tile * tile
    pbase = torch.cumsum(padded, 0) - padded
    start = torch.cumsum(cnt, 0) - cnt
    g_s = pg[order].long()
    slot = torch.empty_like(order)
    slot[order] = pbase[g_s] + torch.arange(
        order.shape[0], device=pg.device) - start[g_s]
    blk = torch.repeat_interleave(
        torch.arange(n_blocks, dtype=torch.int32, device=pg.device),
        padded // tile,
    )
    return slot, blk


def _check(bits01, u, blk):
    if bits01.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bits01.device}")
    for name, t, dt in (("bits01", bits01, torch.int8),
                        ("u", u, torch.bfloat16), ("blk", blk, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != bits01.device:
            raise ValueError(f"{name} is on {t.device}, bits01 on "
                             f"{bits01.device}")
    if bits01.dim() != 3 or u.dim() != 2 or blk.dim() != 1:
        raise ValueError("bits01 must be [nb, S_pad, T], u [P_pad, S_pad] "
                         "and blk [P_pad / TILE]")
    _nb, S_pad, T = bits01.shape
    if T % 32 or u.shape[1] != S_pad:
        raise ValueError(f"T={T} must be a multiple of 32 and u [*, {S_pad}]")
    if u.shape[0] != TILE * blk.shape[0]:
        raise ValueError(f"u has {u.shape[0]} rows, blk {blk.shape[0]} "
                         f"tiles of {TILE}")


def group_count(bits01: torch.Tensor, u: torch.Tensor, blk: torch.Tensor
                ) -> torch.Tensor:
    """bits01 int8 [nb, S_pad, T] (0/1), u bf16 [P_pad, S_pad], blk int32
    [P_pad / TILE] (the block of each tile; nb for a tile of zeros) ->
    counts int32 [P_pad, T], counts[p, t] = sum_s u[p, s] *
    bits01[blk[p // TILE], s, t].  A CPU tensor takes
    ``group_count_plain``; a CUDA tensor launches the kernel or raises."""
    if bits01.device.type == "cpu":
        return group_count_plain(bits01, u, blk)
    _check(bits01, u, blk)
    nb, S_pad, T = bits01.shape
    if u.data_ptr() % 16 or bits01.data_ptr() % 16:
        raise ValueError("u and bits01 must be 16-byte aligned")
    if blk.numel():
        lo, hi = torch.aminmax(blk)
        if int(lo) < 0 or int(hi) > nb:
            raise ValueError(f"blk holds {int(lo)}..{int(hi)} outside 0..{nb}")
    counts = torch.empty((u.shape[0], T), dtype=torch.int32,
                         device=bits01.device)
    stream = torch.cuda.current_stream(bits01.device).cuda_stream
    rc = get_lib().kmcp_group_count(
        bits01.data_ptr(), nb, S_pad, T, u.data_ptr(), blk.data_ptr(),
        blk.shape[0], counts.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"group_count kernel launch failed: cuda error {rc}")
    group_count.launches += 1
    return counts


group_count.launches = 0


def group_count_plain(bits01: torch.Tensor, u: torch.Tensor, blk: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version: one float32 matmul per block group (TF32 off:
    it would round; float32 sums of these integers are exact below
    2^24)."""
    _check(bits01, u, blk)
    nb, _S_pad, T = bits01.shape
    counts = torch.zeros((u.shape[0], T), dtype=torch.int32,
                         device=bits01.device)
    rows = torch.arange(u.shape[0], device=u.device)
    row_blk = blk.long().repeat_interleave(TILE)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for g in torch.unique(blk).tolist():
            if not 0 <= g < nb:
                continue  # tiles of zeros
            r = rows[row_blk == g]
            counts[r] = (u[r].float() @ bits01[g].float()).to(torch.int32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return counts
