"""Device-resident single-block bit matrix and the read search step.

Port of kmcp_tpu/search/device.py ``DeviceDB`` (``__init__`` :451-558,
``cmin_for`` :603, ``search_reads_pallas`` :622, single-block non-sketch
branch).  The bit matrix lives on ``device`` as an int32 view [S+1, W] with
the all-zero sentinel row S last; the threshold tables are built on the host
in float64 exactly as the JAX package builds them (``build_cmin_table``,
``build_tmin_table``) and copied to the device once.
"""

from __future__ import annotations

import numpy as np
import torch

from kmcp_tpu.search.device import build_cmin_table, build_tmin_table
from kmcp_tpu.search.device_step import _stack_blocks

from .device_step import count_tail, target_floor
from .hash_loc import hash_loc


def numpy_state(db, opt) -> dict:
    """The arrays a TorchDeviceDB is built from, straight from a one-block
    index (``_stack_blocks`` + ``build_tmin_table``)."""
    if len(db.blocks) != 1:
        raise NotImplementedError(
            "multi-block DBs need the screened tail (ROADMAP A5)"
        )
    stacked, names, indices, gsizes, sizes, _rows, _w, _offs = (
        _stack_blocks(db)
    )
    sizes = np.asarray(sizes, dtype=np.int64)
    # build_tmin_table divides by the size: padding lanes (size 0) keep
    # tmin 1 and are masked by sizes_pos
    tmin = np.ones(len(sizes), dtype=np.int32)
    real = sizes > 0
    tmin[real] = build_tmin_table(sizes[real].astype(np.float64),
                                  opt.min_target_cov)
    return {
        "bits_ext": stacked,
        "names": np.asarray(names, dtype=object),
        "indices": np.asarray(indices, dtype=np.int64),
        "gsizes": np.asarray(gsizes, dtype=np.int64),
        "sizes": sizes,
        "sizes_pos": real,
        "tmin": tmin,
        "cmin": {},
        "k": max(db.info.ks),
        "num_hashes": db.info.num_hashes,
        "max_hash": (1 << 64) - 1 if db.max_hash is None else db.max_hash,
    }


class TorchDeviceDB:
    """One-block bit matrix on ``device`` plus its threshold tables."""

    def __init__(self, db, opt, device):
        self._init(numpy_state(db, opt), opt, device, db.query_fpr)

    @classmethod
    def from_numpy_state(cls, state: dict, opt, device, query_fpr=None):
        """Build from numpy arrays (e.g. a JAX ``DeviceDB``'s): bits_ext
        with its sentinel row, names, indices, gsizes, sizes, sizes_pos,
        tmin, ``cmin`` {n_max: table} and the scalars k, num_hashes,
        max_hash.  ``query_fpr`` builds cmin tables the state lacks."""
        self = cls.__new__(cls)
        self._init(state, opt, device, query_fpr)
        return self

    def _init(self, state, opt, device, query_fpr):
        self.opt = opt
        self.device = torch.device(device)
        self.query_fpr = query_fpr
        bits = np.ascontiguousarray(state["bits_ext"], dtype=np.uint32)
        # a copy: the source may be a read-only index mmap or device array
        self.bits_ext = torch.tensor(bits.view(np.int32), device=self.device)
        self.total_rows = bits.shape[0] - 1  # also the sentinel row
        self.w = bits.shape[1]
        self.t_per_block = 32 * self.w
        self.names = [str(n) for n in state["names"]]
        self.indices = np.asarray(state["indices"], dtype=np.int64)
        self.gsizes = np.asarray(state["gsizes"], dtype=np.int64)
        self.sizes = np.asarray(state["sizes"], dtype=np.int64)
        self._tmin_np = np.asarray(state["tmin"], dtype=np.int32)
        self.thr = torch.from_numpy(target_floor(
            self._tmin_np, np.asarray(state["sizes_pos"], dtype=bool)
        )).to(self.device)
        self._cmin_cache = {
            int(n): torch.from_numpy(np.array(t, dtype=np.int32)).to(
                self.device)
            for n, t in state["cmin"].items()
        }
        self.k = int(state["k"])
        self.num_hashes = int(state["num_hashes"])
        self.max_hash = int(state["max_hash"])

    def cmin_for(self, n_max: int) -> torch.Tensor:
        """cmin[n] for n <= n_max, n_max bucketed to multiples of 64
        (device.py:603-620), built on the host in float64."""
        n_max = max(64, -(-n_max // 64) * 64)
        t = self._cmin_cache.get(n_max)
        if t is None:
            if self.query_fpr is None:
                raise KeyError(f"no cmin table for n_max={n_max}")
            opt = self.opt
            t = torch.from_numpy(build_cmin_table(
                n_max, opt.min_kmers, opt.min_query_cov, opt.max_fpr,
                self.query_fpr,
            )).to(self.device)
            self._cmin_cache[n_max] = t
        return t

    def search_reads(self, reads: torch.Tensor, lens: np.ndarray,
                     cand_budget: int) -> tuple[np.ndarray, np.ndarray]:
        """reads uint8 [B, lmax] on the device (zero padded ASCII), lens
        [B] -> (meta int32, aux uint16) host arrays (device_step.py)."""
        opt = self.opt
        lmax = reads.shape[1]
        loc, nk = hash_loc(reads, self.k, self.total_rows, self.max_hash,
                           self.num_hashes)
        lens_t = torch.from_numpy(
            np.asarray(lens).astype(np.int32)
        ).to(self.device)
        cmin = self.cmin_for(max(lmax - self.k + 1, 1))
        return count_tail(
            self.bits_ext, loc, nk, lens_t, cmin, self.thr, cand_budget,
            opt.min_query_len, opt.kmer_dedup_threshold,
        )
