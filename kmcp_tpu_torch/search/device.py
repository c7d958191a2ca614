"""Device-resident bit matrix, threshold tables and the read search step.

Port of kmcp_tpu/search/device.py ``DeviceDB`` (``__init__`` :451-558,
``_load_screen`` :560, ``_theta_for`` :583, ``cmin_for`` :603,
``search_reads_pallas`` :622, with its sketch branch :671-706,
``_search_reads_screened`` :846).  The blocks live on ``device``
row-stacked as an int32 view [nb*S+1, W] with the all-zero sentinel row
last.  A one-block DB takes the dense count tail (device_step.py), after
minimizer or closed-syncmer window selection (sketch_device.py) for a
sketch DB; a multi-block DB indexed with
``--block-screen --uniform-sigs`` takes the two-pass screened tail
(screen.py) over the packed union table.  The threshold tables are built on
the host in float64 exactly as the JAX package builds them and copied to
the device; the host arrays come from the port's copies of
``build_cmin_table`` and ``build_tmin_table`` (device.py:56,78),
``two_pass_ready`` and ``build_packed_union`` (device_screened.py:55,61)
and ``_stack_blocks`` (device_step.py:990).
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.format import read_block_union, read_block_union_header
from .device_step import count_tail, target_floor
from .group_count import gemm_slabs, s_pad_for
from .hash_loc import _U64, hash_loc
from .screen import PASS2, pass2_kernel, screened_tail
from .sketch_device import sketch_transform

MULTI_BLOCK_NEEDS = (
    "multi-block DBs stream on the device only when indexed with "
    "--block-screen --uniform-sigs and one hash (ROADMAP A5)"
)


def build_cmin_table(n_max: int, min_kmers: int, min_qcov: float,
                     max_fpr: float, fpr_cache) -> np.ndarray:
    """cmin[n] for n in 0..n_max (int32), the smallest count a read of n
    k-mers must reach: max(min_kmers, min{c : c > n*min_qcov},
    min{c : queryFPR(n, c) <= max_fpr}); cmin > n means 'cannot pass'.
    Float64 compares, as the reference makes them."""
    out = np.empty(n_max + 1, dtype=np.int32)
    for n in range(n_max + 1):
        # smallest c with c > n*min_qcov (exact float64 compare)
        c_q = int(np.floor(n * min_qcov)) + 1
        while not (float(c_q) > n * min_qcov):
            c_q += 1
        c = max(min_kmers, c_q)
        # FPR is decreasing in c: advance until it passes (or exceeds n)
        while c <= n and fpr_cache(n, c) > max_fpr:
            c += 1
        out[n] = c if c <= n else n + 1  # n+1 == impossible
    return out


def build_tmin_table(sizes: np.ndarray, min_tcov: float) -> np.ndarray:
    """tmin[t]: smallest count with count/size >= min_tcov (float64)."""
    if min_tcov <= 0:
        return np.ones(len(sizes), dtype=np.int32)
    out = np.empty(len(sizes), dtype=np.int32)
    for i, s in enumerate(sizes):
        c = int(np.ceil(float(s) * min_tcov))
        while c / float(s) < min_tcov:
            c += 1
        while c > 0 and (c - 1) / float(s) >= min_tcov:
            c -= 1
        out[i] = max(c, 0)
    return out


def _screen_geometry(db):
    """The shared union num_bits when a multi-block DB can run the two-pass
    screened search, else None: one hash, every block carries a union
    screen (index --block-screen) of one shared size, and the blocks share
    a Bloom row count, so one location plane serves every block (index
    --uniform-sigs forces both).  Reads only the union headers."""
    if db.info.num_hashes != 1 or len(db.blocks) <= 1:
        return None
    n_bits = set()
    for b in range(len(db.blocks)):
        h = read_block_union_header(db.path, b)
        if h is None:
            return None
        n_bits.add(h[0])
    if len(n_bits) != 1:
        return None
    if len({blk.bits.shape[0] for blk in db.blocks}) != 1:
        return None
    return n_bits.pop()


def two_pass_ready(db) -> bool:
    """True when the two-pass screened search can serve this DB."""
    return _screen_geometry(db) is not None


def build_packed_union(db, n_blocks: int):
    """(U_ext uint32 [num_bits+1, ceil(nb/32)], num_bits, fprs f64[nb]) or
    None: bit g of row r = row r set in block g's union Bloom, so one
    location plane probes every block's screen at once.  Needs the shared
    geometry of _screen_geometry."""
    nb_u = _screen_geometry(db)
    if nb_u is None:
        return None
    us = [read_block_union(db.path, b) for b in range(n_blocks)]
    Wu = -(-n_blocks // 32)
    U = np.zeros((nb_u + 1, Wu), np.uint32)
    fprs = []
    for g, (words, _nb, fpr) in enumerate(us):
        fprs.append(float(fpr))
        bits = np.unpackbits(
            words.view(np.uint8), bitorder="little", count=nb_u
        ).astype(np.uint32)
        U[:nb_u, g // 32] |= bits << np.uint32(g % 32)
    return U, nb_u, np.asarray(fprs, dtype=np.float64)


def _stack_blocks(db):
    """Stack a DB's blocks into one [S_total+1, W] matrix (+ the zero
    sentinel row) with flattened per-target metadata, padding lanes
    included: (stacked_ext, names, indices, gsizes, sizes, total_rows,
    w, row_offsets)."""
    blocks = db.blocks
    w_max = max(b.bits.shape[1] for b in blocks)
    mats = []
    names: list[str] = []
    indices: list[int] = []
    gsizes: list[int] = []
    sizes: list[int] = []
    row_offsets: list[int] = []
    row_off = 0
    for b in blocks:
        row_offsets.append(row_off)
        m = np.asarray(b.bits)
        if m.shape[1] < w_max:
            m = np.pad(m, ((0, 0), (0, w_max - m.shape[1])))
        mats.append(m)
        row_off += m.shape[0]
        names.extend(b.meta.names)
        indices.extend(b.meta.indices)
        gsizes.extend(b.meta.gsizes)
        sizes.extend(b.meta.sizes)
        pad = w_max * 32 - b.meta.num_targets
        if pad:
            names.extend([""] * pad)
            indices.extend([0] * pad)
            gsizes.extend([0] * pad)
            sizes.extend([0] * pad)
    stacked = np.concatenate(mats, axis=0)
    stacked = np.concatenate(
        [stacked, np.zeros((1, w_max), dtype=np.uint32)], axis=0
    )
    return stacked, names, indices, gsizes, sizes, row_off, w_max, row_offsets


def sketch_kind(info):
    """(kind, param) of a sketch DB's window selection: ("minimizer", w)
    or ("syncmer", s); None for a plain k-mer DB."""
    if info.minimizer:
        return "minimizer", int(info.minimizer_w)
    if info.syncmer:
        return "syncmer", int(info.syncmer_s)
    return None


def numpy_state(db, opt) -> dict:
    """The arrays a TorchDeviceDB is built from, straight from the index
    (``_stack_blocks`` + ``build_tmin_table``, and for a multi-block DB the
    packed union table of ``build_packed_union``)."""
    n_blocks = len(db.blocks)
    if n_blocks > 1 and not two_pass_ready(db):
        raise NotImplementedError(MULTI_BLOCK_NEEDS)
    stacked, names, indices, gsizes, sizes, _rows, _w, _offs = (
        _stack_blocks(db)
    )
    sizes = np.asarray(sizes, dtype=np.int64)
    # build_tmin_table divides by the size: padding lanes (size 0, in any
    # block) keep tmin 1 and are masked by sizes_pos
    tmin = np.ones(len(sizes), dtype=np.int32)
    real = sizes > 0
    tmin[real] = build_tmin_table(sizes[real].astype(np.float64),
                                  opt.min_target_cov)
    screen = None
    if n_blocks > 1:
        u_ext, num_bits, fprs = build_packed_union(db, n_blocks)
        screen = {"u_ext": u_ext, "num_bits": num_bits, "fprs": fprs,
                  "s_block": int(db.blocks[0].bits.shape[0])}
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
        "screen": screen,
        "sketch": sketch_kind(db.info),
    }


class TorchDeviceDB:
    """Row-stacked bit matrix on ``device`` plus its threshold tables and,
    for a multi-block DB, the screen.  ``pass2`` picks the screened pass-2
    kernel: "pair" (K5'), "gemm" (K6') or "auto" (``pass2_kernel``)."""

    def __init__(self, db, opt, device, pass2: str = "auto"):
        self._init(numpy_state(db, opt), opt, device, db.query_fpr, pass2)

    @classmethod
    def from_numpy_state(cls, state: dict, opt, device, query_fpr=None,
                         pass2: str = "auto"):
        """Build from numpy arrays (e.g. a JAX ``DeviceDB``'s): bits_ext
        with its sentinel row, names, indices, gsizes, sizes, sizes_pos,
        tmin, ``cmin`` {n_max: table}, the scalars k, num_hashes, max_hash
        and, for a multi-block DB, ``screen`` {u_ext, num_bits, fprs,
        s_block} (a JAX ``DeviceDB.screen``), and for a sketch DB
        ``sketch`` (``sketch_kind``).  ``query_fpr`` builds cmin
        tables the state lacks."""
        self = cls.__new__(cls)
        self._init(state, opt, device, query_fpr, pass2)
        return self

    def _init(self, state, opt, device, query_fpr, pass2):
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
        self.n_blocks = len(self.sizes) // self.t_per_block
        self._tmin_np = np.asarray(state["tmin"], dtype=np.int32)
        self.thr = torch.from_numpy(target_floor(
            self._tmin_np, np.asarray(state["sizes_pos"], dtype=bool)
        ).reshape(self.n_blocks, self.t_per_block)).to(self.device)
        self._cmin_cache = {
            int(n): torch.from_numpy(np.array(t, dtype=np.int32)).to(
                self.device)
            for n, t in state["cmin"].items()
        }
        self.k = int(state["k"])
        self.num_hashes = int(state["num_hashes"])
        self.max_hash = int(state["max_hash"])
        self.sketch = state.get("sketch")
        self.screen = None
        self.pass2 = None  # the pass-2 kernel of the screened tail
        if self.n_blocks > 1:
            scr = state.get("screen")
            if scr is None or self.num_hashes != 1:
                raise NotImplementedError(MULTI_BLOCK_NEEDS)
            u = np.ascontiguousarray(scr["u_ext"], dtype=np.uint32)
            self.screen = {
                "u_ext": torch.tensor(u.view(np.int32), device=self.device),
                "num_bits": int(scr["num_bits"]),
                "fprs": np.asarray(scr["fprs"], dtype=np.float64),
                "s_block": int(scr["s_block"]),
            }
            self.s_block = self.screen["s_block"]
            if self.s_block * self.n_blocks != self.total_rows:
                raise ValueError(
                    f"{self.total_rows} rows are not {self.n_blocks} blocks "
                    f"of {self.s_block}"
                )
            self._theta_cache: dict[int, torch.Tensor] = {}
            self._bits01 = None
            self.tail_stats = {"pairs": 0}  # active pairs, all batches
            self.pass2 = self._pick_pass2(pass2)

    def _pick_pass2(self, pass2: str) -> str:
        dedup = self.opt.kmer_dedup_threshold
        if pass2 == "auto":
            return pass2_kernel(self.n_blocks, self.w, self.s_block, dedup)
        if pass2 not in PASS2:
            raise ValueError(f"pass2 must be auto, pair or gemm, got {pass2!r}")
        if pass2 == "gemm" and dedup > 256:
            raise ValueError(
                f"pass2='gemm' needs kmer_dedup_threshold <= 256 (bf16 "
                f"holds row multiplicities up to 256), got {dedup}"
            )
        return pass2

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

    def theta_for(self, n_max: int) -> torch.Tensor:
        """[nb, n_max+1] int32 screen thresholds, n_max bucketed to
        multiples of 64: the junk-FP band of HostDB.screen_active (mean +
        3 sigma of a union Bloom's false-positive count, at least
        min_kmers), in float64 on the host (device.py:583-601)."""
        n_max = max(64, -(-n_max // 64) * 64)
        t = self._theta_cache.get(n_max)
        if t is None:
            n = np.arange(n_max + 1, dtype=np.float64)
            f = self.screen["fprs"][:, None]
            th = np.maximum(
                float(self.opt.min_kmers),
                np.ceil(f * n + 3.0 * np.sqrt(n * f * (1.0 - f))),
            ).astype(np.int32)
            t = torch.from_numpy(th).to(self.device)
            self._theta_cache[n_max] = t
        return t

    def gemm_slabs(self) -> torch.Tensor:
        """K6''s slabs, u8 0/1 in the kernel's tiles (``gemm_slabs``),
        built once."""
        if self._bits01 is None:
            self._bits01 = gemm_slabs(self.bits_ext, self.n_blocks,
                                      self.s_block, s_pad_for(self.s_block))
        return self._bits01

    def search_reads(self, reads: torch.Tensor, lens: np.ndarray,
                     cand_budget: int, dedup_values: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
        """reads uint8 [B, lmax] on the device (zero padded ASCII), lens
        [B] -> (meta int32, aux uint16) host arrays: the flat-id layout of
        the dense tail (one block) or the split-id layout of the screened
        tail (device_step.py).  ``dedup_values`` is the paired mode
        (device.py:622-715, :846-935): K1' also emits the window values and
        the tail uniques each over-threshold read's windows in place of
        excluding the read; for paired rows ``lens`` is max(len1, len2),
        which feeds only the min-length filter.  A sketch DB streams
        single-end over one block only: anything else raises, for its
        windows would be counted without selection."""
        opt = self.opt
        lmax = reads.shape[1]
        lens_t = torch.from_numpy(
            np.asarray(lens).astype(np.int32)
        ).to(self.device)
        K = max(lmax - self.k + 1, 1)
        cmin = self.cmin_for(K)
        if self.sketch is not None and (self.screen is not None
                                        or dedup_values):
            raise NotImplementedError(
                "sketch DBs stream single-end reads over one block only "
                "(window selection runs nowhere else): paired and "
                "multi-block sketch searches take the object engine"
            )
        if self.screen is not None:
            outs = hash_loc(
                reads, self.k, self.s_block, self.max_hash, 1,
                screen_sigs=self.screen["num_bits"], values=dedup_values,
            )
            return screened_tail(
                self.bits_ext, self.screen["u_ext"], outs[0][:, :, 0],
                outs[2], outs[1], lens_t, cmin, self.theta_for(K), self.thr,
                cand_budget, opt.min_query_len, opt.kmer_dedup_threshold,
                self.pass2,
                self.gemm_slabs() if self.pass2 == "gemm" else None,
                stats=self.tail_stats, in_dedup=dedup_values,
                values=outs[3] if dedup_values else None,
            )
        if self.sketch is not None:
            loc, nk = self._sketch_locations(reads, lens_t)
        else:
            outs = hash_loc(reads, self.k, self.total_rows, self.max_hash,
                            self.num_hashes, values=dedup_values)
            loc, nk = outs[0], outs[1]
        return count_tail(
            self.bits_ext, loc, nk, lens_t, cmin, self.thr[0],
            cand_budget, opt.min_query_len, opt.kmer_dedup_threshold,
            in_dedup=dedup_values, values=outs[2] if dedup_values else None,
        )

    def _sketch_locations(self, reads: torch.Tensor, lens_t: torch.Tensor):
        """A sketch DB's (loc, nk) in the JAX call order (device.py:671-706):
        K1' at k unscaled with values, for a syncmer DB K1' again at k = s
        (one row, values), the window selection, then the scale filter."""
        kind, param = self.sketch
        loc, _nk, vals = hash_loc(reads, self.k, self.total_rows, _U64,
                                  self.num_hashes, values=True)
        s_vals = None
        if kind == "syncmer":
            s_vals = hash_loc(reads, param, 1, _U64, 1, values=True)[2]
        loc, nk, _vals = sketch_transform(kind, self.k, param,
                                          self.total_rows, self.max_hash,
                                          loc, vals, s_vals, lens_t)
        return loc, nk
