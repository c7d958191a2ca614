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

With ``mesh`` (a ("d", "t") DeviceMesh, parallel/sharding.py) the DB is one
rank's shard, laid out as the JAX ``DeviceDB(mesh=...)`` lays it
(device.py:489-518, ``shard_state``): a one-block DB's word axis, padded to
a multiple of t, or a screened multi-block DB's whole blocks; every search
entry point then runs the mesh tails (``sharded_count_tail``,
``sharded_screened_tail``) on the rank's ``d`` slice of the batch.

``search_reads_async`` is the JAX ``search_reads_pallas`` /
``search_reads_async`` dispatch (device.py:622, :938): it enqueues K1', the
tail and the copies of the result into pinned host memory behind a CUDA
event, and returns a ``SearchHandle`` before the card has finished;
``SearchHandle.result()`` waits for the event and gives the host arrays.
``_copy_async`` and ``SearchHandle.result`` are the port's counterparts of
the JAX streamer's ``_copy_async`` and ``_materialize``
(kmcp_tpu/search/stream.py:43-62).  On CPU tensors the handle is complete
when it is made; on a mesh the step waits for the collectives (under gloo
they cross the host) before its result is copied.  ``search_async``, the
step on host-hashed locations, returns such a handle too.

``HostDB`` is the host search backend (JAX ``HostDB``, device.py:126-441):
the same stacked matrix and threshold tables, counted by the port's C++ on
the host, with no torch tensor.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..index.format import read_block_union, read_block_union_header
from ..kmer import native
from ..utils import trace
from .device_step import (
    TailResult,
    batch_slice,
    count_tail_async,
    global_target_ids,
    host_result,
    mesh_place,
    sharded_count_tail,
    target_floor,
)
from .group_count import gemm_slabs, s_pad_for
from .hash_loc import _U64, hash_loc
from .screen import (
    PASS2,
    pass2_kernel,
    screened_tail_async,
    sharded_screened_tail,
)
from .sketch_device import sketch_transform

MULTI_BLOCK_NEEDS = (
    "multi-block DBs stream on the device only when indexed with "
    "--block-screen --uniform-sigs and one hash (ROADMAP A5)"
)
# kmcp_tpu/search/device.py:496-503, :556-557
MESH_GEOMETRY = ("sharded multi-block DeviceDB needs uniform block "
                 "geometry (index --uniform-sigs)")
MESH_SCREEN = ("sharded multi-block DeviceDB needs the block screen "
               "(index --block-screen --uniform-sigs)")
# the loc step filters no read by length or k-mer count (JAX
# device_step.py:892-918): the largest threshold the uint16 layout takes
LOC_DEDUP = 65534
INT32_MAX = np.iinfo(np.int32).max


def screen_off() -> bool:
    """True when ``KMCP_TPU_NO_SCREEN`` is set to any non-empty value: the
    union screens are off on every route, as in kmcp_tpu (stream.py:258,
    device.py:164, :568).  The card's streamer then declines a multi-block
    DB (stream.usable), a mesh refuses one (``check_mesh_db``),
    ``numpy_state`` packs no union table and ``HostDB`` drops its unions."""
    return bool(os.environ.get("KMCP_TPU_NO_SCREEN"))


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  To a CUDA device it goes
    from pinned memory without blocking: a copy from pageable memory waits
    for every batch already on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if trace.TRACER.on:
        trace.count("h2d_bytes", trace.nbytes(t))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class SearchHandle:
    """A dispatched search step: its ``TailResult`` in host memory and the
    CUDA event recorded after the copies into it (None when complete)."""

    def __init__(self, res: TailResult, event=None):
        self.res = res
        self.event = event

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        """(meta int32, aux uint16) host arrays, after waiting for the
        copies and checking the rows the step was given (JAX
        ``_materialize``, kmcp_tpu/search/stream.py:43-47)."""
        if self.event is not None:
            self.event.synchronize()
        return host_result(self.res)


def _copy_async(res: TailResult) -> SearchHandle:
    """Start the device-to-host copies of a dispatched step's result into
    pinned memory on the current stream and record an event after them
    (kmcp_tpu/search/stream.py:50-62); CPU tensors are the result.  The
    tracer's ``d2h_bytes`` counts the three tensors' sizes either way."""
    with trace.span("d2h.result"):
        parts = (res.meta, res.aux, res.ranges)
        if trace.TRACER.on:
            trace.count("d2h_bytes", trace.nbytes(*parts))
        if res.meta.device.type != "cuda":
            return SearchHandle(res)
        host = []
        for t in parts:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(res.meta.device))
    return SearchHandle(TailResult(*host, res.n_rows), event)


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


def check_mesh_db(db, t_size: int):
    """Raise the JAX package's errors for a DB that a mesh of ``t_size``
    target shards cannot hold (device.py:489-507, :556-557), in its order:
    blocks of unequal row counts, blocks that do not divide t, a
    multi-block DB without the screen (or with it turned off,
    ``screen_off``)."""
    n_blocks = len(db.blocks)
    if n_blocks == 1:
        return
    if len({b.bits.shape[0] for b in db.blocks}) != 1:
        raise ValueError(MESH_GEOMETRY)
    _check_mesh_blocks(n_blocks, t_size,
                       two_pass_ready(db) and not screen_off())


def _check_mesh_blocks(n_blocks: int, t_size: int, screened: bool):
    if n_blocks % t_size:
        raise ValueError(
            f"{n_blocks} blocks do not divide the 't' axis ({t_size})")
    if not screened:
        raise ValueError(MESH_SCREEN)


def shard_state(state: dict, mesh_shape, coords) -> dict:
    """One rank's part of ``numpy_state``'s arrays on a (d, t) mesh at
    ``coords`` (i, j): a one-block DB pads its word axis to a multiple of t
    (padding lanes named "", size 0, so their floors mask them) and keeps
    words [j W_t, (j + 1) W_t); a multi-block DB, which needs the screen
    and t | nb, keeps blocks [j nb_l, (j + 1) nb_l) and the whole union
    table.  The per-target arrays stay whole (the host decodes global
    target ids with them); ``shard`` records the layout."""
    d_size, t_size = (int(v) for v in mesh_shape)
    d_index, t_index = (int(v) for v in coords)
    bits = np.asarray(state["bits_ext"])
    w = bits.shape[1]
    n_blocks = len(state["sizes"]) // (32 * w)
    out = dict(state)
    if n_blocks > 1:
        _check_mesh_blocks(n_blocks, t_size, state.get("screen") is not None)
        s_block = int(state["screen"]["s_block"])
        nb_l = n_blocks // t_size
        rows = bits[t_index * nb_l * s_block : (t_index + 1) * nb_l * s_block]
        out["bits_ext"] = np.concatenate([rows, bits[-1:]])
    else:
        out = pad_words(state, t_size)
        bits = out["bits_ext"]
        w = bits.shape[1]
        w_t = w // t_size
        out["bits_ext"] = bits[:, t_index * w_t : (t_index + 1) * w_t]
    out["shard"] = {"mesh_shape": (d_size, t_size),
                    "coords": (d_index, t_index), "w": w}
    return out


def pad_words(state: dict, t_size: int) -> dict:
    """A one-block state with its word axis padded to a multiple of t
    (device.py:508-518): the padding lanes are named "", have size 0 and
    tmin 1, so their floors mask them.  A mesh of t target shards holds
    this layout, and so does the single-device run its results are held
    to byte for byte (the flat ids b T + t count the padding lanes)."""
    bits = np.asarray(state["bits_ext"])
    pad = (-bits.shape[1]) % t_size
    if not pad:
        return dict(state)
    out = dict(state, bits_ext=np.pad(bits, ((0, 0), (0, pad))))
    for key, fill in (("names", ""), ("indices", 0), ("gsizes", 0),
                      ("sizes", 0), ("sizes_pos", False), ("tmin", 1)):
        a = np.asarray(state[key])
        out[key] = np.concatenate([a, np.full(32 * pad, fill, a.dtype)])
    return out


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
    packed union table of ``build_packed_union``; none with the screen
    off, ``screen_off``, when a multi-block DB raises as one without
    screens does)."""
    n_blocks = len(db.blocks)
    if n_blocks > 1 and (screen_off() or not two_pass_ready(db)):
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
    kernel: "pair" (K5'), "gemm" (K6') or "auto" (``pass2_kernel``).
    ``mesh``: a ("d", "t") DeviceMesh this process is a rank of; the DB
    is then the rank's shard (``shard_state``)."""

    def __init__(self, db, opt, device, pass2: str = "auto", mesh=None):
        if mesh is not None:
            check_mesh_db(db, mesh_place(mesh)[1])
        self._init(numpy_state(db, opt), opt, device, db.query_fpr, pass2,
                   mesh)

    @classmethod
    def from_numpy_state(cls, state: dict, opt, device, query_fpr=None,
                         pass2: str = "auto", mesh=None):
        """Build from numpy arrays (e.g. a JAX ``DeviceDB``'s): bits_ext
        with its sentinel row, names, indices, gsizes, sizes, sizes_pos,
        tmin, ``cmin`` {n_max: table}, the scalars k, num_hashes, max_hash
        and, for a multi-block DB, ``screen`` {u_ext, num_bits, fprs,
        s_block} (a JAX ``DeviceDB.screen``), and for a sketch DB
        ``sketch`` (``sketch_kind``).  ``query_fpr`` builds cmin
        tables the state lacks.  With ``mesh`` the rank builds its shard
        of the state (``shard_state``)."""
        self = cls.__new__(cls)
        self._init(state, opt, device, query_fpr, pass2, mesh)
        return self

    def _init(self, state, opt, device, query_fpr, pass2, mesh=None):
        self.opt = opt
        self.device = torch.device(device)
        self.query_fpr = query_fpr
        self.mesh = mesh
        if mesh is not None:
            d_size, t_size, d_index, t_index = mesh_place(mesh)
            state = shard_state(state, (d_size, t_size), (d_index, t_index))
        bits = np.ascontiguousarray(state["bits_ext"], dtype=np.uint32)
        # a copy: the source may be a read-only index mmap or device array
        self.bits_ext = torch.tensor(bits.view(np.int32), device=self.device)
        self.total_rows = bits.shape[0] - 1  # also the sentinel row
        self.w = state["shard"]["w"] if mesh is not None else bits.shape[1]
        self.t_per_block = 32 * self.w
        self.names = [str(n) for n in state["names"]]
        self.indices = np.asarray(state["indices"], dtype=np.int64)
        self.gsizes = np.asarray(state["gsizes"], dtype=np.int64)
        self.sizes = np.asarray(state["sizes"], dtype=np.int64)
        self.n_blocks = len(self.sizes) // self.t_per_block
        self._tmin_np = np.asarray(state["tmin"], dtype=np.int32)
        thr = target_floor(self._tmin_np,
                           np.asarray(state["sizes_pos"], dtype=bool)
                           ).reshape(self.n_blocks, self.t_per_block)
        if mesh is not None and self.n_blocks == 1:
            tg = global_target_ids(1, bits.shape[1], t_size, t_index)
            thr = thr[:, tg.numpy()]
        elif mesh is not None:
            nb_l = self.n_blocks // t_size
            thr = thr[t_index * nb_l : (t_index + 1) * nb_l]
        self.thr = torch.from_numpy(np.ascontiguousarray(thr)).to(self.device)
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
            if self.s_block * self.thr.shape[0] != self.total_rows:
                raise ValueError(
                    f"{self.total_rows} rows are not {self.thr.shape[0]} "
                    f"blocks of {self.s_block}"
                )
            self._theta_cache: dict[int, torch.Tensor] = {}
            self._bits01 = None
            # active pairs, all batches: a device scalar once one has run
            self.tail_stats = {"pairs": 0}
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
            t = to_device(build_cmin_table(
                n_max, opt.min_kmers, opt.min_query_cov, opt.max_fpr,
                self.query_fpr,
            ), self.device)
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
            t = to_device(th, self.device)
            self._theta_cache[n_max] = t
        return t

    def gemm_slabs(self) -> torch.Tensor:
        """K6''s slabs, u8 0/1 in the kernel's tiles (``gemm_slabs``),
        built once."""
        if self._bits01 is None:
            self._bits01 = gemm_slabs(self.bits_ext, self.thr.shape[0],
                                      self.s_block, s_pad_for(self.s_block))
        return self._bits01

    def search_reads(self, reads: torch.Tensor, lens: np.ndarray,
                     cand_budget: int, dedup_values: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
        """``search_reads_async(...).result()``."""
        return self.search_reads_async(reads, lens, cand_budget,
                                       dedup_values).result()

    def search_reads_async(self, reads: torch.Tensor, lens: np.ndarray,
                           cand_budget: int, dedup_values: bool = False
                           ) -> SearchHandle:
        """reads uint8 [B, lmax] on the device (zero padded ASCII), lens
        [B] -> a ``SearchHandle`` whose ``result()`` is (meta int32, aux
        uint16) host arrays: the flat-id layout of the dense tail (one
        block) or the split-id layout of the screened tail
        (device_step.py).  Nothing here waits for the card, off a mesh:
        lens go up from pinned memory, the tails have fixed shapes, and
        their result comes back behind an event (``_copy_async``).
        ``dedup_values`` is the paired mode (device.py:622-715, :846-935):
        K1' also emits the window values and the tail uniques each
        over-threshold read's windows in place of excluding the read; for
        paired rows ``lens`` is max(len1, len2), which feeds only the
        min-length filter.  A sketch DB streams
        single-end over one block only: anything else raises, for its
        windows would be counted without selection.  On a mesh every rank
        passes the whole batch; K1' hashes the rank's ``d`` slice (JAX
        ``search_reads_async`` on a mesh, device.py:938-973, with K1' in
        place of its XLA hash) and every rank returns the whole result,
        waited for."""
        opt = self.opt
        lmax = reads.shape[1]
        lens_t = to_device(np.asarray(lens).astype(np.int32), self.device)
        K = max(lmax - self.k + 1, 1)
        cmin = self.cmin_for(K)
        if self.sketch is not None and (self.screen is not None
                                        or dedup_values
                                        or self.mesh is not None):
            raise NotImplementedError(
                "sketch DBs stream single-end reads over one block of one "
                "device only (window selection runs nowhere else): paired, "
                "multi-block and sharded sketch searches take the object "
                "engine"
            )
        if self.mesh is not None:
            return _copy_async(self._search_reads_sharded(
                reads, lens_t, cmin, K, cand_budget, dedup_values))
        if self.screen is not None:
            with trace.span("k1.hash_loc"):
                outs = hash_loc(
                    reads, self.k, self.s_block, self.max_hash, 1,
                    screen_sigs=self.screen["num_bits"], values=dedup_values,
                )
            return _copy_async(screened_tail_async(
                self.bits_ext, self.screen["u_ext"], outs[0][:, :, 0],
                outs[2], outs[1], lens_t, cmin, self.theta_for(K), self.thr,
                cand_budget, opt.min_query_len, opt.kmer_dedup_threshold,
                self.pass2,
                self.gemm_slabs() if self.pass2 == "gemm" else None,
                stats=self.tail_stats, in_dedup=dedup_values,
                values=outs[3] if dedup_values else None,
            ))
        if self.sketch is not None:
            loc, nk = self._sketch_locations(reads, lens_t)
        else:
            with trace.span("k1.hash_loc"):
                outs = hash_loc(reads, self.k, self.total_rows,
                                self.max_hash, self.num_hashes,
                                values=dedup_values)
            loc, nk = outs[0], outs[1]
        return _copy_async(count_tail_async(
            self.bits_ext, loc, nk, lens_t, cmin, self.thr[0],
            cand_budget, opt.min_query_len, opt.kmer_dedup_threshold,
            in_dedup=dedup_values, values=outs[2] if dedup_values else None,
        ))

    def _search_reads_sharded(self, reads, lens_t, cmin, K, budget,
                              dedup_values):
        opt = self.opt
        d_size, _t, d_index, _ti = mesh_place(self.mesh)
        n_reads = reads.shape[0]
        reads = batch_slice(reads, d_size, d_index, 0)
        lens_t = batch_slice(lens_t, d_size, d_index, 0)
        if self.screen is not None:
            if dedup_values:
                raise NotImplementedError(
                    "paired rows on a sharded screened DB: the JAX sharded "
                    "screened step is single-end (ROADMAP A9)")
            loc, nk, loc_u = hash_loc(
                reads, self.k, self.s_block, self.max_hash, 1,
                screen_sigs=self.screen["num_bits"])
            return self._screened_sharded(loc[:, :, 0], loc_u, nk, lens_t,
                                          cmin, K, budget, n_reads)
        outs = hash_loc(reads, self.k, self.total_rows, self.max_hash,
                        self.num_hashes, values=dedup_values)
        return sharded_count_tail(
            self.bits_ext, outs[0], outs[1], lens_t, cmin, self.thr[0],
            budget, opt.min_query_len, opt.kmer_dedup_threshold, self.mesh,
            n_reads, in_dedup=dedup_values,
            values=outs[2] if dedup_values else None,
        )

    def _screened_sharded(self, loc, loc_u, nk, lens_t, cmin, K, budget,
                          n_reads):
        opt = self.opt
        args = (self.bits_ext, self.screen["u_ext"], loc, loc_u, nk, lens_t,
                cmin, self.theta_for(K), self.thr, budget, opt.min_query_len,
                opt.kmer_dedup_threshold)
        bits01 = self.gemm_slabs() if self.pass2 == "gemm" else None
        if self.mesh is None:
            return screened_tail_async(*args, self.pass2, bits01,
                                       stats=self.tail_stats)
        return sharded_screened_tail(*args, self.mesh, n_reads, self.pass2,
                                     bits01, stats=self.tail_stats)

    def _host_planes(self, planes, fills):
        """Planes [B, ...], host arrays or int32 tensors already on the
        device, -> this rank's ``d`` slices (all of them off a mesh) as
        int32 tensors on the device.  Host arrays go up from pinned memory
        without blocking."""
        out = []
        for a, fill in zip(planes, fills):
            t = (a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.int32)))
            if self.mesh is not None:
                d_size, _t, d_index, _ti = mesh_place(self.mesh)
                t = batch_slice(t, d_size, d_index, fill)
            if trace.TRACER.on and not isinstance(a, torch.Tensor):
                trace.count("h2d_bytes", trace.nbytes(t))
            if t.device.type == "cpu" and self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return out

    def search_async(self, loc, nkmers: np.ndarray, cand_budget: int
                     ) -> SearchHandle:
        """Bloom locations loc [B, K, h] of a one-block DB, hashed on the
        host (invalid windows at the sentinel row ``total_rows``; a host
        array, or an int32 tensor already on the device), and their counts
        nkmers [B] (a host array) -> a ``SearchHandle`` of count_tail's
        (meta, aux), the whole batch on every rank of a mesh.  The step of
        JAX ``search_async`` (device.py:1011-1030, ``_make_search_step``):
        no read is dropped for its length or its k-mer count, and cmin
        covers nkmers.max().  Off a mesh nothing here waits for the card,
        as in ``search_reads_async``."""
        if self.n_blocks != 1:
            raise NotImplementedError(
                "search_async takes one-block DBs; a screened DB takes "
                "search_screened_sharded")
        if loc.shape[1] > LOC_DEDUP:
            raise ValueError(f"{loc.shape[1]} windows a read overflow the "
                             "uint16 aux layout")
        n_reads = loc.shape[0]
        nk_np = np.minimum(nkmers, 10**9)
        loc_t, nk, lens = self._host_planes(
            (loc, nk_np, np.zeros(n_reads)), (self.total_rows, 0, 0))
        cmin = self.cmin_for(int(nk_np.max(initial=1)))
        if self.mesh is None:
            return _copy_async(count_tail_async(
                self.bits_ext, loc_t, nk, lens, cmin, self.thr[0],
                cand_budget, 0, LOC_DEDUP))
        return _copy_async(sharded_count_tail(
            self.bits_ext, loc_t, nk, lens, cmin, self.thr[0], cand_budget, 0,
            LOC_DEDUP, self.mesh, n_reads))

    def search_screened_sharded(self, loc: np.ndarray, loc_u: np.ndarray,
                                nkmers: np.ndarray, lens: np.ndarray,
                                cand_budget: int
                                ) -> tuple[np.ndarray, np.ndarray]:
        """The sharded two-pass screened step on host location planes
        loc / loc_u [B, K] (sentinels s_block / the union's num_bits) ->
        screened_tail's (meta, aux) for the whole batch, on every rank
        (JAX ``search_screened_sharded``, device.py:975-1011), single-end.
        Off a mesh, ``screened_tail`` on the same planes: the result a
        mesh's is held to."""
        if self.screen is None:
            raise ValueError("search_screened_sharded needs a screened "
                             "multi-block DB")
        K = max(int(loc.shape[1]), 1)
        planes = self._host_planes(
            (loc, loc_u, np.minimum(nkmers, 10**9), lens),
            (self.s_block, self.screen["num_bits"], 0, 0))
        return host_result(self._screened_sharded(
            *planes, self.cmin_for(K), K, cand_budget, loc.shape[0]))

    def _sketch_locations(self, reads: torch.Tensor, lens_t: torch.Tensor):
        """A sketch DB's (loc, nk) in the JAX call order (device.py:671-706):
        K1' at k unscaled with values, for a syncmer DB K1' again at k = s
        (one row, values), the window selection, then the scale filter."""
        kind, param = self.sketch
        with trace.span("k1.hash_loc"):
            loc, _nk, vals = hash_loc(reads, self.k, self.total_rows, _U64,
                                      self.num_hashes, values=True)
            s_vals = None
            if kind == "syncmer":
                s_vals = hash_loc(reads, param, 1, _U64, 1, values=True)[2]
        loc, nk, _vals = sketch_transform(kind, self.k, param,
                                          self.total_rows, self.max_hash,
                                          loc, vals, s_vals, lens_t)
        return loc, nk


class HostDB:
    """The host search backend (``--backend host``): C++ read hashing and
    sparse match counting with the exact integer thresholds, in the
    streamer's interface.  Port of kmcp_tpu/search/device.py ``HostDB``
    (:126-441), its sparse paths: one block hashes to Bloom locations
    (``hash_reads_loc``) counted by ``count_block_sparse``; several blocks
    hash once (``hash_reads_padded``) and ``count_hashes_sparse`` counts
    each block's slice of the stacked matrix, skipping the reads a block's
    union screen rules out (``screen_active``; ``KMCP_TPU_NO_SCREEN`` set
    ignores the screens).  Not ported: its dense fallback for native
    builds without the sparse counters (the port builds its C++ at first
    use, so they are always there).  Nothing here touches a torch device.

    The result of ``search_reads`` is the flat int64 layout
    ``[n_cand, ids[budget], counts[budget], nkmers[B]]`` with ids
    ``read * T + target`` over all blocks' lanes; the candidates come in
    the counters' thread order, which the streamer's drain sorts."""

    def __init__(self, db, opt):
        self.db = db
        self.opt = opt
        (stacked, names, indices, gsizes, sizes, rows, w, row_offsets) = (
            _stack_blocks(db)
        )
        self.n_blocks = len(db.blocks)
        self.block_row_offset = row_offsets
        self.block_num_sigs = [b.meta.num_sigs for b in db.blocks]
        self.bits_ext = stacked
        self.total_rows = rows  # also the sentinel row
        self.w = w
        self.t_per_block = 32 * w
        self.names = names
        self.indices = np.asarray(indices, dtype=np.int64)
        self.gsizes = np.asarray(gsizes, dtype=np.int64)
        self.sizes = np.asarray(sizes, dtype=np.int64)
        # build_tmin_table divides by the size: padding lanes (size 0) take
        # INT32_MAX, which no count reaches, as in numpy_state
        real = self.sizes > 0
        tmin = np.ones(len(self.sizes), dtype=np.int32)
        tmin[real] = build_tmin_table(self.sizes[real].astype(np.float64),
                                      opt.min_target_cov)
        self.tmin_eff = np.where(real, np.maximum(tmin, 1),
                                 INT32_MAX).astype(np.int32)
        self._cmin_np: dict[int, np.ndarray] = {}
        if screen_off():
            self.block_unions = [None] * self.n_blocks
        else:
            self.block_unions = [read_block_union(db.path, b)
                                 for b in range(self.n_blocks)]
        self.has_screen = any(u is not None for u in self.block_unions)
        # the packed union table: one location plane probes every block's
        # screen in one count_block pass (uniform screen geometry)
        self.packed_union = (build_packed_union(db, self.n_blocks)
                             if self.has_screen and self.n_blocks > 1
                             else None)

    def _cmin(self, n_max: int) -> np.ndarray:
        n_max = max(64, -(-n_max // 64) * 64)
        t = self._cmin_np.get(n_max)
        if t is None:
            opt = self.opt
            t = build_cmin_table(n_max, opt.min_kmers, opt.min_query_cov,
                                 opt.max_fpr, self.db.query_fpr)
            self._cmin_np[n_max] = t
        return t

    def search_reads(self, seqs: list[bytes], lens: np.ndarray, lmax: int,
                     cand_budget: int, dedup_threshold: int = 0,
                     mates: list[bytes] | None = None) -> np.ndarray:
        """Search a batch of reads ``seqs`` (padded with empty reads) whose
        hash rows hold lmax - k + 1 windows -> the flat int64 result.
        ``lens`` are the lengths the min-length filter reads (for pairs
        max(len1, len2)).  ``dedup_threshold`` > 0 uniques a row's k-mers
        past that many in the hash kernel (util-db-search.go:874-908), else
        reads over the options' threshold are left to the object engine.
        ``mates``, an interleaved [m1_0, m2_0, m1_1, ...] list of 2B
        sequences, hashes each mate as its own row (sketch windows must not
        cross the mate junction) and joins the row pairs, with no dedup.
        Synchronous (JAX ``HostDB.search_reads_async``); the C++ releases
        the GIL."""
        opt, db = self.opt, self.db
        info = db.info
        k = max(info.ks)
        B = len(seqs)
        kmax = lmax - k + 1
        h = info.num_hashes
        sketch = {"minimizer_w": info.minimizer_w if info.minimizer else 0,
                  "syncmer_s": info.syncmer_s if info.syncmer else 0}
        hash_kw = dict(canonical=info.canonical, max_hash=db.max_hash,
                       **sketch)
        if mates is not None:
            dedup_threshold = 0
            kmax_m = max(max(len(s) for s in mates) - k + 1, 1)
        T_total = self.n_blocks * self.t_per_block
        idx_out = np.empty(cand_budget, dtype=np.int64)
        cnt_out = np.empty(cand_budget, dtype=np.int32)

        def read_floor(nkmers):
            """Per-read count floors; INT32_MAX excludes a read."""
            cmin = self._cmin(int(nkmers.max(initial=1)))
            cmin_r = cmin[np.minimum(nkmers, len(cmin) - 1)].astype(np.int32)
            excl = ~(np.asarray(lens) >= opt.min_query_len)
            if dedup_threshold <= 0:
                excl |= nkmers > opt.kmer_dedup_threshold
            cmin_r[excl] = INT32_MAX
            return cmin_r

        if self.n_blocks == 1:
            if mates is not None:
                # [2B, kmax_m, h] -> [B, 2 kmax_m, h]: a pair's rows are
                # adjacent in memory, so the join is a reshape
                loc2, c2 = native.hash_reads_loc(
                    mates, k, kmax_m, self.total_rows, h, **hash_kw)
                loc = loc2.reshape(B, 2 * kmax_m, h)
                counts = c2.reshape(B, 2).sum(axis=1)
            else:
                loc, counts = native.hash_reads_loc(
                    seqs, k, kmax, self.total_rows, h,
                    dedup_threshold=dedup_threshold, **hash_kw)
            nkmers = counts.astype(np.int32)
            n_cand = native.count_block_sparse(
                self.bits_ext, loc, h, read_floor(nkmers), self.tmin_eff, 0,
                T_total, cand_budget, idx_out, cnt_out, 0)
            return self._pack_sparse(n_cand, idx_out, cnt_out, nkmers,
                                     cand_budget)

        # several blocks: hash once; each block counts its slice of the
        # target lanes, its locations derived in the kernel
        if mates is not None:
            h2, c2 = native.hash_reads_padded(mates, k, kmax_m, **hash_kw)
            hashes = h2.reshape(B, 2 * kmax_m)
            counts = c2.reshape(B, 2).sum(axis=1)
        else:
            hashes, counts = native.hash_reads_padded(
                seqs, k, kmax, dedup_threshold=dedup_threshold, **hash_kw)
        nkmers = counts.astype(np.int32)
        cmin_r = read_floor(nkmers)
        active = self._screen(hashes, counts.astype(np.float64))
        n_cand = 0
        for b in range(self.n_blocks):
            t_off = b * self.t_per_block
            n_cand = native.count_hashes_sparse(
                self.bits_ext, hashes, h, self.block_num_sigs[b],
                self.block_row_offset[b], cmin_r,
                self.tmin_eff[t_off : t_off + self.t_per_block], t_off,
                T_total, cand_budget, idx_out, cnt_out, n_cand,
                active=active(b))
        return self._pack_sparse(n_cand, idx_out, cnt_out, nkmers,
                                 cand_budget)

    def _screen(self, hashes: np.ndarray, nk: np.ndarray):
        """block -> the uint8 activity mask of its union screen, or None
        (JAX ``screen_active``, device.py:273-308): a read passes a block
        when its union-Bloom hit count reaches the junk-FP band, mean
        fpr_u n + 3 sigma (and min_kmers), in float64.  With the packed
        union table one count_block pass, made at the first block that
        asks, serves every block."""
        packed: dict = {}

        def active(b: int):
            u = self.block_unions[b]
            if u is None:
                return None
            words, num_bits, fpr_u = u
            if self.packed_union is not None:
                if "mat" not in packed:
                    U, nbits, _fprs = self.packed_union
                    loc_u = native.locations(hashes, 1, nbits)
                    loc_u[hashes[..., None] == 0] = np.int32(nbits)
                    packed["mat"] = native.count_block(U, loc_u, 1)
                uc = packed["mat"][:, b]
            else:
                uc = native.union_count(words, num_bits, hashes)
            theta = np.maximum(
                self.opt.min_kmers,
                np.ceil(fpr_u * nk + 3.0 * np.sqrt(nk * fpr_u * (1 - fpr_u))),
            )
            return (uc >= theta).astype(np.uint8)

        return active

    @staticmethod
    def _pack_sparse(n_cand, idx_out, cnt_out, nkmers, cand_budget):
        B = len(nkmers)
        out = np.empty(1 + 2 * cand_budget + B, dtype=np.int64)
        out[0] = n_cand
        ncap = min(n_cand, cand_budget)
        out[1 : 1 + ncap] = idx_out[:ncap]
        out[1 + cand_budget : 1 + cand_budget + ncap] = cnt_out[:ncap]
        out[1 + 2 * cand_budget :] = nkmers
        return out
