"""Index construction: k-mer sets -> bit-sliced Bloom signature blocks.

The port's copy of kmcp_tpu/index/build.py (less ``round_pow2``, which no
command-line flag sets, and the NumPy fallback of the C++ build):

- ``--tpu-native``: targets sorted by k-mer count, cut into wide blocks of
  ``--native-block-targets``;
- otherwise the reference's block partitioning: chunk files sorted
  ascending by k-mer count, grouped into blocks of ``block_size``, with
  three k-mer-count thresholds re-tiering the block size mid-stream;
  within a block, each run of 8 files is sorted by (name, chunk index);
- per block: ``num_sigs = calc_signature_size(max kmers, h, fpr)`` (with
  ``--uniform-sigs`` the global maximum) and each target's hash locations
  set bit t of row ``loc``; ``--block-screen`` adds the block's k-mer-union
  Bloom screen.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import os
import shutil
import sys
import threading

import numpy as np

from ..kmer import kset as ksetmod
from ..kmer import native
from ..kmer.kset import KsetFileInfo, read_kset
from ..utils.progress import ProgressBar
from .format import (
    BlockMeta,
    DBInfo,
    write_block,
    write_block_union,
    write_db_info,
    write_name_mapping,
)
from .sizing import calc_signature_size


def default_block_size(n_files: int, threads: int) -> int:
    s = (int(n_files / threads) + 7) // 8 * 8
    if s > n_files:
        s = n_files
    if s < 8:
        s = 8
    return s


def partition_blocks(
    infos: list[KsetFileInfo],
    block_size: int = 0,
    threads: int = 0,
    threshold_x: int = 10_000_000,
    block_size_x: int = 256,
    threshold_8: int = 20_000_000,
    threshold_1: int = 200_000_000,
) -> list[list[KsetFileInfo]]:
    """The reference's block-partition state machine."""
    threads = threads or (os.cpu_count() or 1)
    infos = sorted(infos, key=lambda i: i.kmers)  # stable
    n = len(infos)
    s_block = block_size if block_size > 0 else default_block_size(n, threads)

    skip_block_x = block_size_x >= s_block
    if skip_block_x:
        block_size_x = s_block

    blocks: list[list[KsetFileInfo]] = []
    batch: list[KsetFileInfo] = []
    flag = flag8 = flag_x = False
    last: KsetFileInfo | None = None

    def emit():
        nonlocal batch
        if batch:
            blocks.append(batch)
            batch = []

    for i in range(n + 1):
        if i == n:
            if (flag or flag8 or flag_x) and last is not None:
                batch.append(last)
                last = None
            emit()
            break
        info = infos[i]
        if info.kmers == 0:
            continue
        if flag or flag8 or flag_x:
            if last is not None:
                batch.append(last)
                last = None
            if flag:
                last = info  # each big file gets its own block
            elif info.kmers > threshold_1:
                flag = True
                last = info
            elif skip_block_x:
                batch.append(info)
                if len(batch) < s_block:
                    continue
            elif info.kmers > threshold_8:
                if flag8:
                    batch.append(info)
                    if len(batch) < s_block:
                        continue
                else:
                    s_block = 8
                    flag8 = True
                    last = info
            else:  # flag_x tier
                batch.append(info)
                if len(batch) < s_block:
                    continue
        elif skip_block_x:
            if info.kmers > threshold_8:
                if info.kmers > threshold_1:
                    flag = True
                else:
                    s_block = block_size_x
                    flag_x = True
                last = info
            else:
                batch.append(info)
                if len(batch) < s_block:
                    continue
        else:
            if info.kmers > threshold_x:
                if info.kmers > threshold_1:
                    flag = True
                elif info.kmers > threshold_8:
                    s_block = 8
                    flag8 = True
                else:
                    s_block = block_size_x
                    flag_x = True
                last = info
            else:
                batch.append(info)
                if len(batch) < s_block:
                    continue
        emit()

    return blocks


def order_block_targets(block: list[KsetFileInfo]) -> list[KsetFileInfo]:
    """Within a block, every run of 8 files is sorted by (name, chunk idx)."""
    out: list[KsetFileInfo] = []
    for i in range(0, len(block), 8):
        out.extend(sorted(block[i : i + 8], key=lambda x: (x.name, x.index)))
    return out


def build_block_bits(
    targets: list[KsetFileInfo], num_sigs: int, num_hashes: int,
    threads: int = 0, union_bits: int = 0,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Scatter each target's hash locations into its bit column:
    (bits, union_words).

    The C++ path builds each uint32 word column (32 targets) in one pass
    (one thread per word, so no races); word columns build in a thread
    pool since the C++ releases the GIL through ctypes.  With
    ``union_bits`` > 0 the per-block k-mer-union screen bitset accumulates
    in the same pass over the kset files, ORed into one shared buffer
    under a lock; otherwise ``union_words`` is None."""
    num_targets = len(targets)
    num_words = (num_targets + 31) // 32
    bits = np.zeros((num_sigs, num_words), dtype=np.uint32)
    union_words = (
        np.zeros((union_bits + 63) // 64, dtype=np.uint64)
        if union_bits
        else None
    )
    union_lock = threading.Lock()

    def one_word(w: int):
        grp = targets[w * 32 : (w + 1) * 32]
        hs = [np.asarray(read_kset(i.path)[0]) for i in grp]
        offsets = np.zeros(len(hs) + 1, dtype=np.int64)
        np.cumsum([len(h) for h in hs], out=offsets[1:])
        concat = np.concatenate(hs) if hs else np.empty(0, np.uint64)
        if union_words is not None and len(concat):
            with union_lock:
                native.union_fill(concat, union_bits, out=union_words)
        return w, native.build_word_column(
            concat, offsets, len(grp), num_hashes, num_sigs
        )

    workers = threads or min(os.cpu_count() or 1, 8)
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        for w, col in ex.map(one_word, range(num_words)):
            bits[:, w] = col
    return bits, union_words


SCREEN_FPR_U = 0.25


def _union_screen_bits(targets, fpr_u: float = SCREEN_FPR_U) -> int:
    """Bit count for a block's k-mer-union Bloom screen (1 hash,
    fpr_u <= SCREEN_FPR_U): reads sharing no k-mers with a block's union
    skip its count.  Rounded up to a power of two (<= 2x the designed
    size), which only lowers the screen's false-positive rate; the stored
    fpr is the exact value for the rounded size."""
    total = sum(t.kmers for t in targets)
    bits = calc_signature_size(max(total, 1), 1, fpr_u)
    return 1 << max(6, (int(bits) - 1).bit_length())


def _union_screen_fpr(union_bits: int, targets) -> float:
    """Exact 1-hash Bloom FPR of the (power-of-two-rounded) union
    screen: 1 - (1 - 1/m)^n."""
    total = max(sum(t.kmers for t in targets), 1)
    return -math.expm1(total * math.log1p(-1.0 / union_bits))


def run_index(
    in_dir: str,
    out_dir: str,
    num_hashes: int = 1,
    fpr: float = 0.3,
    block_size: int = 0,
    threads: int = 0,
    threshold_x: int = 10_000_000,
    block_size_x: int = 256,
    threshold_8: int = 20_000_000,
    threshold_1: int = 200_000_000,
    alias: str = "",
    force: bool = False,
    dry_run: bool = False,
    block_screen: bool = False,
    tpu_native: bool = False,
    native_block_targets: int = 4096,
    uniform_sigs: bool = False,
    verbose: bool = True,
) -> DBInfo:
    infos = ksetmod.read_info(in_dir)
    if not infos:
        raise SystemExit(
            f"kmcp-tpu-torch index: no .kset files listed in {in_dir}"
        )

    # parameter consistency comes from the first kset header
    _, meta0 = read_kset(infos[0].path)

    if tpu_native:
        # wide blocks (many targets per Bloom row), sorted by k-mer count
        # so that similarly-sized targets share a block's sizing
        srt = sorted(infos, key=lambda i: i.kmers)
        bs = native_block_targets
        blocks = [srt[i : i + bs] for i in range(0, len(srt), bs)]
    else:
        blocks = partition_blocks(
            infos,
            block_size=block_size,
            threads=threads,
            threshold_x=threshold_x,
            block_size_x=block_size_x,
            threshold_8=threshold_8,
            threshold_1=threshold_1,
        )

    if not dry_run:
        # --dry-run only prints the block plan, touching nothing on disk
        if os.path.exists(out_dir):
            if not force:
                raise SystemExit(
                    f"kmcp-tpu-torch index: out dir exists: {out_dir} "
                    "(use --force)"
                )
            shutil.rmtree(out_dir)
        os.makedirs(out_dir)

    # --uniform-sigs: size every block's Bloom (and union screen) by the
    # global maximum so all blocks share one modulus geometry, which the
    # device two-pass screened search needs
    forced_sigs = forced_union = 0
    if uniform_sigs:
        forced_sigs = calc_signature_size(
            max(max(t.kmers for t in b) for b in blocks), num_hashes, fpr
        )
        if block_screen:
            forced_union = max(_union_screen_bits(b) for b in blocks)

    block_files: list[str] = []
    total_kmers = 0
    all_names: list[str] = []
    bar = ProgressBar(
        len(blocks), "index", unit="blocks",
        enabled=verbose and not dry_run and len(blocks) > 1,
    )
    for bid, block in enumerate(blocks):
        targets = order_block_targets(block)
        max_elements = max(t.kmers for t in targets)
        num_sigs = forced_sigs or calc_signature_size(
            max_elements, num_hashes, fpr
        )
        if dry_run:
            print(
                f"[index] block {bid:03d}: {len(targets)} targets, "
                f"max k-mers {max_elements}, num_sigs {num_sigs}",
                file=sys.stderr,
            )
            continue
        union_bits = (forced_union or _union_screen_bits(targets)
                      if block_screen else 0)
        bits, union_words = build_block_bits(
            targets, num_sigs, num_hashes, union_bits=union_bits
        )
        if union_words is not None:
            write_block_union(
                out_dir, bid, union_words, union_bits,
                _union_screen_fpr(union_bits, targets),
            )
        meta = BlockMeta(
            names=[t.name for t in targets],
            gsizes=[t.genome_size for t in targets],
            indices=[t.index + (t.indexes << 16) for t in targets],
            sizes=[t.kmers for t in targets],
            num_sigs=num_sigs,
            num_targets=len(targets),
        )
        block_files.append(write_block(out_dir, bid, bits, meta))
        total_kmers += sum(t.kmers for t in targets)
        all_names.extend(meta.names)
        bar.advance()
    bar.close()

    info = DBInfo(
        alias=alias or os.path.basename(os.path.normpath(out_dir)),
        ks=meta0.ks,
        canonical=meta0.canonical,
        scaled=meta0.scaled,
        scale=meta0.scale,
        minimizer=meta0.minimizer,
        minimizer_w=meta0.minimizer_w,
        syncmer=meta0.syncmer,
        syncmer_s=meta0.syncmer_s,
        split_seq=meta0.split_seq,
        split_num=meta0.split_num,
        split_size=meta0.split_size,
        split_overlap=meta0.split_overlap,
        num_hashes=num_hashes,
        fpr=fpr,
        num_names=sum(len(b) for b in blocks),
        block_size=block_size or default_block_size(
            len(infos), threads or (os.cpu_count() or 1)),
        total_kmers=total_kmers,
        blocks=block_files,
    )
    if not dry_run:
        write_db_info(out_dir, info)
        write_name_mapping(out_dir, sorted(set(all_names)))
        if verbose:
            print(
                f"[index] built {len(block_files)} block(s), "
                f"{info.num_names} targets, {total_kmers} k-mers -> {out_dir}",
                file=sys.stderr,
            )
    return info
