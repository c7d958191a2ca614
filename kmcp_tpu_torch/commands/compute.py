"""``compute`` — generate k-mer (sketch) files from reference genomes.

The port's copy of kmcp_tpu/commands/compute.py, writing the same bytes:

- input: FASTA/Q files or a directory (regex filter, ref-name extraction
  from the file name, sequence-name blacklist)
- splitting: by chunk count (-n) or chunk size (-s) with overlap (-l);
  all sequences of a file are concatenated with kMax-1 'N's first
  (compute.go:569-629); sequences < --split-min-ref are not split
- hashing: canonical ntHash1 of every k-mer, or minimizer / closed-syncmer
  sketches, optionally FracMinHash-scaled; multiple k supported
- output: one .kset file per chunk + _info.tsv summary
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import re
import sys
from dataclasses import dataclass, field

import numpy as np

from ..kmer import kset as ksetmod
from ..kmer.kset import KsetFileInfo, KsetMeta, write_kset
from ..kmer.sketches import generate_kmers, unique_sorted
from ..seqio.fastx import (
    concat_with_ns,
    read_fastx,
    slider,
    split_chunk_size,
)

FASTX_RE = r"\.(f[aq](st[aq])?|fn?a)(\.gz)?$"


@dataclass
class ComputeOptions:
    ks: list[int] = field(default_factory=lambda: [21])
    circular: bool = False
    scale: int = 1
    minimizer_w: int = 0
    syncmer_s: int = 0
    split_number: int = 0
    split_size: int = 0
    split_overlap: int = -1  # -1 => default kMax-1
    split_min_ref: int = 1000
    by_seq: bool = False
    file_regexp: str = FASTX_RE
    ref_name_regexp: str = ""
    seq_name_filter: list[str] = field(default_factory=list)
    threads: int = 0


def _trim_extension(name: str) -> str:
    """Strip one compression + one format extension (the reference's
    filepathTrimExtension semantics, util.go)."""
    for ext in (".gz", ".xz", ".zst", ".bz2"):
        if name.lower().endswith(ext):
            name = name[: -len(ext)]
            break
    root, ext = os.path.splitext(name)
    if ext:
        name = root
    return name


def extract_ref_name(base_file: str, ref_name_re: re.Pattern | None) -> str:
    if ref_name_re is not None:
        m = ref_name_re.search(base_file)
        if m:
            return m.group(1)
    return _trim_extension(base_file)


def list_input_files(
    in_dir: str | None, files: list[str], file_regexp: str
) -> list[str]:
    if in_dir:
        rx = re.compile(file_regexp, re.IGNORECASE)
        out = []
        for root, _dirs, names in os.walk(in_dir):
            for n in sorted(names):
                if rx.search(n):
                    out.append(os.path.join(root, n))
        return sorted(out)
    return list(files)


def _tree_dir(out_dir: str, base_file: str) -> str:
    """Hashed 3-level output subtree for big runs (compute.go:554-561,
    844-849): >1000 outputs in one directory hurt at GTDB scale (~479k
    chunk files), so outputs nest under NNN/MMM/NNN derived from a
    stable hash of the input's base name."""
    import hashlib

    h = int.from_bytes(
        hashlib.md5(base_file.encode()).digest()[:8], "little"
    )
    d = os.path.join(
        out_dir, f"{h & 1023:03d}", f"{(h >> 10) & 1023:03d}",
        f"{h & 1023:03d}",
    )
    os.makedirs(d, exist_ok=True)
    return d


def compute_file(
    file: str,
    out_dir: str,
    opt: ComputeOptions,
    tree: bool = False,
) -> list[KsetFileInfo]:
    """Process one genome file into chunk .kset files (compute.go:504-888).
    With ``tree``, outputs nest in the hashed 3-level directory tree."""
    ks = sorted(opt.ks)
    k_max, k_min = ks[-1], ks[0]
    overlap = opt.split_overlap if opt.split_overlap >= 0 else k_max - 1
    split_seq = opt.split_size > 0 or opt.split_number > 1
    by_seq = opt.by_seq or split_seq
    split_by_number = opt.split_number > 1
    circular0 = opt.circular
    # k-mer computation circularity only applies in non-split mode
    # (compute.go:301-306)
    circular_hash = circular0 and not split_seq

    ref_name_re = (
        re.compile(opt.ref_name_regexp, re.IGNORECASE)
        if opt.ref_name_regexp
        else None
    )
    seq_filters = [re.compile(p, re.IGNORECASE) for p in opt.seq_name_filter]

    base_file = os.path.basename(file)
    ref_name = extract_ref_name(base_file, ref_name_re)
    if tree:
        out_dir = _tree_dir(out_dir, base_file)

    records = []
    for rec in read_fastx(file):
        if seq_filters and any(rx.search(rec.name) for rx in seq_filters):
            continue
        records.append(rec)
    if not records:
        return []

    infos: list[KsetFileInfo] = []

    def sketch(seq: bytes) -> np.ndarray:
        parts = [
            generate_kmers(
                seq,
                k,
                canonical=True,
                circular=circular_hash,
                scale=opt.scale,
                minimizer_w=opt.minimizer_w,
                syncmer_s=opt.syncmer_s,
            )
            for k in ks
        ]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def meta_for(seq_id, frag_idx, genome_size, split_num):
        return KsetMeta(
            ks=ks,
            canonical=True,
            scaled=opt.scale > 1,
            scale=opt.scale,
            minimizer=opt.minimizer_w > 0,
            minimizer_w=opt.minimizer_w,
            syncmer=opt.syncmer_s > 0,
            syncmer_s=opt.syncmer_s,
            split_seq=split_seq,
            split_num=split_num,
            split_size=opt.split_size,
            split_overlap=overlap,
            seq_id=seq_id,
            frag_idx=frag_idx,
            genome_size=genome_size,
        )

    if split_seq:
        # Concatenate all sequences with kMax-1 Ns (compute.go:569-629).
        big = concat_with_ns([r.seq for r in records], k_max)
        genome_size = len(big)
        seq_len = genome_size
        n_seqs = len(records)

        greedy = True
        circular2 = False
        if seq_len < opt.split_min_ref:
            window, step, greedy, split_num = seq_len, seq_len, False, 1
        elif split_by_number:
            if circular0 and n_seqs == 1:
                circular2, greedy = True, False
                window, step = split_chunk_size(
                    seq_len, opt.split_number, overlap, circular=True
                )
            else:
                window, step = split_chunk_size(
                    seq_len, opt.split_number, overlap, circular=False
                )
            split_num = opt.split_number
        else:  # split by size
            window, step = opt.split_size, opt.split_size - overlap
            split_num = 0  # counted below

        # Count actual chunks with the same skip rules (compute.go:703-724).
        chunks = [
            (start, sub)
            for start, sub in slider(big, window, step, circular2, greedy)
            if not (len(sub) - 1 <= overlap or len(sub) < k_min)
        ]
        actual_chunks = len(chunks)
        if actual_chunks == 0:
            return []

        for frag_idx, (_start, sub) in enumerate(chunks):
            codes = sketch(sub)
            codes = unique_sorted(codes)
            out_file = os.path.join(
                out_dir, f"{ref_name}-chunk_{frag_idx}.kset"
            )
            write_kset(
                out_file,
                codes,
                meta_for(ref_name, frag_idx, genome_size, actual_chunks),
            )
            infos.append(
                KsetFileInfo(
                    path=out_file,
                    name=ref_name,
                    index=frag_idx,
                    indexes=actual_chunks,
                    kmers=len(codes),
                    genome_size=genome_size,
                )
            )
    elif by_seq:
        # one output per sequence (compute.go --by-seq)
        for rec in records:
            codes = unique_sorted(sketch(rec.seq))
            out_file = os.path.join(out_dir, f"{base_file}-id_{rec.id}.kset")
            write_kset(out_file, codes, meta_for(rec.id, 0, len(rec.seq), 1))
            infos.append(
                KsetFileInfo(
                    path=out_file,
                    name=rec.id,
                    index=0,
                    indexes=1,
                    kmers=len(codes),
                    genome_size=len(rec.seq),
                )
            )
    else:
        # whole file pooled into one k-mer set (compute.go:894-962)
        genome_size = sum(len(r.seq) for r in records)
        parts = [sketch(r.seq) for r in records]
        codes = unique_sorted(np.concatenate(parts)) if parts else np.empty(0, np.uint64)
        if len(codes) == 0:
            return []
        out_file = os.path.join(out_dir, f"{base_file}.kset")
        write_kset(out_file, codes, meta_for(ref_name, 0, genome_size, 1))
        infos.append(
            KsetFileInfo(
                path=out_file,
                name=ref_name,
                index=0,
                indexes=1,
                kmers=len(codes),
                genome_size=genome_size,
            )
        )
    return infos


def run_compute(
    out_dir: str,
    in_dir: str | None = None,
    files: list[str] | None = None,
    opt: ComputeOptions | None = None,
    force: bool = False,
    verbose: bool = True,
) -> list[KsetFileInfo]:
    opt = opt or ComputeOptions()
    all_files = list_input_files(in_dir, files or [], opt.file_regexp)
    if not all_files:
        raise SystemExit("kmcp-tpu-torch compute: no input files")
    if os.path.exists(out_dir):
        if not force and os.listdir(out_dir):
            raise SystemExit(
                f"kmcp-tpu-torch compute: out dir exists: {out_dir} (use --force)"
            )
    os.makedirs(out_dir, exist_ok=True)

    workers = opt.threads or os.cpu_count() or 1
    # hashed 3-level output tree for big runs (compute.go:498: by-seq or
    # >1000 input files)
    tree = opt.by_seq or len(all_files) > 1000
    infos: list[KsetFileInfo] = []
    from ..utils.progress import ProgressBar

    with ProgressBar(
        len(all_files), "compute", unit="files",
        enabled=verbose and len(all_files) > 1,
    ) as bar:
        if workers == 1 or len(all_files) == 1:
            for f in all_files:
                infos.extend(compute_file(f, out_dir, opt, tree))
                bar.advance()
        else:
            # threads beat processes here: the hot work (native OpenMP
            # scan, numpy sort/unique) releases the GIL, and forked
            # workers pay page-fault + imbalance costs (2-2.6x slower)
            def one(f):
                res = compute_file(f, out_dir, opt, tree)
                bar.advance()
                return res

            with cf.ThreadPoolExecutor(max_workers=workers) as ex:
                for res in ex.map(one, all_files):
                    infos.extend(res)
    ksetmod.write_info(out_dir, infos)
    if verbose:
        print(
            f"[compute] {len(all_files)} genome file(s) -> {len(infos)} chunk .kset file(s) in {out_dir}",
            file=sys.stderr,
        )
    return infos
