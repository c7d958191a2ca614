"""``utils`` subcommands — introspection and helper tools.

The port's copy of kmcp_tpu/commands/utils_cmds.py: equivalents of
KMCP's ``kmcp utils`` family (cmd/utils.go): kset-info (= unik-info),
index-info, ref-info, index-density, cov2simi, query-fpr, filter,
merge-regions, split-genomes.  ``export-ref-db`` is index/uniki.py's
``export_ref_layout``, called from cli.py.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from ..index.format import find_db_dirs, read_block_bits, read_block_meta, read_db_info
from ..index.sizing import calc_fpr
from ..kmer import kset as ksetmod
from ..kmer.nthash import hash_all
from ..search.fpr import chernoff_fpr, query_fpr
from ..seqio.fastx import read_fastx, slider, split_chunk_size, xopen


def _out(out_file: str):
    return sys.stdout if out_file == "-" else xopen(out_file, "wt")


def similarity(qcov: float) -> float:
    """Fitted cubic qcov -> % sequence similarity (profile.go:3183-3187)."""
    sq = qcov * qcov
    return 87.456 + 26.410 * qcov - 22.008 * sq + 7.325 * sq * qcov


# ---------------------------------------------------------------- cov2simi


def run_cov2simi(query_cov: float = 0.0, files=None, out_file: str = "-"):
    out = _out(out_file)
    try:
        if query_cov > 0:
            out.write(f"{query_cov:.6f}\t{similarity(query_cov):.6f}\n")
            return
        for path in files or []:
            with xopen(path, "rt") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    out.write(f"{line}\t{similarity(float(line)):.6f}\n")
    finally:
        if out is not sys.stdout:
            out.close()


# --------------------------------------------------------------- query-fpr


def run_query_fpr(
    fpr: float = 0.3, matched: int = 35, num_kmers: int = 70,
    show_all: bool = False, add_header: bool = False, out_file: str = "-",
):
    out = _out(out_file)
    try:
        v = query_fpr(num_kmers, matched, fpr)
        cb = chernoff_fpr(fpr, matched / num_kmers, num_kmers)
        if show_all:
            if add_header:
                out.write("fpr\tcbound\tfpr0\tnKmers\tmKmers\n")
            out.write(f"{v:.4e}\t{cb:f}\t{fpr:f}\t{num_kmers}\t{matched}\n")
        else:
            if add_header:
                out.write("fpr\n")
            out.write(f"{v:.4e}\n")
    finally:
        if out is not sys.stdout:
            out.close()


# --------------------------------------------------------------- kset-info


def run_kset_info(in_dir: str, out_file: str = "-"):
    """Per-.kset metadata table (= utils unik-info)."""
    infos = ksetmod.read_info(in_dir)
    out = _out(out_file)
    try:
        out.write(
            "file\tk\tcanonical\thashed\tscaled\tscale\tsorted\tnumber\t"
            "name\tchunkIdx\tchunks\tgenomeSize\n"
        )
        for i in infos:
            _, meta = ksetmod.read_kset(i.path)
            ks = ",".join(str(k) for k in meta.ks)
            out.write(
                f"{os.path.relpath(i.path, in_dir)}\t{ks}\ttrue\ttrue\t"
                f"{str(meta.scaled).lower()}\t{meta.scale}\ttrue\t{i.kmers}\t"
                f"{i.name}\t{i.index}\t{i.indexes}\t{i.genome_size}\n"
            )
    finally:
        if out is not sys.stdout:
            out.close()


# -------------------------------------------------------------- index-info


def _db_block_metas(d: str):
    """(info, [(block_file, meta), ...]) for either DB layout — ours
    (db.json + block_NNN.*) or the reference's (__db.yml +
    _blockNNN.uniki, read via index/uniki.py)."""
    from ..index.uniki import DB_YML, load_ref_db

    if os.path.isfile(os.path.join(d, DB_YML)):
        info, blocks = load_ref_db(d, meta_only=True)
        return info, list(zip(info.blocks, (m for m, _ in blocks)))
    info = read_db_info(d)
    return info, [
        (f, read_block_meta(d, i)) for i, f in enumerate(info.blocks)
    ]


def run_index_info(db_dir: str, out_file: str = "-", basename: bool = False):
    out = _out(out_file)
    try:
        out.write(
            "file\tversion\tk\tcanonical\tnum-hashes\tnum-sigs\t"
            "num-names\tnames\n"
        )
        if os.path.isfile(db_dir) and db_dir.endswith(".uniki"):
            # a single reference .uniki block file (index-info.go:72-114)
            from ..index.uniki import read_uniki

            h, _ = read_uniki(db_dir)
            names = ",".join(n[0] if n else "" for n in h.names)
            out.write(
                f"{db_dir}\t{h.version}\t{h.k}\t"
                f"{str(h.canonical).lower()}\t{h.num_hashes}\t"
                f"{h.num_sigs}\t{len(h.names)}\t{names}\n"
            )
            return
        for d in find_db_dirs(db_dir):
            info, blocks = _db_block_metas(d)
            ks = ",".join(str(k) for k in info.ks)
            for bfile, meta in blocks:
                name = bfile if basename else os.path.join(d, bfile)
                out.write(
                    f"{name}\t{info.version}\t{ks}\t"
                    f"{str(info.canonical).lower()}\t{info.num_hashes}\t"
                    f"{meta.num_sigs}\t{meta.num_targets}\t"
                    f"{','.join(meta.names)}\n"
                )
    finally:
        if out is not sys.stdout:
            out.close()


# ---------------------------------------------------------------- ref-info


def run_ref_info(db_dir: str, out_file: str = "-"):
    """Per-chunk k-mer counts and actual FPR (ref-info.go:108-148)."""
    out = _out(out_file)
    try:
        out.write("file\ti\ttarget\tchunkIdx\tchunks\tkmers\tfpr\n")
        for d in find_db_dirs(db_dir):
            info, blocks = _db_block_metas(d)
            for bfile, meta in blocks:
                for i in range(meta.num_targets):
                    n = meta.sizes[i]
                    fpr = calc_fpr(n, info.num_hashes, meta.num_sigs)
                    idx = meta.indices[i]
                    out.write(
                        f"{os.path.join(d, bfile)}\t{i + 1}\t{meta.names[i]}"
                        f"\t{idx & 0xFFFF}\t{idx >> 16}\t{n}\t{fpr:f}\n"
                    )
    finally:
        if out is not sys.stdout:
            out.close()


# ------------------------------------------------------------ index-density


def run_index_density(db_dir: str, out_file: str, bins: int = 512):
    """Bit-density heatmap of each block's Bloom matrix.

    The reference renders a grayscale JPEG (index-density.go:44-69); we
    do the same when Pillow is available (out file ending .jpg/.jpeg/
    .png), always with a portable PGM + TSV alongside — same
    information, dependency-optional."""
    rows = []
    labels = []
    for d in find_db_dirs(db_dir):
        from ..index.uniki import DB_YML, load_ref_db

        if os.path.isfile(os.path.join(d, DB_YML)):
            info, ref_blocks = load_ref_db(d)
            block_data = list(enumerate(b for _, b in ref_blocks))
            metas = [m for m, _ in ref_blocks]
        else:
            info = read_db_info(d)
            block_data = [
                (i, read_block_bits(d, i)) for i in range(len(info.blocks))
            ]
            metas = [
                read_block_meta(d, i) for i in range(len(info.blocks))
            ]
        for bid, bits in block_data:
            meta = metas[bid]
            S = bits.shape[0]
            edges = np.linspace(0, S, bins + 1).astype(np.int64)
            for t in range(meta.num_targets):
                col = (bits[:, t >> 5] >> np.uint32(t & 31)) & np.uint32(1)
                dens = np.add.reduceat(col, edges[:-1]).astype(np.float64)
                widths = np.diff(edges)
                dens = dens / np.maximum(widths, 1)
                rows.append(dens)
                labels.append(f"{bid}:{meta.names[t]}")
    img = np.array(rows)
    if img.size == 0:
        raise SystemExit("kmcp-tpu-torch utils index-density: empty database")
    mx = img.max() or 1.0
    gray = (255 * (1 - img / mx)).astype(np.uint8)
    wrote = None
    if out_file.lower().endswith((".jpg", ".jpeg", ".png")):
        # the reference's JPEG heatmap (index-density.go:44-69)
        try:
            from PIL import Image

            Image.fromarray(gray, mode="L").save(out_file)
            wrote = out_file
        except ImportError:
            pass
    pgm = (
        out_file if out_file.endswith(".pgm")
        else os.path.splitext(out_file)[0] + ".pgm"
    )
    with open(pgm, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (gray.shape[1], gray.shape[0]))
        f.write(gray.tobytes())
    with open(pgm + ".tsv", "w") as f:
        f.write("target\t" + "\t".join(str(i) for i in range(bins)) + "\n")
        for lab, r in zip(labels, img):
            f.write(lab + "\t" + "\t".join(f"{v:.4f}" for v in r) + "\n")
    wrote = wrote or pgm
    print(f"[index-density] wrote {wrote} ({gray.shape[0]}x{gray.shape[1]})",
          file=sys.stderr)


# ------------------------------------------------------------------ filter


def run_filter(
    files: list[str], out_file: str = "-", max_fpr: float = 0.05,
    min_qcov: float = 0.55, level: str = "species",
    taxid_map_files=None, taxdump_dir=None,
):
    """Keep only assembly-/species-specific queries (filter.go:280-391)."""
    level_species = level == "species"
    taxdb = None
    taxid_map = {}
    if level_species:
        if not (taxid_map_files and taxdump_dir):
            raise SystemExit(
                "utils filter: -T/--taxid-map and -X/--taxdump needed for "
                "--level species"
            )
        from ..profile.taxonomy import Taxonomy, load_taxid_map

        taxid_map = load_taxid_map(taxid_map_files)
        taxdb = Taxonomy(taxdump_dir)

    out = _out(out_file)
    n_reads = n_passed = 0
    try:
        for path in files:
            prev_query = None
            groups: dict[str, list[str]] = {}
            with xopen(path, "rt") as f:
                for line in f:
                    if not line.strip() or line[0] == "#":
                        continue
                    items = line.split("\t", 12)
                    if len(items) < 13:
                        raise SystemExit("invalid search result format")
                    if float(items[3]) > max_fpr:
                        continue
                    if float(items[11]) < min_qcov:
                        continue
                    query, target = items[0], items[5]
                    if query != prev_query and prev_query is not None:
                        n_reads += 1
                        n_passed += _filter_flush(
                            groups, out, level_species, taxid_map, taxdb
                        )
                        groups = {}
                    groups.setdefault(target, []).append(line)
                    prev_query = query
            if groups:
                n_reads += 1
                n_passed += _filter_flush(
                    groups, out, level_species, taxid_map, taxdb
                )
        print(
            f"[filter] {n_passed}/{n_reads} queries kept", file=sys.stderr
        )
    finally:
        if out is not sys.stdout:
            out.close()


def _filter_flush(groups, out, level_species, taxid_map, taxdb) -> int:
    if not groups:
        return 0
    keep = len(groups) == 1
    if not keep and level_species:
        taxids = []
        for target in groups:
            t = taxid_map.get(target)
            if t is None:
                raise SystemExit(f"unknown taxid for {target}")
            taxids.append(t)
        lca = taxdb.lca_many(taxids)
        keep = taxdb.at_or_below_rank(lca, "species")
    if keep:
        for lines in groups.values():
            for line in lines:
                out.write(line)
        return 1
    return 0


# ----------------------------------------------------------- merge-regions


def run_merge_regions(
    files: list[str], out_file: str = "-", max_fpr: float = 0.05,
    min_qcov: float = 0.55, min_overlap: int = 1, max_gap: int = 0,
    regexp: str = r"^(.+)_sliding:(\d+)\-(\d+)$",
    name_species: str = "species-specific",
    name_assembly: str = "assembly-specific",
    ignore_type: bool = False,
):
    """Merge overlapping sliding-window matches into BED6 regions
    (merge-regions.go:150-416)."""
    re_query = re.compile(regexp)
    limit_gap = max_gap > 0
    out = _out(out_file)
    n_regions = 0

    try:
        for path in files:
            prev_query = None
            groups: dict[str, tuple[str, int, int, float]] = {}
            ref0 = None
            begin0 = end0 = 0
            name0 = ""
            score0 = 0.0
            begin1 = end1 = 0

            def flush_group():
                nonlocal ref0, begin0, end0, name0, score0, begin1, end1, n_regions
                if not groups:
                    return
                vals = list(groups.values())
                ref, begin, end = vals[0][0], vals[0][1], vals[0][2]
                score = sum(v[3] for v in vals)
                if len(groups) == 1:
                    name = name_assembly
                    score = vals[0][3]
                else:
                    name = name_species
                    score /= len(groups)
                if begin0 > 0:
                    extend = (
                        ref == ref0
                        and begin + min_overlap - 1 <= end1
                        and (ignore_type or name == name0)
                    )
                    if extend and limit_gap and begin - begin1 > max_gap:
                        extend = False
                    if extend:
                        end0 = end
                        if name0 != name:
                            name0 = name_species
                        if name0 == name_species:
                            score0 = (score0 + score) / 2
                    else:
                        n_regions += 1
                        out.write(
                            f"{ref0}\t{begin0 - 1}\t{end0}\t{name0}\t"
                            f"{score0 * 1000:.0f}\t.\n"
                        )
                        ref0, begin0, end0, name0, score0 = ref, begin, end, name, score
                else:
                    ref0, begin0, end0, name0, score0 = ref, begin, end, name, score
                begin1, end1 = begin, end

            with xopen(path, "rt") as f:
                for line in f:
                    if not line.strip() or line[0] == "#":
                        continue
                    items = line.rstrip("\n").split("\t")
                    if len(items) < 13:
                        raise SystemExit("invalid search result format")
                    if float(items[3]) > max_fpr:
                        continue
                    qcov = float(items[11])
                    if qcov < min_qcov:
                        continue
                    query, target = items[0], items[5]
                    m = re_query.search(query)
                    if not m:
                        raise SystemExit(
                            "no reference and location found in the query name"
                        )
                    ref, b, e = m.group(1), int(m.group(2)), int(m.group(3))
                    if query != prev_query and prev_query is not None:
                        flush_group()
                        groups = {}
                    if target not in groups:
                        groups[target] = (ref, b, e, qcov)
                    prev_query = query
            flush_group()
            if ref0 is not None and begin0 > 0:
                n_regions += 1
                out.write(
                    f"{ref0}\t{begin0 - 1}\t{end0}\t{name0}\t"
                    f"{score0 * 1000:.0f}\t.\n"
                )
        print(f"[merge-regions] {n_regions} regions", file=sys.stderr)
    finally:
        if out is not sys.stdout:
            out.close()


# ----------------------------------------------------------- split-genomes


def run_split_genomes(
    files: list[str], out_dir: str, k: int = 21, split_number: int = 0,
    split_overlap: int = 0, split_min_ref: int = 1000, frag_size: int = 100,
    circular: bool = False, seq_name_filter=None, force: bool = False,
    info_file: str | None = None,
):
    """Split genome(s) into chunk FASTA files (split-genomes.go).

    Single-genome mode: same chunk math as compute.  Multi-genome mode:
    the genome with the fewest contigs (tie: largest) is the reference;
    its chunks seed per-chunk k-mer sets, then every other genome is cut
    into ``frag_size`` windows (step = frag_size - k + 1) and each
    fragment is appended to the chunk(s) sharing the most k-mers —
    unless it matches one chunk perfectly (split-genomes.go:440-592)."""
    if split_number < 1:
        raise SystemExit("utils split-genomes: -n/--split-number needed (>=1)")
    if os.path.exists(out_dir) and os.listdir(out_dir) and not force:
        raise SystemExit(f"out dir exists: {out_dir} (use --force)")
    os.makedirs(out_dir, exist_ok=True)
    filters = [re.compile(p, re.IGNORECASE) for p in (seq_name_filter or [])]

    genomes = []
    for path in files:
        seqs = [
            r.seq
            for r in read_fastx(path)
            if not any(rx.search(r.name) for rx in filters)
        ]
        if seqs:
            genomes.append((path, seqs))
    if not genomes:
        raise SystemExit("no input sequences")

    # choose the reference: fewest contigs, then largest (chooseRef,
    # split-genomes.go:864-948)
    genomes.sort(key=lambda g: (len(g[1]), -sum(len(s) for s in g[1])))
    ref_path, ref_seqs = genomes[0]
    others = genomes[1:]

    big = (b"N" * (k - 1)).join(ref_seqs)
    overlap = split_overlap if split_overlap > 0 else k - 1
    L = len(big)
    if L < split_min_ref:
        window, step = L, L
    else:
        window, step = split_chunk_size(L, split_number, overlap, False)
    chunks = [
        sub
        for _start, sub in slider(big, window, step, False, True)
        if not (len(sub) - 1 <= overlap or len(sub) < k)
    ]

    chunk_sets = []
    out_paths = []
    for i, sub in enumerate(chunks):
        h, _ = hash_all(sub, k)
        chunk_sets.append(set(h[h != 0].tolist()))
        p = os.path.join(out_dir, f"chunk_{i:03d}.fa.gz")
        out_paths.append(p)
    handles = [xopen(p, "wt") for p in out_paths]
    try:
        base = os.path.basename(ref_path)
        for i, sub in enumerate(chunks):
            handles[i].write(f">{base}_chunk{i}\n")
            s = sub.decode()
            for j in range(0, len(s), 70):
                handles[i].write(s[j : j + 70] + "\n")

        info_fh = open(info_file, "w") if info_file else None
        frag_step = frag_size - k + 1
        perfect_n = frag_size - k + 1
        for path, seqs in others:
            base = os.path.basename(path)
            for si, s in enumerate(seqs):
                loc = 0
                for _start, frag in slider(s, frag_size, frag_step, False, True):
                    if len(frag) - 1 < k:
                        loc += frag_step
                        continue
                    h, _ = hash_all(frag, k)
                    codes = h[h != 0]
                    hits = [
                        sum(1 for c in codes.tolist() if c in cs)
                        for cs in chunk_sets
                    ]
                    mx = max(hits) if hits else 0
                    if mx == perfect_n:
                        loc += frag_step
                        continue
                    for ci, hit in enumerate(hits):
                        if hit == mx:
                            handles[ci].write(f">{base}_s{si}_f{loc}\n")
                            fs = frag.decode()
                            for j in range(0, len(fs), 70):
                                handles[ci].write(fs[j : j + 70] + "\n")
                            if info_fh:
                                info_fh.write(
                                    f"{path}\t{base}\t{hit}\t{ci + 1}\t{loc + 1}\n"
                                )
                    loc += frag_step
        if info_fh:
            info_fh.close()
    finally:
        for h in handles:
            h.close()
    print(
        f"[split-genomes] {len(chunks)} chunk files in {out_dir} "
        f"(ref: {os.path.basename(ref_path)}, {len(others)} other genome(s))",
        file=sys.stderr,
    )
