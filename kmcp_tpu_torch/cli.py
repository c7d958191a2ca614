"""kmcp-tpu-torch command line: ``compute`` and ``index`` on the host,
``search`` on a torch device.

    python -m kmcp_tpu_torch compute -I GENOMES -O KMERS -k 21 -n 10 -l 150
    python -m kmcp_tpu_torch index -I KMERS -O DB -n 1 -f 0.3 --tpu-native
    python -m kmcp_tpu_torch search --device cuda -d DB reads.fq -o out.tsv.gz

Port of kmcp_tpu/cli.py (``build_parser`` :19-335 for these three
subcommands and the global flags, ``main`` :336, the dispatch :398-495),
writing the same files.  ``--device`` defaults to ``cuda``; ``--device
cpu`` runs the kernels' plain PyTorch versions.  ``merge``, ``profile``
and ``utils`` exit non-zero: they are not ported yet (ROADMAP A11).
"""

from __future__ import annotations

import argparse
import sys

from . import __version__

NOT_PORTED = ("merge", "profile", "utils")


def _int_list(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x.strip()]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kmcp-tpu-torch",
        description="kmcp-tpu's metagenomic search on a torch device "
        "(PyTorch/CUDA port)",
    )
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("-j", "--threads", type=int, default=0, help="threads (0=auto)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument(
        "-i", "--infile-list", default=None,
        help="file with one input file path per line (added to positional inputs)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    # ------------------------------------------------------------ compute
    c = sub.add_parser("compute", help="generate k-mer/sketch files from genomes")
    c.add_argument("files", nargs="*", help="FASTA/Q files")
    c.add_argument("-I", "--in-dir", default=None)
    c.add_argument("-O", "--out-dir", required=True)
    c.add_argument("-k", "--kmer", type=_int_list, default=[21])
    c.add_argument("--circular", action="store_true")
    c.add_argument("-D", "--scale", type=int, default=1)
    c.add_argument("-W", "--minimizer-w", type=int, default=0)
    c.add_argument("-S", "--syncmer-s", type=int, default=0)
    c.add_argument("-n", "--split-number", type=int, default=0)
    c.add_argument("-s", "--split-size", type=int, default=0)
    c.add_argument("-l", "--split-overlap", type=int, default=-1)
    c.add_argument("--split-min-ref", type=int, default=1000)
    c.add_argument("--by-seq", action="store_true")
    c.add_argument("-r", "--file-regexp", default=None)
    c.add_argument("-N", "--ref-name-regexp", default="")
    c.add_argument("-B", "--seq-name-filter", action="append", default=[])
    c.add_argument("--force", action="store_true")

    # -------------------------------------------------------------- index
    i = sub.add_parser("index", help="build the bit-sliced Bloom index")
    i.add_argument("-I", "--in-dir", required=True)
    i.add_argument("-O", "--out-dir", required=True)
    i.add_argument("-n", "--num-hash", type=int, default=1)
    i.add_argument("-f", "--false-positive-rate", type=float, default=0.3)
    i.add_argument("-b", "--block-size", type=int, default=0)
    i.add_argument("-x", "--block-sizeX-kmers-t", type=int, default=10_000_000)
    i.add_argument("-X", "--block-sizeX", type=int, default=256)
    i.add_argument("-8", "--block-size8-kmers-t", dest="block_size8_kmers_t",
                   type=int, default=20_000_000)
    i.add_argument("-1", "--block-size1-kmers-t", dest="block_size1_kmers_t",
                   type=int, default=200_000_000)
    i.add_argument("-a", "--alias", default="")
    i.add_argument("--dry-run", action="store_true")
    i.add_argument("--force", action="store_true")
    i.add_argument(
        "--tpu-native", action="store_true",
        help="wide-block layout (many targets per Bloom row; not "
        "bit-compatible with reference block partitioning)",
    )
    i.add_argument("--native-block-targets", type=int, default=4096)
    i.add_argument(
        "--block-screen", action="store_true",
        help="also build per-block k-mer-union Bloom screens so reads "
        "skip blocks they share no k-mers with (large-T search; changes "
        "which false-positive-only matches appear)",
    )
    i.add_argument(
        "--uniform-sigs", action="store_true",
        help="size every block's Bloom (and union screen) by the global "
        "maximum so all blocks share one modulus geometry - required by "
        "the device two-pass screened search on heterogeneous inputs",
    )

    # ------------------------------------------------------------- search
    s = sub.add_parser("search", help="search sequences against a database")
    s.add_argument("files", nargs="*")
    s.add_argument("-d", "--db-dir", required=True)
    s.add_argument("-1", "--read1", dest="read1", default=None)
    s.add_argument("-2", "--read2", dest="read2", default=None)
    s.add_argument("-o", "--out-file", default="-")
    s.add_argument("-m", "--min-query-len", type=int, default=30)
    s.add_argument("-c", "--min-kmers", type=int, default=10)
    s.add_argument("-t", "--min-query-cov", type=float, default=0.55)
    s.add_argument("-T", "--min-target-cov", type=float, default=0.0)
    s.add_argument("-f", "--max-fpr", type=float, default=0.01)
    s.add_argument("-u", "--kmer-dedup-threshold", type=int, default=256)
    s.add_argument("-g", "--query-whole-file", action="store_true")
    s.add_argument("-G", "--use-filename", action="store_true",
                   help="with -g: the query id is the file name")
    s.add_argument("--query-id", default="",
                   help="with -g: the query id")
    s.add_argument("-n", "--keep-top-scores", type=int, default=0)
    s.add_argument("-N", "--name-map", action="append", default=[])
    s.add_argument("-D", "--default-name-map", action="store_true")
    s.add_argument("-K", "--keep-unmatched", action="store_true")
    s.add_argument("-H", "--no-header-row", action="store_true")
    s.add_argument("-s", "--sort-by", default="qcov",
                   choices=["qcov", "tcov", "jacc"])
    s.add_argument("-S", "--do-not-sort", action="store_true")
    s.add_argument("--try-se", action="store_true")
    s.add_argument("-w", "--load-whole-db", action="store_true",
                   help="read index fully into RAM instead of mmap")
    s.add_argument("--low-mem", action="store_true",
                   help="row-seek mode (not ported: refused)")
    s.add_argument("--backend", default="numpy",
                   choices=["numpy", "jax", "host"],
                   help="kmcp_tpu's engine choice; the port searches on "
                   "--device and refuses any other value than numpy")
    s.add_argument("--batch-size", type=int, default=8192,
                   help="reads per batch (the device streams at least "
                   "16,384)")
    s.add_argument(
        "--device", default="cuda",
        help="torch device for the search: cuda (the CUDA kernels) or cpu "
        "(their plain PyTorch versions)",
    )

    for name in NOT_PORTED:
        sub.add_parser(name, help="not ported yet (ROADMAP A11)",
                       add_help=False)
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.command in NOT_PORTED:
        raise SystemExit(
            f"kmcp-tpu-torch {args.command}: not ported yet (ROADMAP A11)"
        )
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.infile_list and hasattr(args, "files"):
        with open(args.infile_list) as f:
            args.files = list(args.files) + [
                line.strip() for line in f if line.strip()
            ]
    try:
        return _dispatch(args)
    except FileNotFoundError as e:
        raise SystemExit(
            f"kmcp-tpu-torch {args.command}: file not found: {e.filename}"
        )
    except IsADirectoryError as e:
        raise SystemExit(
            f"kmcp-tpu-torch {args.command}: is a directory, expected a "
            f"file: {e.filename}"
        )
    except PermissionError as e:
        raise SystemExit(
            f"kmcp-tpu-torch {args.command}: permission denied: {e.filename}"
        )
    except NotImplementedError as e:
        raise SystemExit(
            f"kmcp-tpu-torch {args.command}: not ported yet: {e}"
        )
    except ValueError as e:
        raise SystemExit(f"kmcp-tpu-torch {args.command}: {e}")


def _dispatch(args) -> int:
    if args.command == "compute":
        from .commands.compute import FASTX_RE, ComputeOptions, run_compute

        opt = ComputeOptions(
            ks=args.kmer,
            circular=args.circular,
            scale=args.scale,
            minimizer_w=args.minimizer_w,
            syncmer_s=args.syncmer_s,
            split_number=args.split_number,
            split_size=args.split_size,
            split_overlap=args.split_overlap,
            split_min_ref=args.split_min_ref,
            by_seq=args.by_seq,
            file_regexp=args.file_regexp or FASTX_RE,
            ref_name_regexp=args.ref_name_regexp,
            seq_name_filter=args.seq_name_filter,
            threads=args.threads,
        )
        run_compute(
            out_dir=args.out_dir,
            in_dir=args.in_dir,
            files=args.files,
            opt=opt,
            force=args.force,
            verbose=not args.quiet,
        )
        return 0

    if args.command == "index":
        from .index.build import run_index

        run_index(
            in_dir=args.in_dir,
            out_dir=args.out_dir,
            num_hashes=args.num_hash,
            fpr=args.false_positive_rate,
            block_size=args.block_size,
            threads=args.threads,
            threshold_x=args.block_sizeX_kmers_t,
            block_size_x=args.block_sizeX,
            threshold_8=args.block_size8_kmers_t,
            threshold_1=args.block_size1_kmers_t,
            alias=args.alias,
            force=args.force,
            dry_run=args.dry_run,
            block_screen=args.block_screen,
            tpu_native=args.tpu_native,
            native_block_targets=args.native_block_targets,
            uniform_sigs=args.uniform_sigs,
            verbose=not args.quiet,
        )
        return 0

    from .commands.search import run_search
    from .search.engine import SearchOptions

    if args.backend != "numpy":
        raise SystemExit(
            "kmcp-tpu-torch search: --backend selects a kmcp_tpu engine; "
            "this command searches on --device"
        )
    name_map = {}
    for nm_file in args.name_map:
        with open(nm_file) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    name_map[parts[0]] = parts[1]
    opt = SearchOptions(
        min_query_len=args.min_query_len,
        min_kmers=args.min_kmers,
        min_query_cov=args.min_query_cov,
        min_target_cov=args.min_target_cov,
        max_fpr=args.max_fpr,
        kmer_dedup_threshold=args.kmer_dedup_threshold,
        sort_by=args.sort_by,
        do_not_sort=args.do_not_sort,
        keep_top_scores=args.keep_top_scores,
        try_se=args.try_se,
        keep_unmatched=args.keep_unmatched,
        name_map=name_map,
        load_default_name_map=args.default_name_map,
        batch_size=args.batch_size,
        load_whole_db=args.load_whole_db,
        low_mem=args.low_mem,
    )
    run_search(
        db_dir=args.db_dir,
        files=args.files,
        read1=args.read1,
        read2=args.read2,
        out_file=args.out_file,
        opt=opt,
        whole_file=args.query_whole_file,
        no_header_row=args.no_header_row,
        device=args.device,
        verbose=not args.quiet,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
