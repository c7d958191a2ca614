"""kmcp-tpu-torch command line: ``search`` runs on a torch device; every
other subcommand is host code and goes to ``kmcp_tpu.cli.main`` unchanged.

    python -m kmcp_tpu_torch search --device cuda -d DB reads.fq -o out.tsv.gz

``--device`` defaults to ``cuda``; ``--device cpu`` runs the kernels' plain
PyTorch versions.  Port of kmcp_tpu/cli.py (``build_parser`` :19, ``main``
:336, the search dispatch :452-495).
"""

from __future__ import annotations

import argparse
import sys

from kmcp_tpu import cli as host_cli


def build_parser() -> argparse.ArgumentParser:
    p = host_cli.build_parser()
    p.prog = "kmcp-tpu-torch"
    sub = next(a for a in p._actions
               if isinstance(a, argparse._SubParsersAction))
    sub.choices["search"].add_argument(
        "--device", default="cuda",
        help="torch device for the search: cuda (the CUDA kernels) or cpu "
        "(their plain PyTorch versions)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.command != "search":
        return host_cli.main(argv)

    from kmcp_tpu.search.engine import SearchOptions

    from .commands.search import run_search

    if args.backend != "numpy":
        raise SystemExit(
            "kmcp-tpu-torch search: --backend selects a kmcp_tpu engine; "
            "this command searches on --device"
        )
    if args.log:
        raise SystemExit("kmcp-tpu-torch search: --log is not supported")
    files = list(args.files)
    if args.infile_list:
        with open(args.infile_list) as f:
            files += [line.strip() for line in f if line.strip()]
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
        load_whole_db=args.load_whole_db,
        low_mem=args.low_mem,
    )
    try:
        run_search(
            db_dir=args.db_dir,
            files=files,
            read1=args.read1,
            read2=args.read2,
            out_file=args.out_file,
            opt=opt,
            whole_file=args.query_whole_file,
            use_filename=args.use_filename,
            query_id=args.query_id,
            no_header_row=args.no_header_row,
            device=args.device,
            verbose=not args.quiet,
        )
    except NotImplementedError as e:
        raise SystemExit(f"kmcp-tpu-torch search: not ported yet: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
