"""kmcp-tpu-torch command line: ``search`` on a torch device, and
``compute``, ``index``, ``merge``, ``profile`` and ``utils`` on the host.

    python -m kmcp_tpu_torch compute -I GENOMES -O KMERS -k 21 -n 10 -l 150
    python -m kmcp_tpu_torch index -I KMERS -O DB -n 1 -f 0.3 --tpu-native
    python -m kmcp_tpu_torch search --device cuda -d DB reads.fq -o out.tsv.gz
    python -m kmcp_tpu_torch merge a.tsv.gz b.tsv.gz -o merged.tsv.gz
    python -m kmcp_tpu_torch profile -T taxid.map -X TAXDUMP out.tsv.gz \
        -o out.profile -C out.cami -B out.binning.gz
    python -m kmcp_tpu_torch utils query-fpr -f 0.3 -m 35 -n 70

Port of kmcp_tpu/cli.py (``build_parser`` :19-272, the completion script
:275-333, ``main`` :336, the dispatch :385-611), flag for flag with the same defaults, writing the same
files.  ``search --device`` defaults to ``cuda``; ``--device cpu`` runs
the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys

from . import __version__

PROG = "kmcp-tpu-torch"


def _int_list(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x.strip()]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="kmcp-tpu's metagenomic search on a torch device, and "
        "its profiling (PyTorch/CUDA port)",
    )
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("-j", "--threads", type=int, default=0, help="threads (0=auto)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument(
        "-i", "--infile-list", default=None,
        help="file with one input file path per line (added to positional inputs)",
    )
    p.add_argument("--log", default=None, help="tee log messages to this file")
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
                   help="row-seek mode (kmcp_tpu --backend host): ignored "
                   "on a torch device, with a warning")
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

    # ------------------------------------------------------------- profile
    pr = sub.add_parser("profile", help="generate taxonomic profile from search results")
    pr.add_argument("files", nargs="+")
    pr.add_argument("-o", "--out-file", default="-")
    pr.add_argument("-m", "--mode", type=int, default=3, choices=range(6))
    pr.add_argument("-f", "--max-fpr", type=float, default=0.01)
    pr.add_argument("-t", "--min-query-cov", type=float, default=0.55)
    pr.add_argument("-n", "--keep-top-qcovs", type=int, default=0)
    pr.add_argument("--keep-perfect-matches", action="store_true")
    pr.add_argument("--keep-main-matches", action="store_true", default=None)
    pr.add_argument("--max-qcov-gap", type=float, default=None)
    pr.add_argument("-r", "--min-chunks-reads", type=int, default=None)
    pr.add_argument("-p", "--min-chunks-fraction", type=float, default=None)
    pr.add_argument("-d", "--max-chunks-depth-stdev", type=float, default=None)
    pr.add_argument("-u", "--min-uniq-reads", type=int, default=None)
    pr.add_argument("-U", "--min-hic-ureads", type=int, default=None)
    pr.add_argument("-H", "--min-hic-ureads-qcov", type=float, default=None)
    pr.add_argument("-P", "--min-hic-ureads-prop", type=float, default=None)
    pr.add_argument("-D", "--min-dreads-prop", type=float, default=0.05)
    pr.add_argument("-R", "--max-mismatch-err", type=float, default=0.05)
    pr.add_argument("-F", "--filter-low-pct", type=float, default=0.0)
    pr.add_argument("--level", default="species", choices=["species", "strain", "assembly"])
    pr.add_argument("--norm-abund", default="mean", choices=["mean", "min", "max"])
    pr.add_argument("-I", "--abund-max-iters", type=int, default=10)
    pr.add_argument("--abund-pct-threshold", type=float, default=0.01)
    pr.add_argument("--no-amb-corr", action="store_true")
    pr.add_argument("-N", "--name-map", action="append", default=[])
    pr.add_argument("-T", "--taxid-map", action="append", default=[])
    pr.add_argument("-X", "--taxdump", default=None)
    pr.add_argument("-S", "--separator", default=";")
    pr.add_argument("-s", "--sample-id", default="")
    pr.add_argument("--taxonomy-id", default="")
    pr.add_argument("--show-rank", default=None,
                    help="comma-separated ranks to show in reports")
    pr.add_argument("--rank-prefix", default=None,
                    help="comma-separated clade prefixes for MetaPhlAn output")
    pr.add_argument("--line-chunk-size", type=int, default=5000,
                    help="accepted for CLI parity (parser is vectorized)")
    pr.add_argument("--low-mem", action="store_true",
                    help="bounded-memory chunked profiling (spills row "
                         "groups to disk; identical output)")
    pr.add_argument("-C", "--cami-report", default=None)
    pr.add_argument("-M", "--metaphlan-report", default=None)
    pr.add_argument("--metaphlan-report-version", default="3", choices=["2", "3"])
    pr.add_argument("-B", "--binning-result", default=None)
    pr.add_argument("--debug", default=None, metavar="FILE",
                    help="debug output file: per-target rejection trace "
                    "(forces the reference-faithful engine)")

    # --------------------------------------------------------------- utils
    u = sub.add_parser("utils", help="auxiliary/introspection subcommands")
    usub = u.add_subparsers(dest="utils_command", required=True)

    uc = usub.add_parser("cov2simi", help="k-mer coverage -> sequence similarity")
    uc.add_argument("files", nargs="*")
    uc.add_argument("-t", "--query-cov", type=float, default=0.0)
    uc.add_argument("-o", "--out-file", default="-")

    uq = usub.add_parser("query-fpr", help="false positive rate of a query")
    uq.add_argument("-f", "--false-positive-rate", type=float, default=0.3)
    uq.add_argument("-m", "--matched-kmers", type=int, default=35)
    uq.add_argument("-n", "--num-kmers", type=int, default=70)
    uq.add_argument("-a", "--all", action="store_true")
    uq.add_argument("-H", "--add-header", action="store_true")
    uq.add_argument("-o", "--out-file", default="-")

    uk = usub.add_parser("kset-info", help="per-.kset metadata (= unik-info)")
    uk.add_argument("-I", "--in-dir", required=True)
    uk.add_argument("-o", "--out-file", default="-")

    ui = usub.add_parser("index-info", help="index block headers")
    ui.add_argument("db_dir")
    ui.add_argument("-b", "--basename", action="store_true")
    ui.add_argument("-o", "--out-file", default="-")

    ur = usub.add_parser("ref-info", help="per-chunk k-mer counts and actual FPR")
    ur.add_argument("db_dir")
    ur.add_argument("-o", "--out-file", default="-")

    ux = usub.add_parser(
        "export-ref-db",
        help="write a database in the reference kmcp layout "
        "(R001/__db.yml + _blockNNN.uniki)",
    )
    ux.add_argument("db_dir")
    ux.add_argument("-O", "--out-dir", required=True)
    ux.add_argument("-a", "--alias", default="")

    ud = usub.add_parser("index-density", help="Bloom bit-density heatmap")
    ud.add_argument("db_dir")
    ud.add_argument("-o", "--out-file", required=True)
    ud.add_argument("--bins", type=int, default=512)

    uf = usub.add_parser("filter", help="keep species/assembly-specific queries")
    uf.add_argument("files", nargs="+")
    uf.add_argument("-o", "--out-file", default="-")
    uf.add_argument("-f", "--max-fpr", type=float, default=0.05)
    uf.add_argument("-t", "--min-query-cov", type=float, default=0.55)
    uf.add_argument("--level", default="species", choices=["species", "strain", "assembly"])
    uf.add_argument("-T", "--taxid-map", action="append", default=[])
    uf.add_argument("-X", "--taxdump", default=None)

    um = usub.add_parser("merge-regions", help="merge specific regions into BED6")
    um.add_argument("files", nargs="+")
    um.add_argument("-o", "--out-file", default="-")
    um.add_argument("-f", "--max-fpr", type=float, default=0.05)
    um.add_argument("-t", "--min-query-cov", type=float, default=0.55)
    um.add_argument("-l", "--min-overlap", type=int, default=1)
    um.add_argument("-g", "--max-gap", type=int, default=0)
    um.add_argument("-r", "--regexp", default=r"^(.+)_sliding:(\d+)\-(\d+)$")
    um.add_argument("--name-species", default="species-specific")
    um.add_argument("--name-assembly", default="assembly-specific")
    um.add_argument("-I", "--ignore-type", action="store_true")

    us = usub.add_parser("split-genomes", help="split genome(s) into chunk files")
    us.add_argument("files", nargs="+")
    us.add_argument("-O", "--out-dir", required=True)
    us.add_argument("-k", "--kmer", type=int, default=21)
    us.add_argument("-n", "--split-number", type=int, default=0)
    us.add_argument("-l", "--split-overlap", type=int, default=0)
    us.add_argument("-m", "--split-min-ref", type=int, default=1000)
    us.add_argument("-f", "--frag-size", type=int, default=100)
    us.add_argument("--circular", action="store_true")
    us.add_argument("-B", "--seq-name-filter", action="append", default=[])
    us.add_argument("--info-file", default=None)
    us.add_argument("--force", action="store_true")

    # ------------------------------------------------------------- version
    sub.add_parser("version", help="print version")

    # --------------------------------------------------------------- merge
    mg = sub.add_parser("merge", help="merge search results from multiple databases")
    mg.add_argument("files", nargs="+")
    mg.add_argument("-o", "--out-file", default="-")
    mg.add_argument("-n", "--keep-top-scores", type=int, default=0)
    mg.add_argument("-s", "--sort-by", default="qcov", choices=["qcov", "tcov", "jacc"])
    mg.add_argument("-S", "--do-not-sort", action="store_true")
    mg.add_argument("-H", "--no-header-row", action="store_true")

    # shell completion script
    ac = sub.add_parser(
        "autocompletion", help="generate shell autocompletion script"
    )
    ac.add_argument(
        "--shell", default="bash", choices=["bash", "zsh", "fish"]
    )
    ac.add_argument("-o", "--out-file", default="-")

    return p


def _autocompletion_script(parser, shell: str) -> str:
    """Completion script for ``kmcp-tpu-torch``, generated from the live
    argparse tree, so new subcommands and flags appear without touching
    this function."""
    subs = {}
    for act in parser._actions:
        if hasattr(act, "choices") and isinstance(act.choices, dict):
            for name, sp in act.choices.items():
                flags = []
                for a in sp._actions:
                    flags.extend(o for o in a.option_strings)
                    if hasattr(a, "choices") and isinstance(a.choices, dict):
                        flags.extend(a.choices)  # utils subcommands
                subs[name] = sorted(set(flags))
    top_flags = sorted(
        {o for a in parser._actions for o in a.option_strings}
    )
    if shell == "fish":
        lines = [
            f"complete -c {PROG} -n '__fish_use_subcommand' -a '{name}'"
            for name in subs
        ]
        for name, flags in subs.items():
            words = " ".join(f for f in flags if not f.startswith("-"))
            opts = " ".join(
                f.lstrip("-") for f in flags if f.startswith("--")
            )
            if words:
                lines.append(
                    f"complete -c {PROG} -n '__fish_seen_subcommand_from "
                    f"{name}' -a '{words}'"
                )
            for o in opts.split():
                lines.append(
                    f"complete -c {PROG} -n '__fish_seen_subcommand_from "
                    f"{name}' -l {o}"
                )
        return "\n".join(lines) + "\n"
    # bash and zsh (via bashcompinit) share one script
    cases = "\n".join(
        f'        {name}) opts="{" ".join(flags)}" ;;'
        for name, flags in subs.items()
    )
    return f"""# {PROG} {'' if shell == 'bash' else '(zsh: run bashcompinit first)'}
_kmcp_tpu_torch() {{
    local cur cmd opts
    cur="${{COMP_WORDS[COMP_CWORD]}}"
    cmd=""
    for w in "${{COMP_WORDS[@]:1:COMP_CWORD-1}}"; do
        case "$w" in -*) ;; *) cmd="$w"; break ;; esac
    done
    case "$cmd" in
{cases}
        *) opts="{" ".join(sorted(subs) + top_flags)}" ;;
    esac
    COMPREPLY=( $(compgen -W "$opts" -- "$cur") )
}}
complete -o default -F _kmcp_tpu_torch {PROG}
"""


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.log:
        # tee stderr to the log file (the reference's --log)
        import atexit

        class _Tee:
            def __init__(self, *streams):
                self.streams = streams

            def write(self, s):
                for st in self.streams:
                    st.write(s)

            def flush(self):
                for st in self.streams:
                    st.flush()

        fh = open(args.log, "w")
        atexit.register(fh.close)
        sys.stderr = _Tee(sys.__stderr__, fh)
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
    if args.command == "autocompletion":
        script = _autocompletion_script(build_parser(), args.shell)
        if args.out_file in ("-", ""):
            sys.stdout.write(script)
        else:
            with open(args.out_file, "w") as f:
                f.write(script)
            print(
                f"[autocompletion] wrote {args.out_file}", file=sys.stderr
            )
        return 0

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

    if args.command != "search":
        return _dispatch_host(args)

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
        use_filename=args.use_filename,
        query_id=args.query_id,
        no_header_row=args.no_header_row,
        device=args.device,
        verbose=not args.quiet,
    )
    return 0


def _dispatch_host(args) -> int:
    """``profile``, ``version``, ``utils`` and ``merge``."""
    if args.command == "profile":
        from .commands.profile import run_profile
        from .profile.core import ProfileOptions

        opt = ProfileOptions(
            mode=args.mode,
            max_fpr=args.max_fpr,
            min_qcov=args.min_query_cov,
            keep_top_qcovs=args.keep_top_qcovs,
            keep_perfect_matches=args.keep_perfect_matches,
            min_chunks_reads=args.min_chunks_reads,
            min_chunks_fraction=args.min_chunks_fraction,
            max_chunks_depth_stdev=args.max_chunks_depth_stdev,
            min_uniq_reads=args.min_uniq_reads,
            min_hic_ureads=args.min_hic_ureads,
            min_hic_ureads_qcov=args.min_hic_ureads_qcov,
            min_hic_ureads_prop=args.min_hic_ureads_prop,
            keep_main_matches=args.keep_main_matches,
            max_qcov_gap=args.max_qcov_gap,
            min_dreads_prop=args.min_dreads_prop,
            max_mismatch_err=args.max_mismatch_err,
            filter_low_pct=args.filter_low_pct,
            level="species" if args.level == "species" else "strain",
            norm_abund=args.norm_abund,
            max_iters=args.abund_max_iters,
            abund_pct_threshold=args.abund_pct_threshold,
            no_amb_corr=args.no_amb_corr,
        )
        run_profile(
            files=args.files,
            out_file=args.out_file,
            opt=opt,
            low_mem=args.low_mem,
            taxid_map_files=args.taxid_map,
            taxdump_dir=args.taxdump,
            name_map_files=args.name_map,
            cami_report=args.cami_report,
            metaphlan_report=args.metaphlan_report,
            metaphlan_version=args.metaphlan_report_version,
            binning_file=args.binning_result,
            sample_id=args.sample_id,
            taxonomy_id=args.taxonomy_id,
            separator=args.separator,
            show_ranks=args.show_rank.split(",") if args.show_rank else None,
            rank_prefixes=(
                args.rank_prefix.split(",") if args.rank_prefix else None
            ),
            debug_file=args.debug,
            verbose=not args.quiet,
        )
        return 0

    if args.command == "version":
        print(f"{PROG} v{__version__}")
        return 0

    if args.command == "utils":
        from .commands import utils_cmds as U

        uc = args.utils_command
        if uc == "cov2simi":
            U.run_cov2simi(args.query_cov, args.files, args.out_file)
        elif uc == "query-fpr":
            U.run_query_fpr(
                args.false_positive_rate, args.matched_kmers, args.num_kmers,
                args.all, args.add_header, args.out_file,
            )
        elif uc == "kset-info":
            U.run_kset_info(args.in_dir, args.out_file)
        elif uc == "index-info":
            U.run_index_info(args.db_dir, args.out_file, args.basename)
        elif uc == "ref-info":
            U.run_ref_info(args.db_dir, args.out_file)
        elif uc == "export-ref-db":
            from .index.uniki import export_ref_layout

            rdir = export_ref_layout(args.db_dir, args.out_dir, args.alias)
            print(f"[export-ref-db] wrote {rdir}", file=sys.stderr)
        elif uc == "index-density":
            U.run_index_density(args.db_dir, args.out_file, args.bins)
        elif uc == "filter":
            U.run_filter(
                args.files, args.out_file, args.max_fpr, args.min_query_cov,
                "species" if args.level == "species" else "strain",
                args.taxid_map, args.taxdump,
            )
        elif uc == "merge-regions":
            U.run_merge_regions(
                args.files, args.out_file, args.max_fpr, args.min_query_cov,
                args.min_overlap, args.max_gap, args.regexp,
                args.name_species, args.name_assembly, args.ignore_type,
            )
        elif uc == "split-genomes":
            U.run_split_genomes(
                args.files, args.out_dir, args.kmer, args.split_number,
                args.split_overlap, args.split_min_ref, args.frag_size,
                args.circular, args.seq_name_filter, args.force,
                args.info_file,
            )
        return 0

    from .merge.merge import run_merge

    run_merge(
        files=args.files,
        out_file=args.out_file,
        keep_top_scores=args.keep_top_scores,
        sort_by=args.sort_by,
        do_not_sort=args.do_not_sort,
        no_header_row=args.no_header_row,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
