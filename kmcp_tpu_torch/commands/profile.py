"""``profile`` command: search TSV(s) -> taxonomic profiles.

The port's copy of kmcp_tpu/commands/profile.py.  The fast engine and
``--low-mem`` parse through the native columnar parser
(csrc/host/parser.cpp), which is built or raises; the reference engine
(``--debug``, ``KMCP_TPU_PROFILE_ENGINE=reference``) keeps its own Python
parser, as in kmcp_tpu.
"""

from __future__ import annotations

import os
import sys

from ..profile.core import Profiler, ProfileOptions, parse_search_tsv
from ..profile.formats import (
    generate_profile_nodes,
    write_binning_header,
    write_cami_profile,
    write_kmcp_profile,
    write_metaphlan_profile,
)
from ..profile.taxonomy import Taxonomy, load_taxid_map
from ..seqio.fastx import xopen


def _read_kv(files: list[str]) -> dict[str, str]:
    out: dict[str, str] = {}
    for path in files:
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    out[parts[0]] = parts[1]
    return out


def run_profile(
    files: list[str],
    out_file: str = "-",
    opt: ProfileOptions | None = None,
    taxid_map_files: list[str] | None = None,
    taxdump_dir: str | None = None,
    name_map_files: list[str] | None = None,
    cami_report: str | None = None,
    metaphlan_report: str | None = None,
    metaphlan_version: str = "3",
    binning_file: str | None = None,
    sample_id: str = "",
    taxonomy_id: str = "",
    separator: str = ";",
    show_ranks: list[str] | None = None,
    rank_prefixes: list[str] | None = None,
    debug_file: str | None = None,
    verbose: bool = True,
    low_mem: bool = False,
):
    opt = opt or ProfileOptions()
    if name_map_files:
        opt.name_map = _read_kv(name_map_files)

    taxdb = None
    taxid_map = None
    if taxid_map_files and taxdump_dir:
        taxid_map = load_taxid_map(taxid_map_files)
        taxdb = Taxonomy(taxdump_dir)
    elif opt.level == "species":
        raise SystemExit(
            "kmcp-tpu-torch profile: -T/--taxid-map and -X/--taxdump are needed "
            "for --level species"
        )

    from ..profile.fast import FastProfiler, flat_from_files

    # --debug needs the reference-faithful per-target loop (the trace is
    # emitted inline from its filter stages, profile.go:206-223)
    use_fast = (
        FastProfiler.usable(opt)
        and not debug_file
        and os.environ.get("KMCP_TPU_PROFILE_ENGINE", "fast") != "reference"
    )

    if verbose:
        # the reference's "[main parameters]" block (profile.go:393-423);
        # preset-resolved values, mirroring its post-override dump
        from ..profile.core import resolve_params

        p = resolve_params(opt)
        print(
            "[profile] main parameters:\n"
            f"  mode: {opt.mode}, engine: "
            f"{'fast' if use_fast else 'reference'}, level: {opt.level}\n"
            f"  max-fpr: {opt.max_fpr}, min-qcov: {opt.min_qcov}\n"
            f"  min-chunks-reads: {p['min_reads']}, "
            f"min-uniq-reads: {p['min_ureads']}, "
            f"min-chunks-fraction: {p['min_frags_prop']}, "
            f"max-chunks-depth-stdev: {p['max_depth_stdev']}",
            file=sys.stderr,
        )

    if verbose:
        print(f"[profile] parsing {len(files)} search result file(s)",
              file=sys.stderr)
    parsed = None
    flat = None
    store = None
    if low_mem:
        # bounded-memory chunked engine (profile/spill.py — the
        # reference re-streams its TSV per stage for the same reason,
        # profile.go:68); identical output to the in-memory engine
        if binning_file:
            raise SystemExit(
                "kmcp-tpu-torch profile: --low-mem does not support "
                "-B/--binning-result (per-read binning needs the query "
                "ids in memory); drop --low-mem for binning runs"
            )
        if not use_fast:
            raise SystemExit(
                "kmcp-tpu-torch profile: --low-mem requires the fast engine "
                "(no --debug, KMCP_TPU_PROFILE_ENGINE != reference)"
            )
        import tempfile

        from ..profile.spill import spill_from_files

        spill_dir = tempfile.mkdtemp(prefix="kmcp_profile_spill_")
        try:
            store = spill_from_files(
                files, opt.max_fpr, opt.min_qcov, spill_dir,
                chunk_bytes=int(
                    os.environ.get("KMCP_TPU_PARSE_CHUNK", str(256 << 20))
                ),
            )
        except BaseException:
            # a parse failure must not leak partially-written chunks
            import shutil

            shutil.rmtree(spill_dir, ignore_errors=True)
            raise
    elif use_fast:
        # columnar native parse, no per-row Python objects; query-id
        # offsets are retained when binning needs them
        flat = flat_from_files(
            files, opt.max_fpr, opt.min_qcov,
            keep_queries=bool(binning_file),
            chunk_bytes=int(
                os.environ.get("KMCP_TPU_PARSE_CHUNK", str(512 << 20))
            ),
        )
    else:
        parsed = parse_search_tsv(files, opt.max_fpr, opt.min_qcov)
    if verbose:
        src = store if store is not None else flat
        ng = src.n_groups if src is not None else len(parsed.groups)
        nt = (
            src.n_targets if src is not None
            else len(parsed.target_names)
        )
        print(
            f"[profile] {ng} matched queries, {nt} targets seen",
            file=sys.stderr,
        )

    debug_out = None
    if use_fast:
        prof = FastProfiler(opt, taxdb=taxdb, taxid_map=taxid_map)
    else:
        if debug_file:
            debug_out = xopen(debug_file, "wt")
        prof = Profiler(
            opt, taxdb=taxdb, taxid_map=taxid_map, debug_out=debug_out
        )
    try:
        if store is not None:
            from ..profile.spill import run_spilled

            try:
                targets = run_spilled(prof, store)
            finally:
                store.cleanup()
        else:
            targets = prof.run(flat if flat is not None else parsed)
    finally:
        if debug_out is not None:
            debug_out.close()
    if verbose:
        print(f"[profile] {len(targets)} references in the profile",
              file=sys.stderr)

    out = sys.stdout if out_file == "-" else xopen(out_file, "wt")
    try:
        write_kmcp_profile(
            out, targets, separator=separator, taxdb=taxdb,
            show_ranks=show_ranks,
        )
    finally:
        if out is not sys.stdout:
            out.close()

    if (cami_report or metaphlan_report) and taxdb is not None:
        nodes = generate_profile_nodes(taxdb, targets)
        if cami_report:
            if not cami_report.endswith(".profile"):
                cami_report += ".profile"
            with xopen(cami_report, "wt") as f:
                write_cami_profile(
                    f, nodes, taxdb, sample_id=sample_id,
                    taxonomy_id=taxonomy_id, show_ranks=show_ranks,
                )
        if metaphlan_report:
            if not metaphlan_report.endswith(".profile"):
                metaphlan_report += ".profile"
            with xopen(metaphlan_report, "wt") as f:
                write_metaphlan_profile(
                    f, nodes, taxdb, sample_id=sample_id,
                    version=metaphlan_version, show_ranks=show_ranks,
                    rank_prefixes=rank_prefixes,
                )

    if binning_file and taxdb is not None:
        if not (binning_file.endswith(".binning")
                or binning_file.endswith(".binning.gz")):
            binning_file += ".binning.gz"
        with xopen(binning_file, "wt") as f:
            write_binning_header(f, sample_id)
            for query, taxid in prof.binning(
                flat if flat is not None else parsed, targets
            ):
                f.write(f"{query}\t{taxid}\n")

    return targets
