"""The port's ``utils`` subcommands against kmcp_tpu's, byte for byte.

On test_torch_profile.py's world (its k-mer files, its DB, the same DB
exported to KMCP's ``.kmcp`` layout, its search TSV and a TSV of sliding
windows of three genomes), every subcommand runs through both command
lines with the same arguments, and every file each writes is compared
(gzip outputs decompressed).  ``index-density`` writes a PGM and its
``.tsv`` always, and a JPEG when Pillow is importable.
"""

import os

import pytest

from .test_torch_profile import build_world, cli_both, search

# windows of these genomes, 150 bp every 40 bp, named <genome>_sliding:b-e
WINDOW_GENOMES = (0, 2, 8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("utils_world"))
    w = build_world(root)
    win = os.path.join(root, "windows.fa")
    with open(win, "w") as f:
        for g in WINDOW_GENOMES:
            seq = w["genomes"][g]
            for b in range(0, len(seq) - 150, 40):
                f.write(f">g{g}_sliding:{b + 1}-{b + 150}\n"
                        f"{seq[b:b + 150].decode()}\n")
    w["windows"] = search(w["db"], win, os.path.join(root, "windows.tsv"))
    qc = os.path.join(root, "qcovs.txt")
    with open(qc, "w") as f:
        f.write("0.55\n0.8\n\n1\n0.3333\n")
    w["qcovs"] = qc
    ref = os.path.join(root, "ref_layout")
    from kmcp_tpu_torch.cli import main

    assert main(["-q", "utils", "export-ref-db", w["db"], "-O", ref]) == 0
    w["ref_db"] = ref
    gdir = os.path.join(root, "db.genomes")
    w["genome_files"] = [os.path.join(gdir, f"g{g}.fa") for g in (1, 0, 9)]
    return w


def tax(w):
    return ["-T", w["taxid_map"], "-X", w["taxdump"]]


CASES = {
    "cov2simi_t": lambda w: ["cov2simi", "-t", "0.8", "-o", "{d}/o.tsv"],
    "cov2simi_files": lambda w: ["cov2simi", w["qcovs"], "-o", "{d}/o.tsv"],
    "query_fpr": lambda w: ["query-fpr", "-o", "{d}/o.tsv"],
    "query_fpr_all": lambda w: ["query-fpr", "-a", "-H", "-f", "0.1", "-m",
                                "30", "-n", "60", "-o", "{d}/o.tsv"],
    "kset_info": lambda w: ["kset-info", "-I", w["ks"], "-o", "{d}/o.tsv"],
    "index_info": lambda w: ["index-info", w["db"], "-o", "{d}/o.tsv"],
    "index_info_basename": lambda w: ["index-info", "-b", w["db"], "-o",
                                      "{d}/o.tsv.gz"],
    "index_info_ref_layout": lambda w: ["index-info", w["ref_db"], "-o",
                                        "{d}/o.tsv"],
    "index_info_uniki": lambda w: [
        "index-info", os.path.join(w["ref_db"], "R001", "_block001.uniki"),
        "-o", "{d}/o.tsv"],
    "ref_info": lambda w: ["ref-info", w["db"], "-o", "{d}/o.tsv"],
    "ref_info_ref_layout": lambda w: ["ref-info", w["ref_db"], "-o",
                                      "{d}/o.tsv"],
    "export_ref_db": lambda w: ["export-ref-db", w["db"], "-O", "{d}/ref",
                                "-a", "world"],
    "index_density": lambda w: ["index-density", w["db"], "-o",
                                "{d}/dens.jpg", "--bins", "64"],
    "index_density_ref_layout": lambda w: ["index-density", w["ref_db"],
                                           "-o", "{d}/dens.pgm"],
    "filter_species": lambda w: ["filter", w["tsv"], *tax(w), "-o",
                                 "{d}/o.tsv"],
    "filter_strain": lambda w: ["filter", w["tsv"], "--level", "strain",
                                "-f", "0.01", "-t", "0.8", "-o", "{d}/o.tsv"],
    "merge_regions": lambda w: ["merge-regions", w["windows"], "-o",
                                "{d}/o.bed"],
    "merge_regions_options": lambda w: [
        "merge-regions", w["windows"], "-l", "20", "-g", "100", "-I",
        "--name-species", "sp", "--name-assembly", "asm", "-o",
        "{d}/o.bed"],
    "split_genomes": lambda w: [
        "split-genomes", *w["genome_files"], "-O", "{d}/chunks", "-k", "21",
        "-n", "4", "-f", "200", "--info-file", "{d}/info.tsv"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_utils_subcommand_matches_kmcp_tpu(world, tmp_path, case):
    jo, po = cli_both(str(tmp_path), ["-q", "utils", *CASES[case](world)])
    assert sorted(jo) == sorted(po)
    for name in jo:
        assert jo[name] == po[name], name
    assert any(po.values()), "no output written"
    if case.startswith("index_density"):
        assert {"dens.pgm", "dens.pgm.tsv"} <= set(po)
        try:
            import PIL  # noqa: F401
        except ImportError:
            pass
        else:
            assert ("dens.jpg" in po) == case.endswith("density")


def test_version_and_autocompletion(tmp_path, capsys):
    from kmcp_tpu_torch.cli import main

    assert main(["version"]) == 0
    assert capsys.readouterr().out == "kmcp-tpu-torch v0.1.0\n"
    for shell in ("bash", "zsh", "fish"):
        out = tmp_path / f"c.{shell}"
        assert main(["autocompletion", "--shell", shell, "-o",
                     str(out)]) == 0
        text = out.read_text()
        assert "kmcp-tpu-torch" in text and "split-genomes" in text
        assert "metaphlan-report" in text
