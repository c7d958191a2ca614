"""Profile output writers: KMCP 17-column TSV, CAMI, MetaPhlAn v2/v3,
CAMI binning — byte-compatible with KMCP (cmd/profile.go:2882-3048,
2608-2612).  The port's copy of kmcp_tpu/profile/formats.py."""

from __future__ import annotations

from typing import TextIO

from .core import Target
from .taxonomy import Taxonomy

KMCP_HEADER = (
    "ref\tpercentage\tcoverage\tscore\tchunksFrac\tchunksRelDepth\t"
    "chunksRelDepthStd\treads\tureads\thicureads\trefsize\trefname\t"
    "taxid\trank\ttaxname\ttaxpath\ttaxpathsn\n"
)

DEFAULT_SHOW_RANKS = [
    "superkingdom", "phylum", "class", "order", "family", "genus",
    "species", "strain",
]
DEFAULT_RANK_PREFIXES = ["k__", "p__", "c__", "o__", "f__", "g__", "s__", "t__"]


def write_kmcp_profile(
    fh: TextIO, targets: list[Target], separator: str = ";",
    show_ranks: list[str] | None = None, taxdb: Taxonomy | None = None,
) -> None:
    fh.write(KMCP_HEADER)
    ranks = set(show_ranks or DEFAULT_SHOW_RANKS)
    for t in targets:
        covs = ";".join(f"{v:.2f}" for v in t.rel_depth)
        if taxdb is not None and t.complete_lineage_taxids:
            # limit lineage to shown ranks (profile.go AddTaxonomy)
            lt = [
                x for x in t.complete_lineage_taxids
                if taxdb.rank.get(x, "") in ranks
            ]
            names = separator.join(taxdb.names.get(x, "") for x in lt)
            taxids = separator.join(str(x) for x in lt)
        else:
            names = separator.join(t.lineage_names)
            taxids = separator.join(t.lineage_taxids)
        fh.write(
            f"{t.name}\t{t.percentage:.6f}\t{t.coverage:.6f}\t{t.score:.2f}\t"
            f"{t.frags_prop:.2f}\t{covs}\t{t.rel_depth_std:.2f}\t"
            f"{t.sum_match:.0f}\t{t.sum_uniq:.0f}\t{t.sum_uniq_hic:.0f}\t"
            f"{t.genome_size}\t{t.refname}\t{t.taxid}\t{t.rank}\t{t.taxname}\t"
            f"{names}\t{taxids}\n"
        )


class ProfileNode:
    __slots__ = ("taxid", "rank", "name", "lineage_taxids", "percentage")

    def __init__(self, taxid, rank, name, lineage_taxids, percentage):
        self.taxid = taxid
        self.rank = rank
        self.name = name
        self.lineage_taxids = lineage_taxids
        self.percentage = percentage


def generate_profile_nodes(
    taxdb: Taxonomy, targets: list[Target]
) -> list[ProfileNode]:
    """Percentage summed up the lineage (util-profile.go:300-323), sorted by
    rank order then percentage desc (profile.go:2925-2935)."""
    nodes: dict[int, ProfileNode] = {}
    for t in targets:
        for taxid in t.complete_lineage_taxids:
            node = nodes.get(taxid)
            if node is None:
                nodes[taxid] = ProfileNode(
                    taxid,
                    taxdb.rank.get(taxid, ""),
                    taxdb.names.get(taxid, ""),
                    taxdb.lineage_taxids(taxid),
                    t.percentage,
                )
            else:
                node.percentage += t.percentage
    rank_order = {r: i for i, r in enumerate(DEFAULT_SHOW_RANKS)}
    out = list(nodes.values())
    out.sort(key=lambda n: (rank_order.get(n.rank, 0), -n.percentage))
    return out


def write_cami_profile(
    fh: TextIO,
    nodes: list[ProfileNode],
    taxdb: Taxonomy,
    sample_id: str = "",
    taxonomy_id: str = "",
    show_ranks: list[str] | None = None,
) -> None:
    fh.write(f"@SampleID:{sample_id}\n")
    fh.write("@Version:0.10.0\n")
    fh.write("@Ranks:superkingdom|phylum|class|order|family|genus|species|strain\n")
    fh.write(f"@TaxonomyID:{taxonomy_id}\n")
    fh.write("@@TAXID\tRANK\tTAXPATH\tTAXPATHSN\tPERCENTAGE\n")
    ranks = set(show_ranks or DEFAULT_SHOW_RANKS)
    for node in nodes:
        if node.rank not in ranks:
            continue
        lt = [x for x in node.lineage_taxids if taxdb.rank.get(x, "") in ranks]
        taxids = "|".join(str(x) for x in lt)
        names = "|".join(taxdb.names.get(x, "") for x in lt)
        fh.write(
            f"{node.taxid}\t{node.rank}\t{taxids}\t{names}\t"
            f"{node.percentage:.6f}\n"
        )


def write_metaphlan_profile(
    fh: TextIO,
    nodes: list[ProfileNode],
    taxdb: Taxonomy,
    sample_id: str = "",
    version: str = "3",
    show_ranks: list[str] | None = None,
    rank_prefixes: list[str] | None = None,
) -> None:
    fh.write(f"#SampleID\t{sample_id}\n")
    if version == "3":
        fh.write("#clade_name\tNCBI_tax_id\trelative_abundance\tadditional_species\n")
    show = show_ranks or DEFAULT_SHOW_RANKS
    prefixes = rank_prefixes or DEFAULT_RANK_PREFIXES
    ranks = set(show)
    prefix_map = dict(zip(show, prefixes))
    for node in nodes:
        if node.rank not in ranks:
            continue
        names, taxids = [], []
        for x in node.lineage_taxids:
            r = taxdb.rank.get(x, "")
            if r in ranks:
                names.append(prefix_map.get(r, "") + taxdb.names.get(x, ""))
                taxids.append(str(x))
        lineage_names = "|".join(names)
        lineage_taxids = "|".join(taxids)
        if version == "2":
            fh.write(f"{lineage_names}\t{node.percentage:.6f}\n")
        else:
            fh.write(
                f"{lineage_names}\t{lineage_taxids}\t{node.percentage:.6f}\t\n"
            )


def write_binning_header(fh: TextIO, sample_id: str = "") -> None:
    fh.write("# This is the bioboxes.org binning output format at\n")
    fh.write("# https://github.com/bioboxes/rfc/tree/master/data-format\n")
    fh.write("@Version:0.10.0\n")
    fh.write(f"@SampleID:{sample_id}\n")
    fh.write("@@SEQUENCEID\tTAXID\n")
