"""The port's ``profile`` against kmcp_tpu's, byte for byte.

A small world made from a seed: 12 genomes of 20 kb in 8 chunks, four
species of two strains (the second a copy of the first mutated at ~2%)
and four species of one, a taxdump written here (with one merged and one
deleted taxid), ~3,000 reads at uneven abundance plus junk reads,
searched by the port on the CPU (``search --device cpu``).  The same
arguments then go through ``kmcp_tpu.commands.profile.run_profile`` and
its port, across the modes and levels, the fast, reference (``--debug``)
and ``--low-mem`` engines, and the report options.  Every output file is
compared byte for byte; gzip outputs decompressed, since their header
carries the time they were written.
"""

import gzip
import os

import numpy as np
import pytest

from kmcp_tpu.commands.profile import run_profile as jax_run_profile
from kmcp_tpu.profile.core import ProfileOptions as JaxProfileOptions
from kmcp_tpu_torch.commands.compute import ComputeOptions, run_compute
from kmcp_tpu_torch.commands.profile import run_profile
from kmcp_tpu_torch.commands.search import run_search
from kmcp_tpu_torch.index.build import run_index
from kmcp_tpu_torch.profile.core import ProfileOptions
from kmcp_tpu_torch.search.engine import SearchOptions

from .test_torch_stream import random_genomes

N_SPECIES_2 = 4  # species with two strains
N_SPECIES_1 = 4  # species with one strain
GENOME_LEN = 20_000
N_READS = 3_000
N_JUNK = 150
# taxid of g11 in taxid.map: merged into its species' taxid by merged.dmp
MERGED_OLD = 9011
# a taxid listed in delnodes.dmp, mapped to no genome
DELETED = 9999


def mutate(rng, seq: bytes, rate: float) -> bytes:
    a = np.frombuffer(seq, dtype=np.uint8).copy()
    pos = np.flatnonzero(rng.random(len(a)) < rate)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    # a different base at each mutated position
    shift = rng.integers(1, 4, size=len(pos))
    idx = (np.searchsorted(bases, a[pos]) + shift) % 4
    a[pos] = bases[idx]
    return a.tobytes()


def world_genomes(rng):
    """12 genomes: g0..g7 are four species of two strains (g2i, g2i+1),
    g8..g11 four species of one."""
    founders = random_genomes(rng, N_SPECIES_2 + N_SPECIES_1, GENOME_LEN)
    genomes = []
    for s in range(N_SPECIES_2):
        genomes += [founders[s], mutate(rng, founders[s], 0.02)]
    genomes += founders[N_SPECIES_2:]
    return genomes


def species_of(g: int) -> int:
    return g // 2 if g < 2 * N_SPECIES_2 else g - N_SPECIES_2


def write_taxdump(root, n_genomes: int) -> tuple[str, str]:
    """nodes/names/merged/delnodes.dmp and taxid.map: root 1, one lineage
    from superkingdom to family, two genera of four species, a strain
    node under each two-strain species.  Returns (taxdump dir, map)."""
    tax = os.path.join(root, "taxdump")
    os.makedirs(tax, exist_ok=True)
    nodes = [(1, 1, "no rank", "root"), (2, 1, "superkingdom", "Bacteria"),
             (3, 2, "phylum", "Phylum A"), (4, 3, "class", "Class A"),
             (5, 4, "order", "Order A"), (6, 5, "family", "Family A"),
             (10, 6, "genus", "Genus A"), (11, 6, "genus", "Genus B")]
    n_species = N_SPECIES_2 + N_SPECIES_1
    for s in range(n_species):
        nodes.append((100 + s, 10 + s % 2, "species", f"Species {s}"))
    gtax = {}
    for g in range(n_genomes):
        s = species_of(g)
        if g < 2 * N_SPECIES_2:
            nodes.append((1000 + g, 100 + s, "strain", f"Species {s} str{g}"))
            gtax[g] = 1000 + g
        else:
            gtax[g] = 100 + s
    gtax[n_genomes - 1] = MERGED_OLD
    with open(os.path.join(tax, "nodes.dmp"), "w") as f:
        for t, p, r, _ in nodes:
            f.write(f"{t}\t|\t{p}\t|\t{r}\t|\t\t|\n")
    with open(os.path.join(tax, "names.dmp"), "w") as f:
        for t, _, _, n in nodes:
            f.write(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n")
    with open(os.path.join(tax, "merged.dmp"), "w") as f:
        f.write(f"{MERGED_OLD}\t|\t{100 + species_of(n_genomes - 1)}\t|\n")
    with open(os.path.join(tax, "delnodes.dmp"), "w") as f:
        f.write(f"{DELETED}\t|\n")
    tmap = os.path.join(root, "taxid.map")
    with open(tmap, "w") as f:
        for g in range(n_genomes):
            f.write(f"g{g}\t{gtax[g]}\n")
    return tax, tmap


# relative abundance of g0..g11: four genomes (two of them first strains)
# carry enough reads per chunk to pass mode 3's chunk filters, the rest
# fewer, so each stage rejects some
ABUNDANCE = (700, 150, 550, 120, 120, 40, 80, 30, 500, 450, 60, 20)


def write_reads(rng, path, genomes, n_reads=N_READS, n_junk=N_JUNK,
                weights=ABUNDANCE):
    """150 bp reads r<i>.g<genome> (every other one reverse-complemented)
    drawn by ``weights``, then n_junk random reads j<i>."""
    w = np.asarray(weights, dtype=np.float64)
    src = rng.choice(len(genomes), size=n_reads, p=w / w.sum())
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    with open(path, "w") as f:
        for i, g in enumerate(src):
            seq = genomes[g]
            p = int(rng.integers(0, len(seq) - 150))
            s = seq[p : p + 150]
            if i % 2:
                s = s.translate(rc)[::-1]
            f.write(f"@r{i}.g{g}\n{s.decode()}\n+\n{'I' * 150}\n")
        for i, s in enumerate(random_genomes(rng, n_junk, 150)):
            f.write(f"@j{i}\n{s.decode()}\n+\n{'I' * 150}\n")


def build_db(root, genomes, names, name="db"):
    """The port's compute + index of ``genomes`` (8 chunks each, one
    block); returns (k-mer dir, DB dir)."""
    gdir = os.path.join(root, f"{name}.genomes")
    os.makedirs(gdir, exist_ok=True)
    for n, seq in zip(names, genomes):
        with open(os.path.join(gdir, f"{n}.fa"), "w") as f:
            f.write(f">{n} genome\n{seq.decode()}\n")
    ks, db = os.path.join(root, f"{name}.ks"), os.path.join(root, name)
    run_compute(out_dir=ks, in_dir=gdir, opt=ComputeOptions(
        ks=[21], split_number=8, split_overlap=100), verbose=False)
    run_index(in_dir=ks, out_dir=db, num_hashes=1, fpr=0.3,
              tpu_native=True, verbose=False)
    return ks, db


def search(db, reads, out, **kw):
    run_search(db_dir=db, files=[reads], out_file=out,
               opt=SearchOptions(**kw), device="cpu", verbose=False)
    return out


def build_world(root, seed=7):
    """Genomes, taxdump, reads, the DB and the port's search TSV of the
    reads; returns a dict of their paths (and the genomes)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    genomes = world_genomes(rng)
    names = [f"g{g}" for g in range(len(genomes))]
    tax, tmap = write_taxdump(root, len(genomes))
    reads = os.path.join(root, "reads.fq")
    write_reads(rng, reads, genomes)
    ks, db = build_db(root, genomes, names)
    tsv = search(db, reads, os.path.join(root, "reads.tsv.gz"))
    return {"genomes": genomes, "names": names, "taxdump": tax,
            "taxid_map": tmap, "reads": reads, "ks": ks, "db": db,
            "tsv": tsv, "root": root}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return build_world(str(tmp_path_factory.mktemp("profile_world")))


def read_out(path) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def out_files(d) -> dict:
    """{path relative to d: bytes} of every file under d."""
    out = {}
    for dirpath, _dirs, names in os.walk(d):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, d)] = read_out(p)
    return out


def profile_both(tmp, files, opt_kw=None, **kw):
    """run_profile of both packages with the same arguments, each writing
    under its own directory; returns ({name: bytes} of kmcp_tpu, of the
    port, the port's returned targets).  Output names in ``kw`` are file
    names, placed in each package's directory."""
    res = []
    for pkg, fn, opts in (("jax", jax_run_profile, JaxProfileOptions),
                          ("port", run_profile, ProfileOptions)):
        d = os.path.join(tmp, pkg)
        os.makedirs(d, exist_ok=True)
        args = dict(kw)
        for key in ("out_file", "cami_report", "metaphlan_report",
                    "binning_file", "debug_file"):
            if args.get(key):
                args[key] = os.path.join(d, args[key])
        targets = fn(files=files, opt=opts(**(opt_kw or {})),
                     verbose=False, **args)
        res.append((out_files(d), targets))
    (jo, _), (po, pt) = res
    return jo, po, pt


def assert_same(jo, po):
    assert sorted(jo) == sorted(po)
    for n in jo:
        assert jo[n] == po[n], n
    assert jo, "no output written"


def tax_kw(world):
    return {"taxid_map_files": [world["taxid_map"]],
            "taxdump_dir": world["taxdump"]}


@pytest.mark.parametrize("mode", range(6))
def test_profile_modes_species(world, tmp_path, mode):
    jo, po, pt = profile_both(
        str(tmp_path), [world["tsv"]], {"mode": mode},
        out_file="p.profile", cami_report="c", metaphlan_report="m",
        binning_file="b", **tax_kw(world))
    assert_same(jo, po)
    if mode == 3:
        # the world is profiled: three of its four heaviest genomes pass
        # mode 3's chunk filters at the species level
        assert {0, 8, 9} <= {int(t.name[1:]) for t in pt}


def cli_both(tmp, args) -> tuple[dict, dict]:
    """Each package's command line with ``args``; "{d}" in an argument
    stands for the package's own output directory.  Returns the output
    files of kmcp_tpu and of the port as {name: bytes}."""
    from kmcp_tpu.cli import main as jax_main
    from kmcp_tpu_torch.cli import main as port_main

    outs = []
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        d = os.path.join(tmp, pkg)
        os.makedirs(d, exist_ok=True)
        assert main([a.replace("{d}", d) for a in args]) == 0
        outs.append(out_files(d))
    return outs[0], outs[1]


@pytest.mark.parametrize("level", ["strain", "assembly"])
def test_profile_levels_mode3(world, tmp_path, level):
    """--level strain and assembly at mode 3, through each command line."""
    jo, po = cli_both(str(tmp_path), [
        "-q", "profile", "-m", "3", "--level", level, "-T",
        world["taxid_map"], "-X", world["taxdump"], world["tsv"],
        "-o", "{d}/p.profile", "-C", "{d}/c", "-M", "{d}/m",
        "-B", "{d}/b.binning"])
    assert_same(jo, po)
    assert po["p.profile"].count(b"\n") > 2


@pytest.mark.parametrize("engine", ["reference", "debug"])
def test_profile_reference_engine(world, tmp_path, monkeypatch, engine):
    """KMCP_TPU_PROFILE_ENGINE=reference, and --debug (its trace too)."""
    if engine == "reference":
        monkeypatch.setenv("KMCP_TPU_PROFILE_ENGINE", "reference")
    debug = {"debug_file": "debug.tsv"} if engine == "debug" else {}
    jo, po, _ = profile_both(
        str(tmp_path), [world["tsv"]], {"mode": 3}, out_file="p.profile",
        cami_report="c",
        binning_file="b", **debug, **tax_kw(world))
    assert_same(jo, po)
    if debug:
        assert po["debug.tsv"]


@pytest.mark.parametrize("chunk", [1 << 12, 1 << 20])
def test_profile_low_mem(world, tmp_path, monkeypatch, chunk):
    """--low-mem with small KMCP_TPU_PARSE_CHUNK: both packages, and the
    port's in-memory engine, write the same profile."""
    monkeypatch.setenv("KMCP_TPU_PARSE_CHUNK", str(chunk))
    jo, po, _ = profile_both(
        str(tmp_path), [world["tsv"]], {"mode": 3}, low_mem=True,
        out_file="p.profile",
        cami_report="c", metaphlan_report="m", **tax_kw(world))
    assert_same(jo, po)
    mem = os.path.join(str(tmp_path), "mem.profile")
    run_profile(files=[world["tsv"]], out_file=mem, opt=ProfileOptions(),
                verbose=False, **tax_kw(world))
    assert read_out(mem) == po["p.profile"]


OPTION_CASES = {
    "name_map": dict(name_map=True),
    "show_rank": dict(show_ranks=["genus", "species", "strain"]),
    "rank_prefix_v2": dict(metaphlan_version="2",
                           rank_prefixes=["k__", "p__", "c__", "o__", "f__",
                                          "g__", "s__", "t__"]),
    "metaphlan_v3": dict(metaphlan_version="3", sample_id="S1",
                         taxonomy_id="tax1"),
    "separator": dict(separator="|"),
    "top_qcovs": dict(opt={"keep_top_qcovs": 1, "keep_perfect_matches": True}),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_profile_report_options(world, tmp_path, case):
    kw = dict(OPTION_CASES[case])
    opt = kw.pop("opt", {"mode": 3})
    if kw.pop("name_map", False):
        nm = os.path.join(str(tmp_path), "names.tsv")
        with open(nm, "w") as f:
            for n in world["names"]:
                f.write(f"{n}\tgenome {n}\n")
        kw["name_map_files"] = [nm]
    jo, po, _ = profile_both(
        str(tmp_path), [world["tsv"]], opt, out_file="p.profile",
        cami_report="c", metaphlan_report="m", binning_file="b.binning.gz",
        **kw, **tax_kw(world))
    assert_same(jo, po)


def test_profile_two_files_no_taxonomy(world, tmp_path):
    """Two search files at --level strain without -T/-X (mode 1), to a
    gzip profile."""
    half = os.path.join(str(tmp_path), "again.tsv")
    with open(half, "wb") as f:
        f.write(read_out(world["tsv"]))
    jo, po, _ = profile_both(
        str(tmp_path), [world["tsv"], half], {"mode": 1, "level": "strain"},
        out_file="p.profile.gz")
    assert_same(jo, po)


def test_profile_species_without_taxonomy_exits(world):
    for fn, opts, prog in ((jax_run_profile, JaxProfileOptions, "kmcp-tpu"),
                           (run_profile, ProfileOptions, "kmcp-tpu-torch")):
        with pytest.raises(SystemExit) as e:
            fn(files=[world["tsv"]], opt=opts(), verbose=False)
        assert str(e.value) == (
            f"{prog} profile: -T/--taxid-map and -X/--taxdump are needed "
            "for --level species")


def test_profile_wide_group_spanning_parse_blocks(tmp_path, monkeypatch):
    """tests/test_profile_e2e.py:520's TSV (one query of 400 rows spans
    many 8 KB parse blocks), between 1,000 single-hit reads on each side
    so that the profile is not empty and a group split across parse
    blocks or spill chunks (counted twice) changes its numbers: the fast
    and --low-mem engines of both packages must agree."""
    tsv = tmp_path / "wide.tsv"
    rows = ([(f"u{i}", 1) for i in range(1000)]
            + [("q0", 3), ("q1", 400), ("q2", 3)]
            + [(f"v{i}", 1) for i in range(1000)])
    with open(tsv, "w") as f:
        f.write("#query\tqLen\tqKmers\tFPR\thits\ttarget\tchunkIdx\t"
                "chunks\ttLen\tkSize\tmKmers\tqCov\ttCov\tjacc\tqueryIdx\n")
        for qi, (qid, n) in enumerate(rows):
            for j in range(n):
                t, c = (j % 37, j % 10) if n > 1 else (qi % 5, qi // 5 % 10)
                f.write(
                    f"{qid}\t150\t130\t1.0e-10\t{n}\tT{t:03d}\t"
                    f"{c}\t10\t1000000\t21\t100\t0.9000\t"
                    f"0.0010\t0.0010\t{qi}\n"
                )
        f.write(f"# input queries: {len(rows)}\n"
                f"# matched queries: {len(rows)}\n")
    monkeypatch.setenv("KMCP_TPU_PARSE_CHUNK", str(8 << 10))
    outs = []
    for low_mem in (False, True):
        jo, po, _ = profile_both(
            str(tmp_path / f"lm{int(low_mem)}"), [str(tsv)],
            {"mode": 1, "level": "strain"}, low_mem=low_mem,
            out_file="p.profile")
        assert_same(jo, po)
        outs.append(po["p.profile"])
    assert outs[0] == outs[1]
    assert outs[0].count(b"\n") == 6  # T000-T004
