"""The port's own host layer against kmcp_tpu's, and its import boundary.

- No module of kmcp_tpu_torch and no line of chip_smoke.py imports jax or
  anything of kmcp_tpu (a static parse of every file).
- ``python -m kmcp_tpu_torch compute``, ``index``, ``search --device
  cpu``, ``merge``, ``profile`` and ``utils query-fpr`` run end to end
  with no jax and no kmcp_tpu module loaded.
- The port's parser has every subcommand, ``utils`` subcommand and
  option of kmcp_tpu's, with the same defaults.
- The port's ``compute`` + ``index`` write DB directories byte-identical
  to kmcp_tpu's on the same seeded genomes (one block, screened blocks,
  the reference partition with three hashes, a scaled minimizer sketch).
  A ``.union.npz`` is a zip whose headers carry the time it was written,
  so its members are compared byte for byte instead.
- On such a DB the port's packed union table, stacked blocks and tmin /
  cmin tables equal kmcp_tpu's, and its numpy object engine gives
  kmcp_tpu's results for reads over the k-mer dedup threshold.
"""

import argparse
import ast
import dataclasses
import glob
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from kmcp_tpu.commands.compute import ComputeOptions as JaxComputeOptions
from kmcp_tpu.commands.compute import run_compute as jax_run_compute
from kmcp_tpu.index.build import run_index as jax_run_index
from kmcp_tpu.search import device as jax_device
from kmcp_tpu.search import device_screened as jax_screened
from kmcp_tpu.search.engine import SearchEngine as JaxEngine
from kmcp_tpu.search.engine import SearchOptions as JaxOptions
from kmcp_tpu_torch.commands.compute import ComputeOptions, run_compute
from kmcp_tpu_torch.index.build import run_index
from kmcp_tpu_torch.search import device as port_device
from kmcp_tpu_torch.search import engine as port_engine

from .test_torch_profile import write_taxdump
from .test_torch_stream import mixed_reads, random_genomes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "kmcp_tpu_torch", "**", "*.py"),
                       recursive=True)
) + ["chip_smoke.py"]


def _banned(name: str) -> bool:
    root = name.split(".", 1)[0]
    return root in ("jax", "jaxlib", "kmcp_tpu")


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_no_jax_and_nothing_of_kmcp_tpu(rel):
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _banned(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module")
              and _banned(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{rel} imports {bad}"


def write_genomes(gdir, genomes):
    os.makedirs(gdir, exist_ok=True)
    for g, seq in enumerate(genomes):
        with open(os.path.join(gdir, f"g{g}.fa"), "w") as f:
            f.write(f">g{g} genome {g}\n{seq.decode()}\n")
    return str(gdir)


def test_command_line_loads_no_jax_and_nothing_of_kmcp_tpu(tmp_path):
    """compute -> index (one block, and screened blocks) -> search --device
    cpu, of single reads and of read pairs (-1/-2), then merge -> profile
    -T -X of the TSVs and utils query-fpr, through ``python -m
    kmcp_tpu_torch``, each in a process that fails if a jax or kmcp_tpu
    module is in sys.modules at exit."""
    rng = np.random.default_rng(4)
    genomes = random_genomes(rng, 3, 20000)
    gdir = write_genomes(tmp_path / "genomes", genomes)
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for rid, seq, _ in mixed_reads(rng, genomes, 60):
            f.write(f"@{rid}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
    hook = (
        "import atexit, os, runpy, sys\n"
        "def check():\n"
        "    bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "           ('jax', 'jaxlib', 'kmcp_tpu')]\n"
        "    if bad:\n"
        "        print('loaded', bad[:5], file=sys.stderr)\n"
        "        os._exit(3)\n"
        "atexit.register(check)\n"
        "sys.argv = ['kmcp_tpu_torch'] + sys.argv[1:]\n"
        "runpy.run_module('kmcp_tpu_torch', run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)

    def run(*args):
        res = subprocess.run(
            [sys.executable, "-c", hook, "-q", *map(str, args)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
        )
        assert res.returncode == 0, res.stderr

    ks = tmp_path / "ks"
    run("compute", "-I", gdir, "-O", ks, "-k", "21", "-n", "4", "-l", "100")
    one, screened = tmp_path / "one", tmp_path / "screened"
    run("index", "-I", ks, "-O", one, "-f", "0.3", "--tpu-native")
    run("index", "-I", ks, "-O", screened, "-f", "0.3", "--tpu-native",
        "--native-block-targets", "4", "--block-screen", "--uniform-sigs")
    r1, r2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for i in range(40):
            g = genomes[i % len(genomes)]
            p = int(rng.integers(0, len(g) - 400))
            s2 = g[p + 200 : p + 350].translate(rc)[::-1].decode()
            f1.write(f"@p{i}/1\n{g[p : p + 150].decode()}\n+\n{'I' * 150}\n")
            f2.write(f"@p{i}/2\n{s2}\n+\n{'I' * 150}\n")
    for db in (one, screened):
        out = tmp_path / f"{db.name}.tsv"
        run("search", "--device", "cpu", "-d", db, fq, "-o", out)
        text = out.read_text()
        assert text.startswith("#query") and text.count("\n") > 40
        # paired reads: -1/-2
        out = tmp_path / f"{db.name}.paired.tsv"
        run("search", "--device", "cpu", "-d", db, "-1", r1, "-2", r2,
            "-o", out)
        rows = [ln.split("\t") for ln in out.read_text().splitlines()
                if not ln.startswith("#")]
        assert len({r[0] for r in rows}) == 40
        assert all(r[1] == "300" for r in rows)  # qLen = len1 + len2
    # the host commands on those TSVs: merge -> profile, and a utils
    tax, tmap = write_taxdump(str(tmp_path), len(genomes))
    merged, prof = tmp_path / "merged.tsv", tmp_path / "p.profile"
    run("merge", tmp_path / "one.tsv", tmp_path / "screened.tsv",
        "-o", merged)
    run("profile", "-T", tmap, "-X", tax, "-m", "0", merged, "-o", prof,
        "-C", tmp_path / "cami", "-B", tmp_path / "b.binning")
    assert prof.read_text().startswith("ref\tpercentage")
    assert (tmp_path / "cami.profile").read_text().startswith("@SampleID")
    run("utils", "query-fpr", "-a", "-o", tmp_path / "fpr.tsv")
    assert (tmp_path / "fpr.tsv").read_text().count("\t") == 4


def _subparsers(parser) -> dict:
    for act in parser._actions:
        if isinstance(act, argparse._SubParsersAction):
            return dict(act.choices)
    return {}


def _options(parser) -> dict:
    """{option strings (or a positional's dest): (default, choices,
    nargs)} of a parser's own actions, help and subcommands left out."""
    out = {}
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction, argparse._SubParsersAction)):
            continue
        key = tuple(a.option_strings) or a.dest
        choices = sorted(a.choices) if a.choices is not None else None
        out[key] = (a.default, choices, a.nargs)
    return out


def test_parser_has_every_kmcp_tpu_subcommand_and_option():
    """Every subcommand and ``utils`` subcommand of kmcp_tpu's parser is
    the port's, with the same option strings, defaults and choices; only
    ``search --device`` (the port's torch device) is the port's own."""
    from kmcp_tpu.cli import build_parser as jax_build_parser
    from kmcp_tpu_torch.cli import build_parser

    jax_p, port_p = jax_build_parser(), build_parser()
    assert _options(port_p) == _options(jax_p)
    jax_sub, port_sub = _subparsers(jax_p), _subparsers(port_p)
    assert sorted(port_sub) == sorted(jax_sub)
    for name, jp in jax_sub.items():
        got = _options(port_sub[name])
        if name == "search":
            assert got.pop(("--device",))[0] == "cuda"
        assert got == _options(jp), name
        if name == "utils":
            ju, pu = _subparsers(jp), _subparsers(port_sub[name])
            assert sorted(pu) == sorted(ju) and len(pu) == 10
            for un, jup in ju.items():
                assert _options(pu[un]) == _options(jup), un


def dir_contents(root) -> dict:
    """{relative path: bytes} of every file under root; a .npz maps to
    {member name: bytes} (its zip headers carry the write time)."""
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            rel = os.path.relpath(p, root)
            if n.endswith(".npz"):
                with zipfile.ZipFile(p) as z:
                    out[rel] = {m: z.read(m) for m in sorted(z.namelist())}
            else:
                with open(p, "rb") as f:
                    out[rel] = f.read()
    return out


# (compute options, index options) of each DB kind
DB_KINDS = {
    "one_block": ({"split_number": 3, "split_overlap": 100},
                  {"tpu_native": True}),
    "screened": ({"split_number": 4, "split_overlap": 100},
                 {"tpu_native": True, "native_block_targets": 4,
                  "block_screen": True, "uniform_sigs": True}),
    "reference_blocks_3hash": ({"split_number": 3, "split_overlap": 100},
                               {"num_hashes": 3, "block_size": 2}),
    "scaled_minimizer": ({"scale": 2, "minimizer_w": 5},
                         {"tpu_native": True}),
}


def build_both(tmp_path, kind, genomes):
    """The same genomes through kmcp_tpu's and the port's compute + index:
    {"jax": db dir, "port": db dir}."""
    compute_kw, index_kw = DB_KINDS[kind]
    gdir = write_genomes(tmp_path / "genomes", genomes)
    dbs = {}
    for side, compute, options, index in (
        ("jax", jax_run_compute, JaxComputeOptions, jax_run_index),
        ("port", run_compute, ComputeOptions, run_index),
    ):
        ks, db = tmp_path / side / "ks", tmp_path / side / "db"
        compute(out_dir=str(ks), in_dir=gdir,
                opt=options(ks=[21], threads=2, **compute_kw), force=True,
                verbose=False)
        index(in_dir=str(ks), out_dir=str(db), fpr=0.3, threads=2,
              force=True, verbose=False, **index_kw)
        dbs[side] = str(db)
    return dbs


@pytest.mark.parametrize("kind", sorted(DB_KINDS))
def test_compute_index_byte_identical_to_kmcp_tpu(tmp_path, kind):
    rng = np.random.default_rng(31)
    genomes = random_genomes(rng, 5, 24000)
    dbs = build_both(tmp_path, kind, genomes)
    for sub in ("ks", "db"):
        want = dir_contents(tmp_path / "jax" / sub)
        got = dir_contents(tmp_path / "port" / sub)
        assert sorted(got) == sorted(want)
        for rel in want:
            assert got[rel] == want[rel], f"{sub}/{rel} differs"
    n_blocks = len(glob.glob(os.path.join(dbs["port"], "*.bits.npy")))
    # 5 genomes x 3 or 4 chunks: blocks of 2 or 4 targets
    assert n_blocks == {"screened": 5, "reference_blocks_3hash": 8}.get(kind, 1)
    n_unions = len(glob.glob(os.path.join(dbs["port"], "*.union.npz")))
    assert n_unions == (5 if kind == "screened" else 0)


def test_screened_host_tables_equal_kmcp_tpu(tmp_path):
    """On a screened DB: two_pass_ready, the packed union table, the
    stacked blocks and the tmin / cmin tables of the port equal
    kmcp_tpu's."""
    rng = np.random.default_rng(32)
    dbs = build_both(tmp_path, "screened", random_genomes(rng, 4, 30000))
    jdb = JaxEngine([dbs["jax"]], JaxOptions()).dbs[0]
    pdb = port_engine.SearchEngine([dbs["port"]],
                                   port_engine.SearchOptions()).dbs[0]
    nb = len(pdb.blocks)
    assert nb == 4 and port_device.two_pass_ready(pdb)
    assert jax_screened.two_pass_ready(jdb)
    want_u, got_u = (jax_screened.build_packed_union(jdb, nb),
                     port_device.build_packed_union(pdb, nb))
    np.testing.assert_array_equal(got_u[0], want_u[0])
    assert got_u[1] == want_u[1] and got_u[0].any()
    np.testing.assert_array_equal(got_u[2], want_u[2])
    for got, want in zip(port_device._stack_blocks(pdb),
                         jax_device._stack_blocks(jdb)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    sizes = np.asarray(pdb.blocks[0].meta.sizes, dtype=np.float64)
    for tcov in (0.0, 0.013, 0.5):
        np.testing.assert_array_equal(
            port_device.build_tmin_table(sizes, tcov),
            jax_device.build_tmin_table(sizes, tcov))
    for args in ((10, 0.55, 0.01), (3, 0.8, 0.05), (30, 0.3, 1.0)):
        np.testing.assert_array_equal(
            port_device.build_cmin_table(300, *args, pdb.query_fpr),
            jax_device.build_cmin_table(300, *args, jdb.query_fpr))
    assert not port_device.two_pass_ready(
        port_engine.SearchEngine(
            [build_both(tmp_path / "one", "one_block",
                        random_genomes(rng, 2, 20000))["port"]],
            port_engine.SearchOptions()).dbs[0])


def results(res) -> list:
    return [(r.query_idx, r.query_id, r.query_len, r.num_kmers, r.k,
             [dataclasses.astuple(m) for m in r.matches]) for r in res]


@pytest.mark.parametrize("kind,chunked", [
    ("one_block", False), ("one_block", True), ("screened", False),
    ("reference_blocks_3hash", True),
])
def test_object_engine_slow_rows_equal_kmcp_tpu(tmp_path, monkeypatch, kind,
                                                chunked):
    """Reads over the k-mer dedup threshold (the rows the streamer hands
    the object engine), short reads and junk: the port's numpy engine gives
    kmcp_tpu's numpy-backend results; ``chunked`` counts one read at a
    time."""
    rng = np.random.default_rng(33)
    genomes = random_genomes(rng, 4, 24000)
    dbs = build_both(tmp_path, kind, genomes)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    queries = []
    for i in range(40):
        g = genomes[i % len(genomes)]
        ln = (300, 600, 1500, 20)[i % 4]
        p = int(rng.integers(0, len(g) - ln))
        queries.append((f"q{i}", g[p : p + ln], None))
    queries.append(("junk", rng.choice(bases, size=800).tobytes(), None))
    if chunked:
        monkeypatch.setattr(port_engine, "COUNT_CHUNK_BYTES", 1)
    for kw in ({}, {"keep_top_scores": 1, "min_target_cov": 0.01}):
        want = JaxEngine([dbs["jax"]], JaxOptions(backend="numpy", **kw))
        got = port_engine.SearchEngine([dbs["port"]],
                                       port_engine.SearchOptions(**kw))
        w = results(want.search_batch(queries, 5))
        assert results(got.search_batch(queries, 5)) == w
        assert sum(len(r[5]) for r in w) > 20
