"""The port's ``merge`` against kmcp_tpu's, byte for byte.

test_torch_profile.py's world is split into two DBs of disjoint halves
of its genomes (g0-g5 and g6-g11); the port searches the reads against
each on the CPU.  ``merge`` of the two TSVs then runs through the port
and through kmcp_tpu twice: in process (its native k-way merge) and in a
subprocess with ``KMCP_TPU_NO_NATIVE=1`` (its pure-Python heap merge),
across -n, -s, -S, -H and a single file; its two error exits; and the
split-by-target check of ``chip_smoke.py``'s phase 10: the one-DB TSV
split into two shards by target merges back to the same rows, and the
merged TSV profiles to the same bytes as the unsplit one.
"""

import json
import os
import subprocess
import sys
from collections import Counter

import pytest

from kmcp_tpu.merge.merge import run_merge as jax_run_merge
from kmcp_tpu_torch.merge.merge import run_merge

from .test_torch_profile import (
    build_db,
    build_world,
    cli_both,
    read_out,
    search,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "default": {},
    "top1": {"keep_top_scores": 1},
    "tcov": {"sort_by": "tcov"},
    "jacc": {"sort_by": "jacc"},
    "do_not_sort": {"do_not_sort": True},
    "no_header": {"no_header_row": True},
}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The world, and the port's search TSVs of its reads against the two
    half DBs."""
    root = str(tmp_path_factory.mktemp("merge_world"))
    w = build_world(root)
    tsvs = []
    for h, sl in enumerate((slice(0, 6), slice(6, 12))):
        _, db = build_db(root, w["genomes"][sl], w["names"][sl], f"half{h}")
        tsvs.append(search(db, w["reads"], os.path.join(root, f"h{h}.tsv")))
    w["shards"] = tsvs
    return w


def run_no_native(jobs) -> dict:
    """kmcp_tpu's merge with KMCP_TPU_NO_NATIVE=1 in one subprocess:
    ``jobs`` is {name: (files, out, kwargs)}; returns {name: exit text or
    None}."""
    code = (
        "import json, sys\n"
        "from kmcp_tpu.merge.merge import run_merge\n"
        "res = {}\n"
        "for name, (files, out, kw) in json.loads(sys.argv[1]).items():\n"
        "    try:\n"
        "        run_merge(files, out, **kw)\n"
        "        res[name] = None\n"
        "    except SystemExit as e:\n"
        "        res[name] = str(e)\n"
        "print(json.dumps(res))\n"
    )
    env = dict(os.environ, KMCP_TPU_NO_NATIVE="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code, json.dumps(jobs)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def heap_outputs(shards, tmp_path_factory):
    """kmcp_tpu's pure-Python merge of every case, in one subprocess."""
    d = str(tmp_path_factory.mktemp("heap"))
    jobs = {n: (shards["shards"], os.path.join(d, f"{n}.tsv"), kw)
            for n, kw in CASES.items()}
    jobs["one_file"] = ([shards["shards"][0]],
                        os.path.join(d, "one_file.tsv"), {})
    res = run_no_native(jobs)
    assert all(v is None for v in res.values()), res
    return {n: read_out(j[1]) for n, j in jobs.items()}


@pytest.mark.parametrize("case", sorted(CASES) + ["one_file"])
def test_merge_matches_both_kmcp_tpu_paths(shards, heap_outputs, tmp_path,
                                           case):
    files = shards["shards"][:1] if case == "one_file" else shards["shards"]
    kw = CASES.get(case, {})
    jax_out, port_out = str(tmp_path / "jax.tsv"), str(tmp_path / "port.tsv")
    jax_run_merge(files, jax_out, **kw)
    run_merge(files, port_out, **kw)
    port = read_out(port_out)
    assert port == read_out(jax_out)
    assert port == heap_outputs[case]
    assert port.count(b"\n") > 1000


def test_merge_gz_through_command_line(shards, tmp_path):
    jo, po = cli_both(str(tmp_path), [
        "-q", "merge", *shards["shards"], "-s", "jacc", "-o",
        "{d}/m.tsv.gz"])
    assert jo == po and po["m.tsv.gz"]


def error_inputs(shards, d):
    """(unmatched query ids, different query counts): each a pair of
    files that kmcp's merge must refuse.  The first pair is one shard and
    its copy with every query id renamed, so every queryIdx group
    mismatches."""
    with open(shards["shards"][0]) as f:
        lines = f.read().splitlines(keepends=True)
    renamed = os.path.join(d, "renamed.tsv")
    with open(renamed, "w") as f:
        for ln in lines:
            f.write(ln if ln.startswith("#") else "x" + ln)
    fewer = os.path.join(d, "fewer.tsv")
    with open(fewer, "w") as f:
        for ln in lines:
            if ln.startswith("# input queries:"):
                n = int(ln.split(":")[1])
                ln = f"# input queries: {n - 1}\n"
            f.write(ln)
    return ([shards["shards"][0], renamed], [shards["shards"][1], fewer])


def test_merge_error_exits(shards, tmp_path):
    d = str(tmp_path)
    ids, counts = error_inputs(shards, d)
    msgs = {}
    for name, files in (("ids", ids), ("counts", counts)):
        got = []
        for fn in (jax_run_merge, run_merge):
            with pytest.raises(SystemExit) as e:
                fn(files, os.path.join(d, f"{name}.out"))
            got.append(str(e.value))
        assert got[0] == got[1], name
        msgs[name] = got[1]
    assert "unmatched sequence Ids" in msgs["ids"]
    assert msgs["counts"].startswith("different numbers of queries")
    heap = run_no_native({
        "ids": (ids, os.path.join(d, "ids.heap"), {}),
        "counts": (counts, os.path.join(d, "counts.heap"), {}),
    })
    assert "unmatched sequence Ids" in heap["ids"]
    assert heap["counts"] == msgs["counts"]


def split_by_target(tsv: str, out_dir: str, first_half) -> list[str]:
    """Split a search TSV's rows into two shard TSVs by target (those in
    ``first_half``, and the rest), each with its header and its own '#'
    stat lines, as searches of two DB shards would write them."""
    text = read_out(tsv).decode()
    rows = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    total = int(text.split("# input queries: ")[1].split("\n")[0])
    header = text.splitlines()[0] + "\n"
    paths = []
    for h in range(2):
        part = [r for r in rows
                if (r.split("\t")[5] in first_half) == (h == 0)]
        matched = len({r.split("\t")[14] for r in part})
        hits = Counter(r.split("\t")[14] for r in part)
        p = os.path.join(out_dir, f"shard{h}.tsv")
        with open(p, "w") as f:
            f.write(header)
            for r in part:
                c = r.split("\t")
                c[4] = str(hits[c[14]])
                f.write("\t".join(c) + "\n")
            f.write(f"# input queries: {total}\n")
            f.write(f"# matched queries: {matched}\n")
            pct = matched / total * 100 if total else 0.0
            f.write(f"# matched percentage: {pct:.4f}%\n")
        paths.append(p)
    return paths


def body_rows(data: bytes) -> list[str]:
    return [ln for ln in data.decode().splitlines()
            if ln and not ln.startswith("#")]


def test_split_by_target_merges_back(shards, tmp_path):
    """chip_smoke.py phase 10 (c) at the CPU size: rows as a multiset,
    hits included; descending score within a query; the same profile
    bytes from both packages."""
    w = shards
    d = str(tmp_path)
    parts = split_by_target(w["tsv"], d, set(w["names"][:6]))
    merged = os.path.join(d, "merged.tsv")
    run_merge(parts, merged)
    rows, unsplit = body_rows(read_out(merged)), body_rows(read_out(w["tsv"]))
    assert Counter(rows) == Counter(unsplit)
    by_q = {}
    for r in rows:
        c = r.split("\t")
        by_q.setdefault(c[14], []).append(float(c[11]))
    assert all(v == sorted(v, reverse=True) for v in by_q.values())
    tax = ["-T", w["taxid_map"], "-X", w["taxdump"]]
    outs = []
    for name, tsv in (("unsplit", w["tsv"]), ("merged", merged)):
        jo, po = cli_both(os.path.join(d, name), [
            "-q", "profile", *tax, tsv, "-o", "{d}/p.profile",
            "-C", "{d}/c", "-B", "{d}/b"])
        assert jo == po
        outs.append(po)
    assert outs[0] == outs[1]
    assert outs[1]["b.binning.gz"].count(b"\n") > 1000
