"""The run's refusals: no CUDA card, a forbidden module loaded, a
directory without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, REPO

import run


@pytest.mark.parametrize("modules,bad", [
    (["kmcp_tpu_torch", "kmcp_tpu_torch.search.stream", "torch"], []),
    (["kmcp_tpu.search.device"], ["kmcp_tpu"]),
    (["kmcp_tpu"], ["kmcp_tpu"]),
    (["jax", "jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "flaxen", "kmcp_tpu2", "kmcp_tpu_torchx"], []),
])
def test_guard_compares_whole_top_level_names(modules, bad):
    assert run.forbidden_modules(modules) == bad


def test_the_harness_loads_no_forbidden_module():
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness.window, "
            "harness.reference, limits, run; "
            "print(run.forbidden_modules())" % (BENCH, REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def _run(cwd: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dense-se",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Here torch sees no CUDA card: the run exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run(REPO)
    assert res.returncode != 0
    assert not any(line.startswith("{") for line in res.stdout.splitlines())


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's own files: no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    res = _run(str(tmp_path))
    assert res.returncode != 0
    assert not any(line.startswith("{") for line in res.stdout.splitlines())
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        assert json.load(f)["paths"] == ["benchmark"]
