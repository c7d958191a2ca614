"""The port's multi-process search on the CPU over gloo: two processes of
kmcp_tpu_torch/tools/multihost_worker.py, each owning half the DB words,
held against a single-process oracle as tests/test_index_search.py:739
holds the JAX worker; and the port's dry run (kmcp_tpu_torch.parallel.
dryrun, the counterpart of __graft_entry__.py's dryrun_multichip) with 4
ranks on the JAX dry run's small DBs."""

import os
import subprocess
import sys

from kmcp_tpu_torch.parallel.dryrun import dryrun_multichip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multihost_worker_two_processes(tmp_path):
    store = f"file://{tmp_path}/store"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "kmcp_tpu_torch.tools.multihost_worker",
             str(i), "2", store, "--device", "cpu", "--backend", "gloo"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-2000:]}"
        assert f"proc {i}: OK counts[(64, 512)] == oracle" in out
        assert f"proc {i}: OK screened sharded step == oracle" in out


def test_dryrun_multichip_four_ranks_cpu():
    lines = dryrun_multichip(4, device="cpu", backend="gloo", timeout_s=300)
    assert [ln.split(":")[0] for ln in lines] == [
        "mesh(d=1,t=4)", "mesh(d=2,t=2)", "mesh(d=4,t=1)"]
    for ln in lines:
        counts = dict(kv.split("=") for kv in ln.split(": ")[1].split())
        assert all(int(v) > 0 for v in counts.values()), ln
