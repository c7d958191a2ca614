"""State carried across from the JAX package, and the port's import
boundary: TorchDeviceDB built from a JAX DeviceDB's arrays equals the one
built from the index, array by array; the port's command line never loads
jax."""

import os
import subprocess
import sys

import numpy as np
import torch

from kmcp_tpu.search.device import DeviceDB
from kmcp_tpu.search.engine import SearchEngine, SearchOptions
from kmcp_tpu_torch.search.device import TorchDeviceDB

from .test_torch_stream import build_db, mixed_reads, random_genomes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_state_from_jax_device_db_matches_index(tmp_path):
    # 4 x 8 = 32 targets fill one word: no size-0 padding lanes, which
    # kmcp_tpu's build_tmin_table cannot take with min_target_cov > 0
    rng = np.random.default_rng(21)
    db_dir = build_db(tmp_path, random_genomes(rng, 4, 20000), num_hashes=2,
                      split_number=8)
    opt = SearchOptions(min_target_cov=0.01)
    db = SearchEngine([db_dir], opt).dbs[0]
    jdev = DeviceDB(db, opt)
    jdev.cmin_for(140)
    state = {
        "bits_ext": np.asarray(jdev.bits_ext),
        "names": jdev.names,
        "indices": jdev.indices,
        "gsizes": jdev.gsizes,
        "sizes": jdev.sizes,
        "sizes_pos": jdev.sizes_pos_np,
        "tmin": jdev._tmin_np,
        "cmin": {n: np.asarray(t) for n, t in jdev._cmin_cache.items()},
        "k": 21,
        "num_hashes": 2,
        "max_hash": (1 << 64) - 1,
    }
    carried = TorchDeviceDB.from_numpy_state(state, opt, "cpu")
    built = TorchDeviceDB(db, opt, "cpu")
    assert carried.bits_ext.dtype == torch.int32
    np.testing.assert_array_equal(
        carried.bits_ext.numpy().view(np.uint32), state["bits_ext"]
    )
    assert not state["bits_ext"][-1].any()  # sentinel row
    for dev in (carried, built):
        np.testing.assert_array_equal(dev.bits_ext.numpy(),
                                      carried.bits_ext.numpy())
        np.testing.assert_array_equal(dev.thr.numpy(), carried.thr.numpy())
        np.testing.assert_array_equal(dev._tmin_np, jdev._tmin_np)
        np.testing.assert_array_equal(dev.sizes, jdev.sizes)
        np.testing.assert_array_equal(dev.indices, jdev.indices)
        np.testing.assert_array_equal(dev.gsizes, jdev.gsizes)
        assert dev.names == list(jdev.names)
        assert (dev.total_rows, dev.w, dev.k, dev.num_hashes) == (
            jdev.total_rows, jdev.w, 21, 2)
        np.testing.assert_array_equal(dev.cmin_for(140).numpy(),
                                      np.asarray(jdev.cmin_for(140)))
    assert jdev.sizes_pos_np.all() and (jdev._tmin_np > 1).all()


def test_command_line_never_loads_jax(tmp_path):
    """``python -m kmcp_tpu_torch search --device cpu`` on a tiny one-block
    DB and on a screened multi-block DB (which reads its union screens
    through kmcp_tpu.search.device_screened and kmcp_tpu.index.format),
    with a hook that fails the process if jax is in sys.modules at
    exit."""
    rng = np.random.default_rng(4)
    genomes = random_genomes(rng, 3, 20000)
    db = build_db(tmp_path / "one", genomes)
    screened = build_db(tmp_path / "screened", genomes, split_number=4,
                        native_block_targets=4, block_screen=True,
                        uniform_sigs=True)
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for rid, seq, _ in mixed_reads(rng, genomes, 60):
            f.write(f"@{rid}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
    out = tmp_path / "out.tsv"
    hook = (
        "import atexit, os, runpy, sys\n"
        "def check():\n"
        "    if 'jax' in sys.modules:\n"
        "        print('jax was imported', file=sys.stderr)\n"
        "        os._exit(3)\n"
        "atexit.register(check)\n"
        "sys.argv = ['kmcp_tpu_torch'] + sys.argv[1:]\n"
        "runpy.run_module('kmcp_tpu_torch', run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    for d in (db, screened):
        res = subprocess.run(
            [sys.executable, "-c", hook, "-q", "search", "--device", "cpu",
             "-d", d, str(fq), "-o", str(out)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
        )
        assert res.returncode == 0, res.stderr
        assert out.read_text().startswith("#query")
        out.unlink()
