"""K1' hash_loc (kmcp_tpu_torch/search/hash_loc.py) against the Pallas
kernel it ports (kmcp_tpu/search/pallas_hash.py::make_pallas_hash_loc, run
in interpret mode as the JAX suite runs it) and the C++ scanner.  Every
output is an integer: compared exactly, position by position."""

import numpy as np
import pytest
import torch

from kmcp_tpu.kmer import native
from kmcp_tpu.kmer.sketches import max_hash_for_scale
from kmcp_tpu.search.pallas_hash import make_pallas_hash_loc
from kmcp_tpu_torch.search.hash_loc import hash_loc, hash_loc_plain

torch.set_num_threads(1)

B, L, K = 256, 64, 21
FULL = (1 << 64) - 1


def _reads(seed: int = 13):
    """256 reads over ACGTacgtN at lengths 64/50/25/21, zero padded."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
    reads = [
        rng.choice(bases, size=[64, 50, 25, 21][i % 4],
                   p=[0.118] * 8 + [0.056]).tobytes()
        for i in range(B)
    ]
    mat = np.zeros((B, L), dtype=np.uint8)
    for i, r in enumerate(reads):
        mat[i, : len(r)] = np.frombuffer(r, np.uint8)
    return reads, mat


def _pallas(mat, S, h, max_hash=FULL):
    """[B, K, h] loc and [B] nk from the interpret-mode Pallas kernel."""
    outs = make_pallas_hash_loc(K, L, S, max_hash, interpret=True,
                                num_hashes=h)(mat)
    loc = np.stack([np.asarray(o).T for o in outs[:h]], axis=-1)
    return loc, np.asarray(outs[h])[0]


@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("S", [99991, 4096, 3578, 65536])
def test_hash_loc_matches_pallas(S, h):
    _reads_list, mat = _reads()
    want_loc, want_nk = _pallas(mat, S, h)
    loc, nk = hash_loc(torch.from_numpy(mat), K, S, FULL, h)
    assert loc.dtype == torch.int32 and loc.shape == (B, L - K + 1, h)
    np.testing.assert_array_equal(loc.numpy(), want_loc)
    np.testing.assert_array_equal(nk.numpy(), want_nk)


def test_hash_loc_scaled_max_hash():
    """A FracMinHash scale drops windows with h > max_hash."""
    _reads_list, mat = _reads(7)
    max_hash = int(max_hash_for_scale(3))
    assert max_hash < FULL
    want_loc, want_nk = _pallas(mat, 99991, 1, max_hash)
    loc, nk = hash_loc_plain(torch.from_numpy(mat), K, 99991, max_hash, 1)
    np.testing.assert_array_equal(loc.numpy(), want_loc)
    np.testing.assert_array_equal(nk.numpy(), want_nk)
    full_nk = _pallas(mat, 99991, 1)[1]
    assert (want_nk <= full_nk).all() and want_nk.sum() < full_nk.sum()


@pytest.mark.parametrize("h", [1, 3])
def test_hash_loc_matches_native(h):
    """The C++ scanner packs each read's valid windows; as multisets per
    read and hash they equal the kernel's non-sentinel locations."""
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    reads, mat = _reads()
    S = 99991
    want, counts = native.hash_reads_loc(reads, K, L - K + 1, S, h)
    loc, nk = hash_loc(torch.from_numpy(mat), K, S, FULL, h)
    loc = loc.numpy()
    np.testing.assert_array_equal(nk.numpy(), counts)
    for i in range(B):
        for j in range(h):
            a = sorted(x for x in want[i, :, j].tolist() if x != S)
            b = sorted(x for x in loc[i, :, j].tolist() if x != S)
            assert a == b, (i, j)


def test_hash_loc_rejects_bad_input():
    """Wrong dtype, hash count or device raise; nothing falls back."""
    _reads_list, mat = _reads()
    t = torch.from_numpy(mat)
    with pytest.raises(ValueError):
        hash_loc(t.to(torch.int32), K, 4096, FULL, 1)
    with pytest.raises(ValueError):
        hash_loc(t, K, 4096, FULL, 5)
    with pytest.raises(ValueError):
        hash_loc(torch.empty((B, L), dtype=torch.uint8, device="meta"),
                 K, 4096, FULL, 1)
