"""The port's count tail (kmcp_tpu_torch/search/device_step.py::count_tail)
against the JAX tail it ports, device_step._make_count_tail (single-block,
XLA path), on the inputs of test_index_search.py's count-tail tests.  The
result layouts are compared exactly: the same n_cand, the same sorted
(id, count) pairs and the same nkmers column."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcp_tpu.search.device import _make_count_tail
from kmcp_tpu_torch.search.device_step import count_tail, target_floor

torch.set_num_threads(1)

BUDGET, MIN_LEN, DEDUP = 4096, 30, 256


def _inputs(seed, S, W, K, B, cmin_val, tmin_val):
    rng = np.random.default_rng(seed)
    T = W * 32
    bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
    bits[S] = 0  # sentinel row
    loc_t = rng.integers(0, S, (K, B), dtype=np.int32)
    loc_t[rng.random((K, B)) < 0.1] = S  # invalid windows
    nk = (loc_t != S).sum(axis=0, dtype=np.int32)[None, :]
    lens = np.full(B, 150, dtype=np.int32)
    lens[::13] = 10  # below min_len
    cmin = np.full(K + 1, cmin_val, dtype=np.int32)
    tmin = np.zeros(T, dtype=np.int32)
    tmin[::3] = tmin_val
    sizes_pos = np.ones(T, dtype=bool)
    sizes_pos[T - 5 :] = False
    return bits, loc_t, nk, lens, cmin, tmin, sizes_pos


# test_count_tail_pallas_matches_xla and test_chunked_count_tail_matches_dense
CASES = {
    "W128": (17, 499, 128, 12, 16, 10, 11),
    "W7": (5, 997, 7, 30, 64, 20, 21),
    # a block of 16,000 rows: past the slice counter's widest tile, in the
    # range of the JAX package's resident row groups
    "S16000": (23, 16_000, 128, 12, 16, 10, 11),
}


def _jax_tail(budget, bits, loc_t, nk, lens, cmin, tmin, sizes_pos):
    meta, aux = _make_count_tail(budget, MIN_LEN, DEDUP, 1)(
        jnp.asarray(bits), (jnp.asarray(loc_t),), jnp.asarray(nk),
        jnp.asarray(lens), jnp.asarray(cmin), jnp.asarray(tmin),
        jnp.asarray(sizes_pos),
    )
    return np.asarray(meta), np.asarray(aux)


def _torch_tail(budget, bits, loc_t, nk, lens, cmin, tmin, sizes_pos,
                chunk_reads=None):
    return count_tail(
        torch.from_numpy(bits.view(np.int32)),
        torch.from_numpy(np.ascontiguousarray(loc_t.T[..., None])),
        torch.from_numpy(nk[0]), torch.from_numpy(lens),
        torch.from_numpy(cmin), torch.from_numpy(target_floor(tmin, sizes_pos)),
        budget, MIN_LEN, DEDUP, chunk_reads,
    )


def _pairs(meta, aux, n):
    ids, cnt = meta[1 : 1 + n], aux[:n]
    o = np.argsort(ids)
    return ids[o], cnt[o]


@pytest.mark.parametrize("case", sorted(CASES))
def test_count_tail_matches_jax(case):
    args = _inputs(*CASES[case])
    B = args[1].shape[1]
    m_j, a_j = _jax_tail(BUDGET, *args)
    m_t, a_t = _torch_tail(BUDGET, *args)
    n = int(m_j[0])
    assert 0 < n <= BUDGET and int(m_t[0]) == n
    assert m_t.dtype == np.int32 and m_t.shape == (1 + BUDGET,)
    assert a_t.dtype == np.uint16 and a_t.shape == (BUDGET + B,)
    for x, y in zip(_pairs(m_j, a_j, n), _pairs(m_t, a_t, n)):
        np.testing.assert_array_equal(x, y)
    # the port emits ids ascending, like the XLA path's compaction
    np.testing.assert_array_equal(m_t[1 : 1 + n], m_j[1 : 1 + n])
    np.testing.assert_array_equal(a_t[BUDGET:], a_j[BUDGET:])


def test_count_tail_overflow_reports_exact_total():
    """Past the budget meta[0] is the exact candidate total, so the stream
    layer retries with 4x the budget."""
    args = _inputs(*CASES["W128"])
    m_full, _ = _torch_tail(BUDGET, *args)
    n = int(m_full[0])
    m_j, _ = _jax_tail(8, *args)
    m_t, a_t = _torch_tail(8, *args)
    assert int(m_t[0]) == int(m_j[0]) == n > 8
    assert m_t.shape == (9,) and a_t.shape == (8 + args[1].shape[1],)
    np.testing.assert_array_equal(m_t[1:], m_full[1:9])


def test_count_tail_read_chunks_keep_the_set():
    """Launching K2' on read chunks gives the same ascending ids."""
    args = _inputs(*CASES["W128"])
    m1, a1 = _torch_tail(BUDGET, *args)
    m4, a4 = _torch_tail(BUDGET, *args, chunk_reads=5)  # 16 reads: 4 chunks
    np.testing.assert_array_equal(m1, m4)
    np.testing.assert_array_equal(a1, a4)
