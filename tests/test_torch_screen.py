"""The screened tail of the port (kmcp_tpu_torch/search/screen.py) and its
pieces against the JAX package, on the synthetic inputs of
tests/test_pallas_pair.py (3 blocks of 40 rows x 4,096 targets, W_b = 128):

- the tail with pass2="pair" and pass2="gemm" (the kernels' plain versions)
  vs ``_make_screened_tail`` on its XLA pass 2, its pair kernel
  (``pair_pc``) and its grouped GEMM (``gemm_pc``), the Pallas kernels in
  interpret mode: byte-identical (meta, aux) when nothing overflows, and
  n > budget on both sides when the budget is starved (the mirrors of the
  five tests of test_pallas_pair.py);
- the row-multiplicity matrix U vs ``_build_u_digit``, and the plain K6'
  exact at multiplicity 256;
- K6''s route (fused floors, each pair's row in place) vs K5''s, pair by
  pair, and its tail vs the JAX GEMM route at chunks that cut block tiles;
- pair-chunked vs unchunked pass 2;
- K1''s screen plane vs ``make_pallas_hash_loc(..., screen_sigs=N)``;
- the paired mode (``in_dedup``: over-threshold reads uniqued in both
  planes before either pass) vs ``_make_screened_tail(in_dedup=True)`` on
  its XLA pass 2, and vs its pair kernel on the planes
  ``_dedup_value_planes`` uniques.
Every value is an integer: compared exactly."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmcp_tpu.search.device import (
    _build_u_digit,
    _gemm_geometry,
    _make_screened_tail,
)
from kmcp_tpu.search.device_step import _dedup_value_planes
from kmcp_tpu.search.pallas_count import pack_gemm_blocks, pack_pair_blocks
from kmcp_tpu.search.pallas_hash import make_pallas_hash_loc
from kmcp_tpu_torch.search.device_step import target_floor
from kmcp_tpu_torch.search.group_count import (
    TILE,
    build_u,
    gemm_slabs,
    group_count,
    group_count_plain,
    s_pad_for,
)
from kmcp_tpu_torch.search.hash_loc import hash_loc
from kmcp_tpu_torch.search.pair_count import pair_count, pair_count_plain
from kmcp_tpu_torch.search.screen import (
    _pass2_gemm,
    _pass2_pair,
    active_pairs,
    screened_tail,
)

from .test_pallas_pair import B, K, NB, NU, S_BLOCK, T_BLOCK, _synthetic
from .test_torch_paired import joined_values, value_pool

torch.set_num_threads(1)

MIN_LEN, DEDUP = 10, 256
BIG = 65536  # a candidate budget nothing overflows


@functools.lru_cache(maxsize=None)
def jax_tail(seed: int, route: str, budget: int):
    """(meta, aux) of _make_screened_tail on seed's inputs: route "xla",
    "pair" (the Mosaic pair kernel) or "gemm" (the grouped GEMM), both in
    interpret mode; pair budget B * NB (no pair overflow)."""
    bits, args = _synthetic(seed)
    kw, bits_arg = {}, jnp.asarray(bits)
    if route == "pair":
        kw["pair_pc"] = (args[1].shape[0], True)
        bits_arg = pack_pair_blocks(bits_arg, NB, S_BLOCK)
    elif route == "gemm":
        S_pad, T_t = _gemm_geometry(S_BLOCK, T_BLOCK)
        kw["gemm_pc"] = (S_pad, T_t, True)
        bits_arg = pack_gemm_blocks(bits_arg, NB, S_BLOCK, S_pad)
    tail = _make_screened_tail(budget, B * NB, MIN_LEN, DEDUP, NB, T_BLOCK,
                               S_BLOCK, 1, **kw)
    meta, aux = tail(bits_arg, *args)
    return np.asarray(meta), np.asarray(aux)


@functools.lru_cache(maxsize=None)
def port_inputs(seed: int) -> dict:
    bits, args = _synthetic(seed)
    u, loc_t, locu_t, nk, lens, cmin, theta, tmin, spos = (
        np.asarray(a) for a in args
    )
    as_t = lambda a: torch.from_numpy(np.array(a, order="C"))  # noqa: E731
    bits_ext = as_t(bits.view(np.int32))
    return {
        "bits_ext": bits_ext,
        "u_ext": as_t(u.view(np.int32)),
        "loc": as_t(loc_t.T),
        "loc_u": as_t(locu_t.T),
        "nk": as_t(nk[0]),
        "lens": as_t(lens),
        "cmin": as_t(cmin),
        "theta": as_t(theta),
        "thr": as_t(target_floor(tmin, spos).reshape(NB, T_BLOCK)),
        "bits01": gemm_slabs(bits_ext, NB, S_BLOCK, s_pad_for(S_BLOCK)),
    }


def port_tail(seed: int, pass2: str, budget: int, chunk_pairs=None):
    x = port_inputs(seed)
    return screened_tail(
        x["bits_ext"], x["u_ext"], x["loc"], x["loc_u"], x["nk"], x["lens"],
        x["cmin"], x["theta"], x["thr"], budget, MIN_LEN, DEDUP, pass2,
        x["bits01"], chunk_pairs,
    )


@pytest.mark.parametrize("route", ["xla", "pair"])
def test_pair_tail_matches_jax(route):
    """test_pair_kernel_tail_parity's mirror: the port's K5' tail equals
    the JAX tail on its XLA pass 2 and on its pair kernel, byte for byte."""
    meta, aux = port_tail(3, "pair", BIG)
    want_meta, want_aux = jax_tail(3, route, BIG)
    assert 0 < meta[0] <= BIG
    np.testing.assert_array_equal(meta, want_meta)
    np.testing.assert_array_equal(aux, want_aux)


@pytest.mark.parametrize("route", ["xla", "gemm"])
def test_gemm_tail_matches_jax(route):
    """test_gemm_tail_parity's mirror: the port's K6' tail equals the JAX
    tail on its XLA pass 2 and on its grouped GEMM, byte for byte."""
    meta, aux = port_tail(3, "gemm", BIG)
    want_meta, want_aux = jax_tail(3, route, BIG)
    assert 0 < meta[0] <= BIG
    np.testing.assert_array_equal(meta, want_meta)
    np.testing.assert_array_equal(aux, want_aux)


@pytest.mark.parametrize("pass2,route", [("pair", "xla"), ("gemm", "gemm")])
def test_tail_overflow_agrees_with_jax(pass2, route):
    """The overflow tests' mirror: a starved budget (256) reports n above
    it on both sides (the JAX tail reports budget + 1, the port the exact
    total), so the stream's 4x retry fires either way."""
    n_all = int(port_tail(3, pass2, BIG)[0][0])
    meta, _ = port_tail(3, pass2, 256)
    assert int(meta[0]) == n_all > 256
    assert int(jax_tail(3, route, 256)[0][0]) == 257


def test_gemm_tail_matches_pair_tail():
    """test_gemm_tail_matches_pair_kernel's mirror on the second seed:
    the port's two pass-2 kernels and the JAX tail's XLA and GEMM routes
    agree (its pair-kernel route, slow to build in interpret mode, is held
    on the first seed only)."""
    got_p = port_tail(11, "pair", BIG)
    got_g = port_tail(11, "gemm", BIG)
    for route in ("xla", "gemm"):
        for a, b, c in zip(got_p, got_g, jax_tail(11, route, BIG)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("pass2", ["pair", "gemm"])
def test_tail_without_active_pairs_matches_jax(pass2):
    """No read long enough: no pair, no candidate, the padded layout and
    the reads' k-mer counts, as the JAX tail writes them."""
    x = port_inputs(3)
    got = screened_tail(
        x["bits_ext"], x["u_ext"], x["loc"], x["loc_u"], x["nk"], x["lens"],
        x["cmin"], x["theta"], x["thr"], 512, 1000, DEDUP, pass2,
        x["bits01"],
    )
    bits, args = _synthetic(3)
    tail = _make_screened_tail(512, B * NB, 1000, DEDUP, NB, T_BLOCK,
                               S_BLOCK, 1)
    want = tail(jnp.asarray(bits), *args)
    assert got[0][0] == 0
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("pass2,chunk", [("pair", 7), ("pair", 40),
                                         ("gemm", TILE)])
def test_chunked_pairs_match_unchunked(pass2, chunk):
    """test_screened_tail_chunked_pairs_match_unchunked's mirror: pass 2
    on pair chunks (several per batch) gives the unchunked output."""
    for seed in (3, 11):
        want = port_tail(seed, pass2, BIG)
        got = port_tail(seed, pass2, BIG, chunk_pairs=chunk)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_build_u_matches_jax_digit_product():
    """U vs _build_u_digit, including multiplicities 200 and 256 and the
    sentinel rows."""
    rng = np.random.default_rng(5)
    Bu, Ku, S_pad = 64, 256, 384
    loc = rng.integers(0, 301, size=(Bu, Ku)).astype(np.int32)
    loc[0, :] = 7  # multiplicity 256 on one row (a homopolymer read)
    loc[1, :200] = 9  # multiplicity 200
    want = np.asarray(_build_u_digit(jnp.asarray(loc), S_pad))
    got = build_u(torch.from_numpy(loc), S_pad)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    assert got[0, 7] == 256 and got[1, 9] >= 200


def test_kernels_plain_match_on_pairs():
    """K5' and K6' (plain versions) agree count for count and mask word for
    mask word on the same unsorted pairs, each written at its own row."""
    x = port_inputs(11)
    rng = np.random.default_rng(0)
    pb = torch.from_numpy(rng.integers(0, B, 50).astype(np.int32))
    pg = torch.from_numpy(rng.integers(0, NB, 50).astype(np.int32))
    cthr = torch.from_numpy(rng.integers(0, 4, B).astype(np.int32))
    counts, mask = pair_count(x["bits_ext"], x["loc"], pb, pg, cthr, x["thr"])
    g_counts, g_mask = group_count(x["bits01"], x["loc"], pb, pg, cthr,
                                   x["thr"], S_BLOCK)
    assert int(counts.max()) > 0 and bool(mask.any())
    np.testing.assert_array_equal(g_counts.numpy(), counts.numpy())
    np.testing.assert_array_equal(g_mask.numpy(), mask.numpy())


@pytest.mark.parametrize("seed", [3, 11])
def test_pass2_gemm_matches_pair_route(seed):
    """The K6' route (fused floors, rows at the pair's index, no restoring
    sort) yields the K5' route's (pair, lane, count) triples in the same
    order, on the tail's own active pairs, in one chunk and in chunks of
    20 pairs."""
    x = port_inputs(seed)
    pb, pg = active_pairs(x["u_ext"], x["loc_u"], x["nk"], x["lens"],
                          x["theta"], NB, MIN_LEN, DEDUP)
    cthr = torch.from_numpy(
        np.random.default_rng(seed).integers(0, 40, B).astype(np.int32))
    assert pb.shape[0] > 20
    want = _pass2_pair(x["bits_ext"], x["loc"], pb, pg, cthr, x["thr"], 1 << 20)
    assert want[0].numel() > 0
    for chunk in (1 << 20, 20):
        got = _pass2_gemm(x["bits01"], x["loc"], pb, pg, cthr, x["thr"],
                          S_BLOCK, chunk)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("chunk", [None, 50])
def test_gemm_tail_fused_floors_match_jax_gemm(chunk):
    """The port's K6' tail (floors fused into the kernel's plain version)
    equals the JAX tail's grouped GEMM route in interpret mode and the
    port's K5' tail, byte for byte, whole and on pair chunks of 50."""
    meta, aux = port_tail(3, "gemm", BIG, chunk_pairs=chunk)
    for want_meta, want_aux in (jax_tail(3, "gemm", BIG),
                                port_tail(3, "pair", BIG)):
        np.testing.assert_array_equal(meta, want_meta)
        np.testing.assert_array_equal(aux, want_aux)


def test_group_count_plain_exact_at_multiplicity_256():
    """A read whose 256 windows all hit one row (a homopolymer) counts 256
    on that row's set targets: U holds 256 exactly in bf16, and the counts
    and floors equal the plain pair count's."""
    x = port_inputs(3)
    Kr = 256
    loc = np.full((4, Kr), S_BLOCK, dtype=np.int32)  # sentinel windows
    loc[0, :] = 7  # multiplicity 256
    loc[1, :255] = 9  # multiplicity 255 and one more row
    loc[1, 255] = 10
    loc[2, ::2] = 11  # multiplicity 128 and 128 sentinels; read 3: all
    loc = torch.from_numpy(loc)
    pb = torch.tensor([0, 1, 2, 3, 0], dtype=torch.int32)
    pg = torch.tensor([0, 2, 1, 0, 1], dtype=torch.int32)
    cthr = torch.tensor([256, 200, 0, 0], dtype=torch.int32)
    got = group_count_plain(x["bits01"], loc, pb, pg, cthr, x["thr"], S_BLOCK)
    want = pair_count_plain(x["bits_ext"], loc, pb, pg, cthr, x["thr"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    counts = got[0]
    assert int(counts[0].max()) == 256 and int(counts[3].max()) == 0
    assert set(counts[0].unique().tolist()) == {0, 256}
    assert bool(got[1][0].any())  # 256 reaches the read floor 256


@pytest.mark.parametrize("N", [1 << 20, 999_983])
def test_screen_plane_matches_pallas(N):
    """K1''s screen plane position by position vs the Pallas kernel's
    (interpret mode), N a power of two and a prime."""
    rng = np.random.default_rng(13)
    Bh, L, k, S = 256, 64, 21, 3578
    bases = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
    mat = rng.choice(bases, size=(Bh, L), p=[0.118] * 8 + [0.056])
    mat = mat.astype(np.uint8)
    mat[np.arange(L)[None, :] >= rng.integers(0, L + 1, Bh)[:, None]] = 0
    loc_t, locu_t, nk = make_pallas_hash_loc(
        k, L, S, (1 << 64) - 1, interpret=True, screen_sigs=N)(mat)
    loc, nk_p, loc_u = hash_loc(torch.from_numpy(mat), k, S, (1 << 64) - 1,
                                1, screen_sigs=N)
    np.testing.assert_array_equal(loc_u.numpy(), np.asarray(locu_t).T)
    np.testing.assert_array_equal(loc[:, :, 0].numpy(), np.asarray(loc_t).T)
    np.testing.assert_array_equal(nk_p.numpy(), np.asarray(nk)[0])
    assert (loc_u.numpy() == N).any() and (loc_u.numpy() < N).any()


THR_P = 6  # a dedup threshold that the 12-window reads cross


@pytest.mark.parametrize("route", ["xla", "pair"])
def test_screened_tail_in_dedup_matches_jax(route):
    """The paired mode on seed 5's blocks, union table and floors, with
    value planes from a pool of 7 values (half the reads at or under the
    threshold keep their duplicates): the port's tail with in_dedup, pass2
    "pair" and "gemm", equals _make_screened_tail(in_dedup=True) on its XLA
    pass 2 byte for byte; and equals the pair-kernel tail that
    test_pair_tail_matches_jax compiles, fed the planes and unique counts
    _dedup_value_planes gives (what in_dedup runs both passes on: no
    unique count reaches DEDUP), which equals the XLA pass 2 with
    in_dedup."""
    rng = np.random.default_rng(5)
    bits, args = _synthetic(5)
    u = np.asarray(args[0])
    lens, cmin, theta, tmin, spos = (np.asarray(a) for a in args[4:])
    vhi, vlo, (loc_t, locu_t), nk = value_pool(rng, K, B, 7, (S_BLOCK, NU),
                                               THR_P)
    j = jnp.asarray
    tail_args = (j(cmin), j(theta), j(tmin), j(spos))
    want = _make_screened_tail(
        BIG, B * NB, MIN_LEN, THR_P, NB, T_BLOCK, S_BLOCK, 1, in_dedup=True)(
        j(bits), j(u), j(loc_t), j(locu_t), j(nk[None]), j(lens),
        *tail_args, (j(vhi), j(vlo)))
    want = [np.asarray(a) for a in want]
    if route == "pair":
        (dl, du), dnk = _dedup_value_planes(
            j(vhi), j(vlo), [j(loc_t), j(locu_t)], j(nk), THR_P,
            (S_BLOCK, NU))
        tail = _make_screened_tail(BIG, B * NB, MIN_LEN, DEDUP, NB, T_BLOCK,
                                   S_BLOCK, 1, pair_pc=(K, True))
        got_j = tail(pack_pair_blocks(j(bits), NB, S_BLOCK), j(u), dl, du,
                     dnk[None], j(lens), *tail_args)
        for a, b in zip(got_j, want):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert 0 < want[0][0] <= BIG
    x = port_inputs(5)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    for pass2 in ("pair", "gemm"):
        meta, aux = screened_tail(
            x["bits_ext"], x["u_ext"], as_t(loc_t.T), as_t(locu_t.T),
            as_t(nk), x["lens"], x["cmin"], x["theta"], x["thr"], BIG,
            MIN_LEN, THR_P, pass2, x["bits01"], in_dedup=True,
            values=joined_values(vhi, vlo))
        np.testing.assert_array_equal(meta, want[0], err_msg=pass2)
        np.testing.assert_array_equal(aux, want[1], err_msg=pass2)
    assert (aux[BIG:] < nk).any() and (nk > THR_P).any()
