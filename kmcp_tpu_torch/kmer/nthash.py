"""ntHash1 rolling k-mer hashing on the host.

The port's copy of kmcp_tpu/kmer/nthash.py: canonical ntHash1 (Mohamadi et
al., 2016) of every k-mer, through the C++ rolling scanner
(csrc/host/nthash.cpp) for ``compute`` and the object engine, and through
the NumPy prefix-XOR formulation for the per-position hashes the minimizer
and syncmer sketches need:

    fh[i] = rol(C[i+k-1] ^ C[i-1], (k-1+i) mod 64),  C = prefix-XOR of
            B[j] = ror(seed(s[j]), j mod 64)
    rh[i] = ror(E[i+k-1] ^ E[i-1], i mod 64),        E = prefix-XOR of
            D[j] = rol(seed(comp(s[j])), j mod 64)
    canonical hash = min(fh, rh)

Windows containing a non-ACGT base produce no hash.  The seeds are shared
with the device hash (search/hash_loc.py, csrc/hash_loc.cu).
"""

from __future__ import annotations

import numpy as np

# ntHash1 seed constants (Mohamadi et al. 2016, bcgsc/ntHash v1).
SEED_A = np.uint64(0x3C8BFBB395C60474)
SEED_C = np.uint64(0x3193C18562A02B4C)
SEED_G = np.uint64(0x20323ED082572324)
SEED_T = np.uint64(0x295549F54BE24456)

_U64_63 = np.uint64(63)
_U64_64 = np.uint64(64)

# Base codes: A=0 C=1 G=2 T=3, anything else = 4 (invalid).
BASE_CODE = np.full(256, 4, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    BASE_CODE[_b] = _c
for _b, _c in zip(b"acgt", range(4)):
    BASE_CODE[_b] = _c

# Seed tables indexed by base code (index 4 = invalid -> 0, never emitted).
SEEDS = np.array([SEED_A, SEED_C, SEED_G, SEED_T, 0], dtype=np.uint64)
# Complement seeds: comp(A)=T, comp(C)=G, comp(G)=C, comp(T)=A.
SEEDS_COMP = np.array([SEED_T, SEED_G, SEED_C, SEED_A, 0], dtype=np.uint64)


def rol64(x: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Rotate-left uint64 by r (elementwise); r is taken mod 64."""
    x = np.asarray(x, dtype=np.uint64)
    r = np.asarray(r, dtype=np.uint64) & _U64_63
    return (x << r) | (x >> ((_U64_64 - r) & _U64_63))


def ror64(x: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Rotate-right uint64 by r (elementwise); r is taken mod 64."""
    x = np.asarray(x, dtype=np.uint64)
    r = np.asarray(r, dtype=np.uint64) & _U64_63
    return (x >> r) | (x << ((_U64_64 - r) & _U64_63))


def encode_seq(seq: bytes | bytearray | np.ndarray) -> np.ndarray:
    """Map ASCII sequence bytes to base codes (A=0 C=1 G=2 T=3, invalid=4)."""
    if isinstance(seq, np.ndarray):
        arr = seq.astype(np.uint8, copy=False)
    else:
        arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    return BASE_CODE[arr]


def _window_hashes(codes: np.ndarray, k: int):
    """Forward and reverse-complement ntHash1 for every window of ``codes``:
    (fh, rh, valid) of length L-k+1; invalid windows' hashes are
    unspecified."""
    L = codes.shape[0]
    n = L - k + 1
    if n <= 0:
        e = np.empty(0, dtype=np.uint64)
        return e, e, np.empty(0, dtype=bool)

    idx = np.arange(L, dtype=np.uint64)

    # Exclusive-prefix-XOR of position-derotated seeds.
    b = ror64(SEEDS[codes], idx)
    c = np.bitwise_xor.accumulate(b)
    d = rol64(SEEDS_COMP[codes], idx)
    e = np.bitwise_xor.accumulate(d)

    i = np.arange(n, dtype=np.uint64)
    hi = i + np.uint64(k - 1)
    # C[i-1]: 0 for i == 0.
    c_prev = np.empty(n, dtype=np.uint64)
    c_prev[0] = 0
    c_prev[1:] = c[: n - 1]
    e_prev = np.empty(n, dtype=np.uint64)
    e_prev[0] = 0
    e_prev[1:] = e[: n - 1]

    fh = rol64(c[hi] ^ c_prev, i + np.uint64(k - 1))
    rh = ror64(e[hi] ^ e_prev, i)

    bad = (codes > 3).astype(np.int64)
    cbad = np.cumsum(bad)
    cbad_prev = np.empty(n, dtype=np.int64)
    cbad_prev[0] = 0
    cbad_prev[1:] = cbad[: n - 1]
    valid = (cbad[k - 1 :] - cbad_prev) == 0

    return fh, rh, valid


def hash_all(
    seq: bytes | bytearray | np.ndarray,
    k: int,
    canonical: bool = True,
    circular: bool = False,
):
    """ntHash1 of every k-mer of ``seq``: ``(hashes, positions)``, the
    uint64 hash and 0-based start position of each *valid* k-mer window,
    in sequence order."""
    from . import native

    if isinstance(seq, np.ndarray):
        seq = seq.tobytes()
    else:
        seq = bytes(seq)
    L = len(seq)
    if L < k or k < 1:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int64)
    if circular and L > k - 1:
        seq = seq + seq[: k - 1]

    h, valid = native.scan(seq, k, canonical)
    pos = np.nonzero(valid)[0]
    return h[pos], pos


def hash_windows(
    seq: bytes | bytearray | np.ndarray,
    k: int,
    circular: bool = False,
):
    """Forward/reverse/canonical hashes + validity for every window, for
    the sketch generators (minimizer / syncmer) which need per-position
    alignment.  Returns (fh, rh, canonical, valid) of length L-k+1 (after
    circular extension)."""
    codes = encode_seq(seq)
    L = codes.shape[0]
    if L < k or k < 1:
        e = np.empty(0, dtype=np.uint64)
        return e, e, e, np.empty(0, dtype=bool)
    if circular and L > k - 1:
        codes = np.concatenate([codes, codes[: k - 1]])
    fh, rh, valid = _window_hashes(codes, k)
    return fh, rh, np.minimum(fh, rh), valid


def hash_reads_batch(
    seqs: list[bytes],
    k: int,
    canonical: bool = True,
    k_max_pad: int = 0,
    max_hash: int | None = None,
):
    """Hash a batch of reads in one pass: the reads joined with single 'N'
    separators (junction windows are invalid) go through one scan.
    Returns a padded ``[B, Kmax]`` uint64 hash matrix, a ``[B, Kmax]``
    validity mask and the per-read k-mer counts; per read identical to
    ``hash_all(seq, k)`` with hash 0 (and hashes above ``max_hash``)
    dropped, duplicates kept, sequence order preserved."""
    from . import native

    B = len(seqs)
    if B == 0:
        z = np.zeros((0, 0), dtype=np.uint64)
        return z, np.zeros((0, 0), dtype=bool), np.zeros(0, dtype=np.int64)
    joined = b"N".join(bytes(s) for s in seqs)
    L = len(joined)

    # read r occupies [starts[r], starts[r] + len_r)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    starts = np.zeros(B, dtype=np.int64)
    np.cumsum(lens[:-1] + 1, out=starts[1:])

    if L < k:
        kmax = max(1, k_max_pad)
        return (
            np.zeros((B, kmax), dtype=np.uint64),
            np.zeros((B, kmax), dtype=bool),
            np.zeros(B, dtype=np.int64),
        )

    h, valid = native.scan(joined, k, canonical)
    # drop hash == 0 like the reference
    valid = valid & (h != 0)
    if max_hash is not None:
        valid = valid & (h <= np.uint64(max_hash))
    if B == 1 and k_max_pad == 0:
        # a single read: the compressed vector is row 0
        hv = h[valid]
        n = len(hv)
        return (
            hv.reshape(1, -1) if n else np.zeros((1, 1), np.uint64),
            np.ones((1, n), dtype=bool) if n else np.zeros((1, 1), bool),
            np.array([n], dtype=np.int64),
        )
    pos = np.nonzero(valid)[0]
    hv = h[pos]
    # Windows of read r occupy the contiguous range [starts[r], starts[r+1])
    # (junction windows are invalid), so B binary searches of the sorted
    # ``pos`` array give per-read extents.
    bounds = np.searchsorted(pos, starts)
    counts = np.empty(B, dtype=np.int64)
    counts[:-1] = np.diff(bounds)
    counts[-1] = len(pos) - bounds[-1]
    kmax = max(int(counts.max()) if B else 0, k_max_pad, 1)
    rid = np.repeat(np.arange(B, dtype=np.int64), counts)
    # column index = rank of the k-mer within its read
    col = np.arange(len(pos), dtype=np.int64) - np.repeat(bounds, counts)
    out = np.zeros((B, kmax), dtype=np.uint64)
    mask = np.zeros((B, kmax), dtype=bool)
    out[rid, col] = hv
    mask[rid, col] = True
    return out, mask, counts
