"""The one generator of read pools: a traffic file's parameters, the
configuration's genomes and ``--seed`` in, a pool of reads or read pairs
out, written once as gzipped FASTQ: the run's sample, which the window
reads once and never cycles.

A traffic file (``benchmark/traffic/<name>.json``) holds:

- ``paired``: single-end reads, or pairs as ``-1 R1 -2 R2``;
- ``pool_per_second``: the pool holds this many reads (pairs) for each
  second of the window (``pool_size``), above the rate the program
  reaches, so that the window ends before the pool does;
- ``read_bp``: the length of every read (mate);
- ``source_genomes``: how many of the DB's genomes the sample holds,
  drawn from the seed;
- ``mix``: {class: share} of the pool, the counts exact for every seed and
  the order a permutation from the seed. Classes: ``source`` (a read of a
  source genome; a pair from one fragment inside one chunk target, mate 2
  the reverse complement ``fragment_bp - read_bp`` bases on), ``random``
  (uniform bases; both mates), ``random_mate2`` (a source pair whose mate
  2 is random) and ``host`` (from a host genome that is not in the DB: a
  read, or a fragment's pair);
- ``fragment_bp`` (pairs), ``host_genome_bp`` and ``host_seed`` (the host
  genome is the same for every seed).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import zlib
from dataclasses import dataclass

import numpy as np

from .genomes import ACGT, chunk_bounds

CLASSES = ("source", "random", "random_mate2", "host")
ID_PREFIX = b"read"


@dataclass
class Pool:
    """``seq1`` (and ``seq2`` for pairs): [queries, read_bp] ASCII bases;
    ``kind``: the class index of each query (``CLASSES``)."""

    seq1: np.ndarray
    seq2: np.ndarray | None
    kind: np.ndarray

    @property
    def size(self) -> int:
        return self.seq1.shape[0]

    @property
    def id_digits(self) -> int:
        return len(str(max(self.size - 1, 0)))

    def query_id(self, i: int) -> str:
        return f"{ID_PREFIX.decode()}{i:0{self.id_digits}d}"


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator of ``seed`` (any whole number) and a stream tag, so
    that the reads, the sample and the fragments draw independently."""
    return np.random.default_rng([seed % (1 << 63), *stream])


def _counts(mix: dict, n: int) -> dict:
    """Exact count of each class: shares rounded, the remainder to the
    largest class."""
    bad = set(mix) - set(CLASSES)
    if bad:
        raise ValueError(f"unknown read classes {sorted(bad)}")
    out = {c: int(round(s * n)) for c, s in mix.items()}
    big = max(out, key=lambda c: mix[c])
    out[big] += n - sum(out.values())
    return out


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[:, ::-1]


def _windows(flat: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    return np.lib.stride_tricks.sliding_window_view(flat, width)[starts]


def pool_size(traffic: dict, seconds: float) -> int:
    """Reads (pairs) in the pool of a window of ``seconds``."""
    return int(np.ceil(float(traffic["pool_per_second"]) * seconds))


def make_pool(traffic: dict, config: dict, codes: np.ndarray, seed: int,
              n: int) -> Pool:
    """The pool of ``n`` queries of ``traffic`` drawn from ``seed``:
    ``codes`` are the configuration's genomes
    (``genomes.genome_codes``)."""
    rng = rng_for(seed, 0)
    rl = int(traffic["read_bp"])
    paired = bool(traffic["paired"])
    frag = int(traffic.get("fragment_bp", rl))
    G, L = codes.shape
    flat = codes.reshape(-1)
    sources = rng.choice(G, size=min(int(traffic["source_genomes"]), G),
                         replace=False)
    counts = _counts(traffic["mix"], n)
    kind = np.concatenate([np.full(counts.get(c, 0), i, dtype=np.int8)
                           for i, c in enumerate(CLASSES)])
    kind = kind[rng.permutation(n)]
    # uniform bases only in the rows that keep them: every other row is
    # overwritten from a genome below
    m1 = np.empty((n, rl), dtype=np.uint8)
    r1 = np.nonzero(kind == 1)[0]
    m1[r1] = rng.integers(0, 4, size=(len(r1), rl), dtype=np.uint8)
    m2 = None
    if paired:
        m2 = np.empty((n, rl), dtype=np.uint8)
        r2 = np.nonzero((kind == 1) | (kind == 2))[0]
        m2[r2] = rng.integers(0, 4, size=(len(r2), rl), dtype=np.uint8)

    # source reads and pairs
    src = np.nonzero((kind == 0) | (kind == 2))[0]
    g = sources[rng.integers(0, len(sources), len(src))]
    if paired:
        # the fragment inside one chunk target, so one target holds all
        # of the pair's k-mers
        bounds = np.array(chunk_bounds(config), dtype=np.int64)
        c = rng.integers(0, len(bounds), len(src))
        span = bounds[c, 1] - bounds[c, 0] - frag + 1
        if span.min() < 1:
            raise ValueError(f"fragments of {frag} bp do not fit a chunk")
        p = bounds[c, 0] + (rng.random(len(src)) * span).astype(np.int64)
    else:
        p = rng.integers(0, L - rl + 1, len(src))
    start = g.astype(np.int64) * L + p
    m1[src] = _windows(flat, start, rl)
    if paired:
        pure = src[kind[src] == 0]
        m2[pure] = _revcomp(_windows(flat, start[kind[src] == 0]
                                     + frag - rl, rl))

    host = np.nonzero(kind == 3)[0]
    if len(host):
        hrng = np.random.default_rng(int(traffic["host_seed"]))
        hg = hrng.integers(0, 4, size=int(traffic["host_genome_bp"]),
                           dtype=np.uint8)
        hp = rng.integers(0, len(hg) - frag + 1, len(host))
        m1[host] = _windows(hg, hp, rl)
        if paired:
            m2[host] = _revcomp(_windows(hg, hp + frag - rl, rl))
    return Pool(ACGT[m1], None if m2 is None else ACGT[m2], kind)


def _records(pool: Pool, seqs: np.ndarray, first: int) -> np.ndarray:
    """FASTQ records of queries ``first`` on, one fixed-width row each:
    ``@<query id>``, the bases, ``+``, a quality of "I" a base."""
    n, rl = pool.size - first, seqs.shape[1]
    w = pool.id_digits
    head = 1 + len(ID_PREFIX) + w + 1
    rec = np.empty((n, head + rl + 3 + rl + 1), dtype=np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1:1 + len(ID_PREFIX)] = np.frombuffer(ID_PREFIX, np.uint8)
    idx = np.arange(first, pool.size, dtype=np.int64)
    for d in range(w):  # zero-padded decimal, most significant first
        rec[:, head - 2 - d] = ord("0") + (idx // 10 ** d) % 10
    rec[:, head - 1] = ord("\n")
    rec[:, head:head + rl] = seqs[first:]
    rec[:, head + rl:head + rl + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, head + rl + 3:-1] = ord("I")
    rec[:, -1] = ord("\n")
    return rec


def _gzip_members(rec: np.ndarray, parts: int = 8) -> list[bytes]:
    """``rec``'s bytes as consecutive gzip members, compressed at level 1
    in threads (zlib lets go of the GIL); their concatenation is one gzip
    file."""
    def member(chunk: np.ndarray) -> bytes:
        z = zlib.compressobj(1, zlib.DEFLATED, 31)
        return z.compress(chunk.tobytes()) + z.flush()
    chunks = np.array_split(rec, parts)
    with cf.ThreadPoolExecutor(parts) as ex:
        return list(ex.map(member, chunks))


def write_fastq(pool: Pool, out_dir: str, name: str = "pool",
                first: int = 0) -> list[str]:
    """The pool's queries from ``first`` on as gzipped FASTQ, as a
    sequencer delivers a sample: [reads] or [mates 1, mates 2], records
    named by ``Pool.query_id``."""
    first = max(0, min(first, pool.size))
    paths = []
    for m, seqs in enumerate([s for s in (pool.seq1, pool.seq2)
                              if s is not None]):
        path = os.path.join(out_dir, f"{name}.{m + 1}.fq.gz")
        with open(path, "wb") as f:
            for part in _gzip_members(_records(pool, seqs, first)):
                f.write(part)
        paths.append(path)
    return paths
