"""The comparison that decides ``correct``: the TSV rows the window wrote
for a sample of its queries against the plain reference's rows for the
same queries, byte for byte.  The limit is 0 queries that differ."""

from __future__ import annotations

import numpy as np

from .traffic import Pool, rng_for

SAMPLE = 8192  # queries compared a run, drawn from the seed
MISMATCH_LIMIT = 0


class Sink:
    """The file object the streamer writes its TSV text to: it counts the
    characters and keeps the text, so that the sample's rows can be read
    after the window; nothing goes to disk."""

    def __init__(self, keep: bool = True):
        self.chars = 0
        self.keep = keep
        self.parts: list[str] = []

    def write(self, text: str) -> int:
        self.chars += len(text)
        if self.keep:
            self.parts.append(text)
        return len(text)


def draw_sample(seed: int, total: int, size: int = SAMPLE) -> np.ndarray:
    """Sorted queryIdx values of the window's queries to compare."""
    rng = rng_for(seed, 1)
    return np.sort(rng.choice(total, size=min(size, total), replace=False))


def rows_by_query(sink: Sink, wanted: np.ndarray) -> tuple[dict, int]:
    """({queryIdx: [rows]} of the wanted queries, rows whose queryIdx is
    out of order or out of range).  Rows of one query are contiguous and
    queryIdx never decreases, as the streamer writes them."""
    want = set(wanted.tolist())
    out: dict[int, list[str]] = {q: [] for q in want}
    bad, last = 0, -1
    for part in sink.parts:
        for line in part.splitlines():
            idx = int(line[line.rfind("\t") + 1:])
            if idx < last:
                bad += 1
            last = idx
            if idx in want:
                out[idx].append(line)
    return out, bad


def sample_queries(pool: Pool, wanted: np.ndarray) -> list:
    """(query id, seq1, seq2, queryIdx) of the wanted queries: queryIdx
    ``i`` is the pool's query ``i``."""
    out = []
    for i in wanted.tolist():
        s2 = None if pool.seq2 is None else pool.seq2[i].tobytes()
        out.append((pool.query_id(i), pool.seq1[i].tobytes(), s2, i))
    return out


def mismatches(got: dict, want: list, queries: list) -> tuple[int, list]:
    """(queries whose rows differ, up to 3 examples)."""
    bad, examples = 0, []
    for q, rows in zip(queries, want):
        if got.get(q[3], []) != rows:
            bad += 1
            if len(examples) < 3:
                examples.append({"queryIdx": q[3], "program": got.get(q[3]),
                                 "reference": rows})
    return bad, examples
