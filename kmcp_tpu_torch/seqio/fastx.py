"""FASTA/FASTQ streaming reader + sequence window slider.

The port's copy of kmcp_tpu/seqio/fastx.py (less ``count_records``):
transparent gzip, ID = first whitespace token, and the window generator
used for genome chunking.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterator


@dataclass
class Record:
    id: str
    name: str  # full header line (without '>'/'@')
    seq: bytes
    qual: bytes | None = None


def xopen(path: str | os.PathLike, mode: str = "rb"):
    """Open a file transparently handling gzip (magic-byte sniffing for reads,
    extension for writes)."""
    path = os.fspath(path)
    if "r" in mode:
        f = open(path, "rb")
        magic = f.read(2)
        f.seek(0)
        if magic == b"\x1f\x8b":
            return gzip.open(f, mode)
        if "b" not in mode:
            return io.TextIOWrapper(f)
        return f
    else:
        if str(path).endswith(".gz"):
            return gzip.open(path, mode, compresslevel=5)
        return open(path, mode)


def _first_token(header: bytes) -> str:
    return header.split(None, 1)[0].decode() if header.strip() else ""


def read_fastx(path: str | os.PathLike) -> Iterator[Record]:
    """Yield records from a (gzipped) FASTA or FASTQ file."""
    with xopen(path, "rb") as fh:
        first = fh.read(1)
        if not first:
            return
        rest = fh.read()
    data = first + rest
    if first == b">":
        yield from _parse_fasta(data)
    elif first == b"@":
        yield from _parse_fastq(data)
    else:
        raise ValueError(f"not a FASTA/FASTQ file: {path}")


def _parse_fasta(data: bytes) -> Iterator[Record]:
    # Split on record starts; robust to \r\n.
    for chunk in data.split(b"\n>"):
        chunk = chunk.lstrip(b">")
        if not chunk.strip():
            continue
        nl = chunk.find(b"\n")
        if nl < 0:
            header, body = chunk, b""
        else:
            header, body = chunk[:nl], chunk[nl + 1 :]
        header = header.rstrip(b"\r")
        seq = body.replace(b"\n", b"").replace(b"\r", b"")
        yield Record(id=_first_token(header), name=header.decode(), seq=seq)


def _parse_fastq(data: bytes) -> Iterator[Record]:
    lines = data.split(b"\n")
    i = 0
    n = len(lines)
    while i + 3 < n or (i < n and lines[i].strip()):
        if i + 3 >= n:
            break
        header = lines[i].rstrip(b"\r")
        seq = lines[i + 1].rstrip(b"\r")
        qual = lines[i + 3].rstrip(b"\r")
        if not header.startswith(b"@"):
            raise ValueError("malformed FASTQ record header")
        header = header[1:]
        yield Record(
            id=_first_token(header), name=header.decode(), seq=seq, qual=qual
        )
        i += 4


def slider(
    seq: bytes, window: int, step: int, circular: bool = False, greedy: bool = True
) -> Iterator[tuple[int, bytes]]:
    """Window generator over ``seq``: yields (start, subseq).

    - windows start at 0, step, 2*step, ...
    - ``circular``: a window reaching past the end wraps around to the
      beginning; iteration stops once the start position reaches len(seq).
    - ``greedy`` (non-circular): the trailing window(s) shorter than
      ``window`` are still yielded; iteration stops after the first window
      that reaches the end of the sequence.
    - non-greedy, non-circular: only full-length windows are yielded.
    """
    L = len(seq)
    if L == 0 or window <= 0 or step <= 0:
        return
    start = 0
    while start < L:
        end = start + window
        if end <= L:
            yield start, seq[start:end]
            if end == L and not circular:
                return
        elif circular:
            yield start, seq[start:] + seq[: end - L]
        elif greedy:
            yield start, seq[start:]
            return
        else:
            return
        start += step


def concat_with_ns(seqs: list[bytes], k_max: int) -> bytes:
    """Concatenate sequences with k-1 'N' separators."""
    if not seqs:
        return b""
    if len(seqs) == 1:
        return seqs[0]
    sep = b"N" * (k_max - 1)
    return sep.join(seqs)


def split_chunk_size(
    seq_len: int, split_number: int, overlap: int, circular: bool
) -> tuple[int, int]:
    """Chunk size + step for split-by-number mode."""
    if circular:
        size = (seq_len + split_number * overlap + split_number - 1) // split_number
    else:
        size = (seq_len + (split_number - 1) * overlap + split_number - 1) // split_number
    return size, size - overlap
