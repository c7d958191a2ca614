"""The streamer's packing: the joined rows, their lengths, the pinned
buffer and ``pack_rows``: host microseconds a query in the program's
``stream.pack`` spans inside the traced window (``search/stream.py``,
``utils/trace.py``)."""

from harness.program import host_us_per_q, instrument  # noqa: F401


def read(record):
    return host_us_per_q(record, "stream.pack")
