"""The TSV rows' writing: the FPR and string tables,
``native.write_rows``, the decode and the sink's write: host
microseconds a query in the program's ``stream.emit`` spans inside the
traced window (``search/stream.py``, ``utils/trace.py``)."""

from harness.program import host_us_per_q, instrument  # noqa: F401


def read(record):
    return host_us_per_q(record, "stream.emit")
