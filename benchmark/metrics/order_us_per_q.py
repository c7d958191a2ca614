"""The streamer's ordering of a result: its unpacking, the slow-row
filter, ``lexsort`` and ``bincount``: host microseconds a query in the
program's ``stream.order`` spans inside the traced window
(``search/stream.py``, ``utils/trace.py``)."""

from harness.program import host_us_per_q, instrument  # noqa: F401


def read(record):
    return host_us_per_q(record, "stream.order")
