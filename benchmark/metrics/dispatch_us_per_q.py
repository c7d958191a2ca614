"""The streamer's dispatch: the uploads and the launches of K1', the
tail and the result's copy: host microseconds a query in the program's
``stream.dispatch`` spans inside the traced window
(``search/stream.py``, ``utils/trace.py``)."""

from harness.program import host_us_per_q, instrument  # noqa: F401


def read(record):
    return host_us_per_q(record, "stream.dispatch")
