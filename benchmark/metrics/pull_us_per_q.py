"""FASTQ parse as the streamer pulls it (``TorchStreamSearcher.run``'s
``list(islice(...))``): host microseconds a query in the program's
``stream.pull`` spans inside the traced window (``search/stream.py``,
``utils/trace.py``)."""

from harness.program import host_us_per_q, instrument  # noqa: F401


def read(record):
    return host_us_per_q(record, "stream.pull")
