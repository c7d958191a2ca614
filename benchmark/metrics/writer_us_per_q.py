"""TSV writer (``kmer/native.write_rows``, ``csrc/host/writer.cpp``, called
by ``search/stream._write_native``): host microseconds a query spent in the
native writer over the window."""


def read(record):
    t = record.spans.total("writer")
    return t / record.queries * 1e6 if record.queries and t else None
