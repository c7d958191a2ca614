"""FASTQ parse (``commands/search.iter_queries``, ``seqio/fastx``): host
microseconds a query spent pulling the window's batches from the program's
query iterator."""


def read(record):
    t = record.spans.total("parse")
    return t / record.queries * 1e6 if record.queries and t else None
