"""The device tail's result: bytes a query copied from the card to the
host in the traced window, the program's ``d2h_bytes`` counter (the
result tensors' sizes, counted in ``device._copy_async``)."""

from harness.program import instrument, program  # noqa: F401


def read(record):
    prog = program(record)
    if prog is None or "d2h_bytes" not in prog.counters:
        return None
    return prog.counters["d2h_bytes"] / record.queries
