"""The streamer's process: the share of the traced window's wall that
Python's garbage collector took, from the program's ``gc`` spans
(``utils/trace.py`` hooks ``gc.callbacks`` while tracing)."""

from harness.program import clipped_s, instrument, program, window  # noqa: F401


def read(record):
    prog = program(record)
    if prog is None:
        return None
    return 100.0 * clipped_s(prog.spans, window(record), ("gc",)) / \
        record.window_s
