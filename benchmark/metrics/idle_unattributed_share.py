"""The device: the share of the card's idle time between the trace's two
marks that no program span covers (``record.trace.gaps`` against the
program's spans, both on perf_counter seconds): idle time the program's
own tracing cannot explain."""

from harness.program import analyse, instrument  # noqa: F401


def read(record):
    found = analyse(record)
    if found is None or found["idle_s"] <= 0:
        return None
    return 100.0 * found["idle_uncovered_s"] / found["idle_s"]
