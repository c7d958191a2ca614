"""The device tail's compaction (``device_step.compact_candidates``,
``splice``, ``pack_result``; ``screen.pass2_fixed``): device nanoseconds
a query of the kernels launched inside the program's ``tail.compact``
ranges, over the traced window's queries."""

from harness.program import device_ns_per_query, instrument  # noqa: F401


def read(record):
    return device_ns_per_query(record, "tail.compact")
