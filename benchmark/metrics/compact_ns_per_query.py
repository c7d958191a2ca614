"""The device tail's compaction (the dense tail's K7',
``device_step.DenseCompaction``; the screened tail's ``compact_mask``,
``splice`` and ``pack_result_split`` in ``screen``): device nanoseconds a
query of the kernels launched inside the program's ``tail.compact``
ranges, over the traced window's queries."""

from harness.program import device_ns_per_query, instrument  # noqa: F401


def read(record):
    return device_ns_per_query(record, "tail.compact")
