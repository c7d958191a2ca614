"""The device tail's dedup of paired rows (``search/dedup.dedup_planes``):
device nanoseconds a query of the kernels launched inside the program's
``tail.dedup`` ranges, over the traced window's queries."""

from harness.program import device_ns_per_query, instrument  # noqa: F401


def read(record):
    return device_ns_per_query(record, "tail.dedup")
