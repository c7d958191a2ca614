"""The benchmark harness of kmcp_tpu_torch: one run of one cell.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own (``configs/``, ``traffic/``,
``metrics/``), found by the name that ``BENCHMARK.json`` gives it.
"""
