"""Run one cell of the kmcp_tpu_torch benchmark once, on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result as one JSON object; the numbers compared with the plain reference
come last on standard error, each beside its limit.  With ``--trace 0``
the metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics.  Exits non-zero with no result when there is no CUDA
card, or when the run has loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "kmcp_tpu")


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN top-level names (the part before the first dot,
    compared whole) among ``modules`` (default: ``sys.modules``)."""
    tops = {name.split(".", 1)[0] for name in (modules or sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else \
        f"nvidia-smi: {res.stderr.strip()}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # caches inside the checkout, at fixed paths (the program's nvcc build
    # is already there: kmcp_tpu_torch/build/)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(HERE, ".cache", sub)
    sys.path.insert(0, ROOT)
    import torch

    from harness.manifest import find_cell

    cell = find_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from harness.window import run

    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    print(f"[bench] card: {card()}", file=sys.stderr, flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"[bench] the run loaded {bad}: no result", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"[bench] check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
