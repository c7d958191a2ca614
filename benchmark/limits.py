"""The control's readings, from which the comparison's limit is set: for
each seed, how many of a run's sampled queries the control gets wrong.
The control is the plain reference put in the program's place with one
guarantee of the configuration broken (``harness.reference.CONTROLS``:
reads hashed on their forward strand only, or counts kept in 8 bits).  The
program's own readings are those of its runs (``run.py``).

    python3 benchmark/limits.py --workload <cell> --seeds 1,2,3 \
        [--seconds 10] [--controls forward_strand,counts_u8] \
        [--device cuda]

Needs no DB and no program: the reference rebuilds the DB's bits from the
configuration's genomes.  Prints one JSON line a (seed, control).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def readings(cell, seeds, controls, device, seconds) -> list:
    import torch

    from harness import compare
    from harness.genomes import genome_codes
    from harness.reference import Reference
    from harness.traffic import make_pool, pool_size

    codes = genome_codes(cell.config)
    t = time.perf_counter()
    ref = Reference(cell.config, codes, torch.device(device))
    build_s = time.perf_counter() - t
    out = []
    for seed in seeds:
        pool = make_pool(cell.traffic, cell.config, codes, seed,
                         pool_size(cell.traffic, seconds))
        # a run's sample, as if its window took the whole pool
        wanted = compare.draw_sample(seed, pool.size)
        queries = compare.sample_queries(pool, wanted)
        t = time.perf_counter()
        want = ref.rows(queries)
        ref_s = time.perf_counter() - t
        for control in controls:
            got = dict(zip(wanted.tolist(), ref.rows(queries, control)))
            bad, examples = compare.mismatches(got, want, queries)
            out.append({"workload": cell.name, "seed": seed,
                        "control": control, "queries_compared": len(queries),
                        "queries_differ": bad,
                        "limit": compare.MISMATCH_LIMIT,
                        "correct": bad <= compare.MISMATCH_LIMIT,
                        "reference_build_s": build_s,
                        "reference_rows_s": ref_s,
                        "example": examples[:1]})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="forward_strand,counts_u8")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))
    from harness.manifest import find_cell

    cell = find_cell(args.workload, os.path.dirname(HERE))
    for r in readings(cell, [int(s) for s in args.seeds.split(",")],
                      args.controls.split(","), args.device,
                      args.seconds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
