"""Readings for the limits of a cell's check: the program's numbers over
many seeds, the control's and the planted faults', in one process.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1 2 3 \\
        [--variants program int8 stale half_batch altered] \\
        [--seconds S] [--out FILE.json]

``program`` runs the cell as the benchmark does (window and all) and,
for a float32 cell, also reads its control, the reference in TF32 in
the program's place, on the same inputs.  ``int8`` is the embed cells'
control, the program's own int8 path (``faults.py``); the faults are
``faults.FAULTS``.  Each reading prints as one JSON line; ``--out``
keeps them all.  The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys
import time

import torch

from port_bench import faults, harness
from port_bench.run import run_cell


def readings(cell, seeds, variants, seconds, device="cuda", overrides=None):
    driver = harness.cell_files(cell)[2]["driver"]
    for seed in seeds:
        for variant in variants:
            hooks = {} if variant == "program" else faults.hooks(driver,
                                                                 variant)
            if variant != "program" and not hooks:
                continue
            start = time.perf_counter()
            result = run_cell(cell, seed, seconds, False, device,
                              t_start=start, hooks=hooks,
                              overrides=overrides)
            row = {"cell": cell, "seed": seed, "variant": variant,
                   "numbers": result["numbers"],
                   "e2e": result["e2e"], "setup_s": result["setup_s"],
                   "info": result["info"]}
            yield row
            if variant == "program" and result.get("control"):
                yield dict(row, variant="control",
                           numbers=result["control"]())
            del result
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--variants", nargs="+", default=["program"])
    parser.add_argument("--seconds", type=float, default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    seconds = args.seconds or harness.benchmark()["run_seconds"]
    rows = []
    for row in readings(args.workload, args.seeds, args.variants, seconds):
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as handle:
            json.dump(rows, handle, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
