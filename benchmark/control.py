#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card:

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell (its own set-up, window and judge) that
also computes the control, the plain reference in the nearest precision
below the configuration's (every matmul input of the training step, forward
and backward, fp8 instead of bf16), beside the reference in bf16 and the
fault "half of the batch left out". Prints one JSON line a seed with every
number compared, the program's and those readings. The benchmark's own runs
never compute them.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path if p and Path(p).resolve() not in (HERE, ROOT)]

from benchmark.harness import Cell, run_cell, set_caches  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches(ROOT)
    cell = Cell.find(args.workload)
    for i, seed in enumerate(args.seeds):
        r = run_cell(cell, seed, args.seconds, bool(args.trace), control=True, t_start=T_START if i == 0 else None)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"], "checks": r["checks"],
                          "metrics": r["metrics"], "device": r["device"], "notes": r["notes"],
                          "breakdown": r.get("breakdown")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
