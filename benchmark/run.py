#!/usr/bin/env python3
"""One run of one cell of the port's benchmark:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(also ``python3 -m benchmark.run ...`` from the repository's root). Prints
the result as one JSON line, last on standard output; the numbers that
decided ``correct`` come last on standard error. Exits non-zero without a
result where there is no card, where the program is missing, or where JAX or
the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# run as a script, Python puts this folder first on the path: its modules
# must not shadow top-level names (``profiling``, ``weights``, ...)
sys.path[:] = [str(ROOT)] + [p for p in sys.path if p and Path(p).resolve() not in (HERE, ROOT)]

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
