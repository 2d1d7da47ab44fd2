"""The benchmark of `rtw_tpu_torch` on one H100: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device` (and with
`--trace 1` a `breakdown`), and `checks` last: each number compared
against the plain reference beside its limit, which are also the last
lines of standard error.  Without the cards the cell asks for it exits 3
and prints no result; with JAX or the JAX package loaded, 4.  See
`harness/drive.py` for the order of a run.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# the checkout's root holds the program (rtw_tpu_torch); the benchmark's
# folder, first, holds the harness and the plain reference
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

from harness import drive  # noqa: E402

if __name__ == "__main__":
    sys.exit(drive.main(sys.argv[1:], T_START))
