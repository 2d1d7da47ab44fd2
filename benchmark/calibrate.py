"""The readings that a cell's correctness limits are set from (never run
by a benchmark run).

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 ... \
        --control-seeds 11 12 13 --seconds 3 [--out readings.jsonl]

For each seed, one run of the cell with a short window at the cell's own
load (the same calls, pixels and judged calls as a benchmark run of that
seed), in one process: the program's numbers against the plain
reference; for each control seed also the control's, the reference
computed in bfloat16 in the program's place at the same pixels.  One JSON
line a seed.  On the card only, as a run.
"""

import json
import sys
import time

T_START = time.perf_counter()

import os  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import torch  # noqa: E402

from harness import drive, spec  # noqa: E402


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            ctl = torch.bfloat16 if seed in args.control_seeds else None
            r = drive.run_cell(cell, seed, args.seconds, False, t0,
                               control=ctl)
            row = {"workload": cell.name, "seed": seed,
                   "attempted": r["attempted"],
                   "checks": {k: v["value"] for k, v in r["checks"].items()},
                   "control": r.get("control_checks"),
                   "metrics": {k: v["value"]
                               for k, v in r["metrics"].items()},
                   "seconds": time.perf_counter() - t0}
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    except drive.NoDevice as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
