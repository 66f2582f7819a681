#!/usr/bin/env python3
"""The readings that the output check's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload franka_ik.b100 --seconds 5 \
        --seeds 11 12 13 --control-seeds 11 12 13

For each seed, one run of the cell (set-up, a window of `--seconds` at the
cell's own load, the check) prints the numbers that the check compares, as
the program gives them; for each control seed also the same numbers of the
control, the reference computed in bfloat16 in the program's place (see
`reference/checks.py`), which has to come out as not correct. The benchmark's
own runs never run the control. One JSON line a seed; the lines also go to
`--out` where it is given.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    lines = []
    for seed in args.seeds:
        result, checks, run = harness.run_cell(root, args.workload, seed, args.seconds, False, device)
        line = dict(workload=args.workload, seed=seed, calls=run.calls, metrics=result["metrics"],
                    attempted=result["attempted"], failed=result["failed"],
                    correct=result["correct"], program=run.cell.numbers(control=False),
                    latency_ms={q: float(np.percentile(run.latencies, q)) * 1e3
                                for q in (50, 90, 95, 97, 98, 99, 100)},
                    retries=sum(r.get("attempts", 1) > 1 for r in run.cell.records))
        if seed in args.control_seeds:
            line["control"] = run.cell.numbers(control=True)
            line["control_correct"] = all(c.ok for c in run.cell.check(control=True))
        lines.append(json.dumps(line))
        print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
