#!/usr/bin/env python3
"""One run of one benchmark cell of curobo_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload franka_ik.b100 --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. Prints one JSON line last on standard
output (the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics), and each compared number beside its limit last on standard error.
Exits non-zero, printing no result, without the CUDA devices the cell asks
for.
"""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    _age = harness.process_age_s()
    sys.exit(harness.main(t_start=_T0 - (_age if _age is not None else 0.0)))
