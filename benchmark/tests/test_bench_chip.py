"""On the card, at each cell's own sizes: the program's answers are correct
and the control's (the reference in bfloat16 in the program's place) are
not, on three seeds, with short windows. Run with
`python -m pytest benchmark/tests -m chip` on a machine with an NVIDIA GPU
(a few minutes); `benchmark/calibrate.py` prints the same readings for a
dozen seeds."""

import pytest

from benchmark import harness

from .conftest import ROOT

CELLS = [("franka_ik.b100", 3.0), ("franka_ik.b1", 3.0), ("franka_motion.plan", 10.0),
         ("franka_motion.mpc", 6.0)]


@pytest.mark.chip
@pytest.mark.parametrize("workload,seconds", CELLS)
def test_program_correct_and_control_not(cuda_device, workload, seconds):
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        result, checks, run = harness.run_cell(ROOT, workload, seed, seconds, False, cuda_device)
        assert result["correct"], (workload, seed, result["checks"])
        assert not all(c.ok for c in run.cell.check(control=True)), (workload, seed)
