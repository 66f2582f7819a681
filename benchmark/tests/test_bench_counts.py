"""The operation and byte counts of the roofline shares: functions of the
configuration file alone, equal to what `chip_smoke.py`'s formulas
(`eval_flops`, `solve_flops`, `traj_eval_flops`, `traj_solve_flops`) give at
the same shapes, worked out once from the program's own tables and written
here as numbers."""

import json
import os
import subprocess
import sys

from benchmark import harness
from benchmark.drivers.common import data_path
from benchmark.metrics import counts

from .conftest import ROOT

# chip_smoke.py's formulas over the program's tables (franka.yml; the IK
# table world; suite problem 0's three cuboids; the MPC world), operations of
# one configuration's or one trajectory's solve
SMOKE = dict(ik_solve_bench=743687.0, ik_solve_default=7691885.0, traj_solve_plan_p0=522266616.0,
             traj_eval_plan_p0=1518648.0, traj_solve_mpc=122378400.0)


def test_ik_counts_equal_the_smoke_formulas():
    cfg = harness.load_config(ROOT, "franka_ik")
    motion = harness.load_config(ROOT, "franka_motion")
    s = counts.robot_shapes(data_path(cfg, "robot"))
    assert s == counts.Shapes(L=15, n_rev=7, S=65, n_live=61, P=694, D=7, T=1)
    w = counts.World.of(cfg["scene"])
    assert counts.ik_solve_flops(s, w, counts.ik_budget(cfg["ik"])) == SMOKE["ik_solve_bench"]
    assert counts.ik_solve_flops(s, w, counts.ik_budget(motion["planner"]["ik"])) == SMOKE["ik_solve_default"]
    kernel, flops, nbytes = counts.ik_launch(cfg, cfg["ik"], 3200, cfg["scene"])
    assert (kernel, flops) == ("ik_solve_kernel", 3200 * SMOKE["ik_solve_bench"])
    # operations bound it: 35.5 us at 67 TFLOP/s against well under a us of bytes
    assert abs(counts.least_ms(flops, nbytes) - 3200 * 743687.0 / 67e12 * 1e3) < 1e-12


def test_trajectory_counts_equal_the_smoke_formulas():
    from benchmark.drivers.plan import suite_worlds

    motion = harness.load_config(ROOT, "franka_motion")
    with open(data_path(motion, "suite")) as fh:
        worlds = suite_worlds(json.load(fh))
    launches = counts.plan_launches(motion, worlds[0], attempts=1)
    assert [k for k, _, _ in launches] == ["ik_solve_kernel", "traj_solve_kernel", "traj_solve_kernel",
                                           "traj_cost_grad_kernel"]
    assert launches[1][1] == 4 * SMOKE["traj_solve_plan_p0"]
    assert launches[3][1] == SMOKE["traj_eval_plan_p0"]
    retry = counts.plan_launches(motion, worlds[0], attempts=2)[4:]
    assert retry[0][1] == 128 * launches[0][1] / 32 and retry[1][1] == 8 * SMOKE["traj_solve_plan_p0"]
    assert counts.mpc_launch(motion, motion["mpc_scene"])[1] == SMOKE["traj_solve_mpc"]


def test_counts_follow_the_program_defaults_they_assume():
    import curobo_tpu_torch as ct
    from curobo_tpu_torch.ops.traj_kernels import TrajSolveBudget
    from curobo_tpu_torch.util.config_io import dataclass_from_dict

    motion = harness.load_config(ROOT, "franka_motion")
    assert dataclass_from_dict(ct.MotionPlanConfig, motion["planner"]) == ct.MotionPlanConfig()
    assert ct.MPCConfig.from_yaml(data_path(motion, "mpc")) == ct.MPCConfig()
    assert motion["counts"]["traj_linesearch"] == TrajSolveBudget().n_linesearch
    assert motion["counts"]["sweep_steps"] == ct.TrajOptConfig().rollout.collision_cost.sweep_steps
    assert motion["counts"]["sweep_steps"] == ct.MPCConfig().rollout.collision_cost.sweep_steps


def test_the_count_module_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); from benchmark.metrics import counts; "
            "from benchmark import harness; c = harness.load_config(%r, 'franka_ik'); "
            "counts.ik_launch(c, c['ik'], 100, c['scene']); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % (ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    names = set(eval(out.stdout))
    assert not names & {"curobo_tpu_torch", "curobo_tpu", "jax", "jaxlib", "flax"}
    assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", "counts.py"))
