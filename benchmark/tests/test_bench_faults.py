"""`correct` comes out false when the timed path is broken underneath, and
for the control: each cell's run driven on the CPU at the CPU sizes
(`conftest.TINY`), past the look for a chip, with one fault planted in the
program, or with the reference computed in bfloat16 in the program's place.

Faults: a solve that returns its state unchanged (IK: the seeds; MPC: the
warm start), half of a batch left out (the other half's answers copied in
its place; IK only, plans and ticks come one at a time), and an answer
altered where it is produced. The cells run on one chip, so no exchange
between chips can be left out.
"""

import dataclasses

import pytest
import torch

from .conftest import run_tiny


def unchanged(orig):
    """The solver's stages skipped: its inputs come back, with their own
    metrics."""
    def solve(tab, world_tabs, goal7, x0, budget, seed=0, noise=None):
        zero = dataclasses.replace(budget, warmup_iters=0, mppi_iters=0, lbfgs_iters=0)
        return orig(tab, world_tabs, goal7, x0, zero, seed, None)
    return solve


def half_batch(orig):
    def solve(*args, **kw):
        out = orig(*args, **kw)
        n = out[0].shape[0]
        return tuple(torch.cat([o[: n // 2], o[: n - n // 2]]) for o in out)
    return solve


def altered_ik(orig):
    def solve(*args, **kw):
        x, *rest = orig(*args, **kw)
        x = x.clone()
        x[:8, 0] += 0.05  # every seed of the batch's first goal
        return (x, *rest)
    return solve


def knots_unchanged(orig):
    """The trajectory solve's knots come back as they went in (its metrics
    are those of the solved knots)."""
    def solve(tt, world_tabs, goal7, x0, *args, **kw):
        _, *rest = orig(tt, world_tabs, goal7, x0, *args, **kw)
        return (x0.clone(), *rest)
    return solve


def test_ik_sound_control_and_faults(tiny_root, monkeypatch):
    from curobo_tpu_torch.ops import ik_kernels

    result, _, run = run_tiny(tiny_root, "franka_ik.b100")
    assert result["correct"], result["checks"]
    assert not all(c.ok for c in run.cell.check(control=True))
    orig = ik_kernels.ik_solve
    for fault, broken in (("unchanged", unchanged), ("half_batch", half_batch), ("altered", altered_ik)):
        monkeypatch.setattr(ik_kernels, "ik_solve", broken(orig))
        result, checks, _ = run_tiny(tiny_root, "franka_ik.b100")
        assert not result["correct"], (fault, result["checks"])
    monkeypatch.setattr(ik_kernels, "ik_solve", orig)


@pytest.mark.parametrize("fault", ["none", "unchanged", "altered"])
def test_plan_control_and_faults(tiny_root, monkeypatch, fault):
    import curobo_tpu_torch as ct
    from curobo_tpu_torch.ops import ik_kernels

    if fault == "unchanged":  # IK returns its seeds: the plans end where they started
        monkeypatch.setattr(ik_kernels, "ik_solve", unchanged(ik_kernels.ik_solve))
    if fault == "altered":  # the terminal waypoint moved after the planner's own check
        plan_pose = ct.MotionPlanner.plan_pose

        def altered(self, *args, **kw):
            res = plan_pose(self, *args, **kw)
            res.solver_trajectory.position[:, -1, 0] += 0.05
            return res
        monkeypatch.setattr(ct.MotionPlanner, "plan_pose", altered)
    result, _, run = run_tiny(tiny_root, "franka_motion.plan")
    if fault == "none":
        assert result["correct"], result["checks"]
        assert not all(c.ok for c in run.cell.check(control=True))
    else:
        assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["none", "unchanged", "altered"])
def test_mpc_control_and_faults(tiny_root, monkeypatch, fault):
    import curobo_tpu_torch as ct
    from curobo_tpu_torch.ops import traj_kernels

    if fault == "unchanged":
        monkeypatch.setattr(traj_kernels, "traj_solve", knots_unchanged(traj_kernels.traj_solve))
    if fault == "altered":  # the command moved after the tick built it from its plan
        step = ct.MPCSolver.step

        def altered(self, *args, **kw):
            res, state = step(self, *args, **kw)
            cmd = dataclasses.replace(res.command, position=res.command.position + 0.05)
            return dataclasses.replace(res, command=cmd), state
        monkeypatch.setattr(ct.MPCSolver, "step", altered)
    result, _, run = run_tiny(tiny_root, "franka_motion.mpc", seconds=1.5)
    checks = {c.name: c for c in run.cell.check(control=False)}
    if fault == "none":
        assert checks["answer_gap"].ok, result["checks"]
        control = {c.name: c for c in run.cell.check(control=True)}
        assert not control["answer_gap"].ok
    else:
        assert not checks["answer_gap"].ok, result["checks"]
