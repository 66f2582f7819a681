"""Batch motion planner: fixed-size buckets of problems.

Counterpart of `curobo_tpu/motion/batch_planner.py` (reference
`BatchMotionPlanner`, `motion/motion_planner_batch.py:38`): problems are
planned in buckets of `max_batch_size` (the last padded with copies of its
first problem, so every launch has the same shapes) and the results are
concatenated.
"""

from __future__ import annotations

from typing import List

import torch

from curobo_tpu_torch.geom import world as world_mod
from curobo_tpu_torch.motion.planner import MotionPlanConfig, MotionPlanner, MotionPlanResult
from curobo_tpu_torch.types.pose import Pose
from curobo_tpu_torch.types.state import JointState


def _pad_rows(a: torch.Tensor, n_pad: int) -> torch.Tensor:
    if n_pad == 0:
        return a
    return torch.cat([a, a[:1].expand((n_pad,) + tuple(a.shape[1:]))], dim=0)


def _rows(x, n: int, M: int):
    """The first n rows of every tensor batched on dim 0 (size M)."""
    if isinstance(x, JointState):
        return x._map(lambda a: a[:n])
    if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == M:
        return x[:n]
    return x


class BatchMotionPlanner:
    def __init__(self, params, cfg: MotionPlanConfig = MotionPlanConfig(),
                 max_batch_size: int = 64, device=None):
        self.planner = MotionPlanner(params, cfg, device)
        self.max_batch_size = max_batch_size

    @property
    def cfg(self):
        return self.planner.cfg

    def plan_pose(
        self, world: world_mod.WorldData, goal_poses: Pose, start_state: JointState, seed: int = 0,
    ) -> MotionPlanResult:
        B = goal_poses.position.shape[0]
        M = self.max_batch_size
        chunks: List[MotionPlanResult] = []
        for k, i0 in enumerate(range(0, B, M)):
            n = min(M, B - i0)
            goals = Pose(_pad_rows(goal_poses.position[i0:i0 + n], M - n),
                         _pad_rows(goal_poses.quaternion[i0:i0 + n], M - n))
            start = start_state[i0:i0 + n]._map(
                lambda a: None if a is None else _pad_rows(a, M - n)
            )
            res = self.planner.plan_pose(world, goals, start, seed=seed * 1000 + k)
            chunks.append(MotionPlanResult(**{
                f: _rows(getattr(res, f), n, M) for f in res.__dataclass_fields__
            }))
        if len(chunks) == 1:
            return chunks[0]
        # interpolated horizons may differ between chunks: every JointState
        # field is padded to the longest interpolated trajectory, holding its
        # last state (the reference pads `solver_trajectory` to that horizon too)
        H = max(c.trajectory.position.shape[1] for c in chunks)

        def pad(a):
            return torch.cat([a, a[:, -1:].expand((a.shape[0], H - a.shape[1]) + tuple(a.shape[2:]))], dim=1)

        def cat(field):
            vals = [getattr(c, field) for c in chunks]
            if isinstance(vals[0], JointState):
                vals = [v if v.position.shape[1] == H else v._map(pad) for v in vals]
                return JointState(
                    **{
                        f: (None if getattr(vals[0], f) is None
                            else torch.cat([getattr(v, f) for v in vals], dim=0))
                        for f in ("position", "velocity", "acceleration", "jerk", "dt")
                    },
                    joint_names=vals[0].joint_names,
                )
            if isinstance(vals[0], (float, int)):
                return float(sum(vals))
            return torch.cat(vals, dim=0)

        return MotionPlanResult(**{f: cat(f) for f in MotionPlanResult.__dataclass_fields__})
