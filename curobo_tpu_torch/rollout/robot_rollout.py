"""Rollout types: goals, cost configuration and result metrics.

Counterpart of `curobo_tpu/rollout/robot_rollout.py`: `Goal`,
`RobotRolloutConfig` (fields and defaults equal) and `RolloutResult`. The
generic objective `RobotRollout.evaluate_*` waits with the non-kernel solver
route; the IK objective lives in `ops/ik_kernels.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from curobo_tpu_torch.cost import terms
from curobo_tpu_torch.types.pose import Pose


@dataclasses.dataclass(frozen=True)
class Goal:
    """Batched optimization goal (pose and/or c-space).

    goal_pos/goal_quat carry a goalset axis G (G=1 for single goals):
    (B, G, T, 3/4) where T = number of tool frames.
    """

    goal_pos: torch.Tensor
    goal_quat: torch.Tensor
    goal_cspace: Optional[torch.Tensor] = None  # (B, D)
    current_position: Optional[torch.Tensor] = None  # (B, D)
    # per-tool criteria: axis weight factors (T, 6) and convergence slack (T, 2)
    tool_weight: Optional[torch.Tensor] = None
    tool_tolerance: Optional[torch.Tensor] = None

    @staticmethod
    def from_pose(pose: Pose, n_tools: int = 1, criteria=None) -> "Goal":
        """Build from a Pose with batch shape (B,), (B, T) or (B, G, T)."""
        if criteria is not None:
            raise NotImplementedError(
                "Goal.from_pose(criteria=...): per-tool pose criteria "
                "(types/tool_pose.py) are not ported yet"
            )
        pos, quat = pose.position, pose.quaternion
        if pos.ndim == 2:  # (B, 3) single tool, single goal
            pos = pos[:, None, None, :]
            quat = quat[:, None, None, :]
        elif pos.ndim == 3:  # (B, T, 3)
            pos = pos[:, None, :, :]
            quat = quat[:, None, :, :]
        return Goal(goal_pos=pos, goal_quat=quat)

    @property
    def batch(self) -> int:
        return self.goal_pos.shape[0]

    def tile_seeds(self, n_seeds: int) -> "Goal":
        """(B, ...) -> (B, S, ...) broadcast over a seed axis. Per-tool
        criteria are batch-free constants and pass through unchanged."""

        def tile(a):
            if a is None:
                return None
            return a[:, None].expand((a.shape[0], n_seeds) + tuple(a.shape[1:]))

        return Goal(
            goal_pos=tile(self.goal_pos),
            goal_quat=tile(self.goal_quat),
            goal_cspace=tile(self.goal_cspace),
            current_position=tile(self.current_position),
            tool_weight=self.tool_weight,
            tool_tolerance=self.tool_tolerance,
        )


@dataclasses.dataclass(frozen=True)
class RobotRolloutConfig:
    """Static cost configuration."""

    pose_cost: terms.PoseCostConfig = terms.PoseCostConfig()
    cspace_cost: terms.CSpaceCostConfig = terms.CSpaceCostConfig()
    bound_cost: terms.BoundCostConfig = terms.BoundCostConfig()
    collision_cost: terms.CollisionCostConfig = terms.CollisionCostConfig()
    self_collision_cost: terms.SelfCollisionCostConfig = terms.SelfCollisionCostConfig()
    null_space_weight: float = 0.0
    # pose cost applied to intermediate horizon steps, scaled by run_weight
    pose_run_weight: float = 0.0
    # smoothness (squared vel/acc/jerk) weights for trajectory objectives
    velocity_weight: float = 0.0
    acceleration_weight: float = 0.0
    jerk_weight: float = 0.0
    use_swept_collision: bool = True
    # humanoid balance (support polygon) penalty; not ported yet, so any
    # value but None is refused by the IK kernels
    support_polygon: Optional[object] = None
    support_hull: Optional[tuple] = None  # ((x, y), ...) CCW
    # inverse-dynamics torque-limit penalty
    torque_limit_weight: float = 0.0
    payload_mass: float = 0.0
    # convergence thresholds (metrics)
    position_threshold: float = 0.005
    rotation_threshold: float = 0.05


@dataclasses.dataclass(frozen=True)
class RolloutResult:
    """Costs + metrics for a batch of candidates."""

    cost: torch.Tensor  # (...,) total
    pos_err: torch.Tensor  # (...,) position error (max over tools)
    rot_err: torch.Tensor  # (...,)
    cspace_err: Optional[torch.Tensor]  # (...,)
    feasible: torch.Tensor  # (...,) bool: bounds + collisions clear
    in_collision: Optional[torch.Tensor] = None  # (...,) bool
    self_colliding: Optional[torch.Tensor] = None  # (...,) bool
    out_of_bounds: Optional[torch.Tensor] = None  # (...,) bool

    @property
    def success(self) -> torch.Tensor:
        return self.feasible

    def converged(self, pos_thresh: float, rot_thresh: float) -> torch.Tensor:
        return (
            (self.pos_err <= pos_thresh)
            & (self.rot_err <= rot_thresh)
            & self.feasible
        )
