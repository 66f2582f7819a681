"""Cost terms: pose (with goal sets) / c-space / bounds / collision.

Counterpart of `curobo_tpu/cost/terms.py`: the config dataclasses (fields and
defaults equal) and the batched term functions of the generic objective
(`rollout/robot_rollout.py:RobotRollout`), written as plain PyTorch so that
autograd gives their gradients. The kernels hold the same terms in
`ops/ik_kernels.py` and `ops/traj_kernels.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from curobo_tpu_torch.geom import world as world_mod
from curobo_tpu_torch.geom.self_collision import self_collision_cost
from curobo_tpu_torch.math import quaternion as qm
from curobo_tpu_torch.robot.params import JointLimits, SelfCollisionParams


@dataclasses.dataclass(frozen=True)
class PoseCostConfig:
    position_weight: float = 50.0
    rotation_weight: float = 30.0
    # Optional per-axis weights (len-3 tuples); None = isotropic.
    position_axis_weight: Optional[Tuple[float, float, float]] = None
    rotation_axis_weight: Optional[Tuple[float, float, float]] = None
    # square-root-of-quadratic (metric-like) vs quadratic accumulation
    quadratic: bool = True


def pose_error(
    tool_pos: torch.Tensor,  # (..., T, 3)
    tool_quat: torch.Tensor,  # (..., T, 4)
    goal_pos: torch.Tensor,  # (..., G, T, 3) goal-set axis G
    goal_quat: torch.Tensor,  # (..., G, T, 4)
    cfg: PoseCostConfig = PoseCostConfig(),
    tool_weight: Optional[torch.Tensor] = None,  # (T, 6) ToolPoseCriteria
    tool_tolerance: Optional[torch.Tensor] = None,  # (T, 2)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (cost (...,), pos_err (...,), rot_err (...,)).

    Goal sets: the weighted cost against each of G goals, the minimum over G;
    pos_err / rot_err are those of the chosen goal, the max over tool frames,
    less the per-tool tolerance where criteria are given.
    """
    dp = goal_pos - tool_pos[..., None, :, :]  # (..., G, T, 3)
    if cfg.position_axis_weight is not None:
        dp = dp * dp.new_tensor(cfg.position_axis_weight)
    if tool_weight is not None:
        dp = dp * tool_weight[..., :, :3]
    pos_err2 = (dp * dp).sum(dim=-1)  # (..., G, T)

    rot_vec = qm.quat_error(goal_quat, tool_quat[..., None, :, :])  # (..., G, T, 3)
    if cfg.rotation_axis_weight is not None:
        rot_vec = rot_vec * rot_vec.new_tensor(cfg.rotation_axis_weight)
    if tool_weight is not None:
        rot_vec = rot_vec * tool_weight[..., :, 3:]
    rot_err2 = (rot_vec * rot_vec).sum(dim=-1)  # (..., G, T)

    if cfg.quadratic:
        per_goal = cfg.position_weight * pos_err2 + cfg.rotation_weight * rot_err2
    else:
        per_goal = cfg.position_weight * torch.sqrt(
            pos_err2.clamp_min(1e-16)
        ) + cfg.rotation_weight * torch.sqrt(rot_err2.clamp_min(1e-16))
    per_goal = per_goal.sum(dim=-1)  # over tool frames -> (..., G)

    cost, best = per_goal.min(dim=-1)  # first minimum, as jnp.argmin
    idx = best[..., None, None].expand(best.shape + (1, pos_err2.shape[-1]))
    pe_t = torch.sqrt(torch.gather(pos_err2, -2, idx))[..., 0, :]  # (..., T)
    re_t = torch.sqrt(torch.gather(rot_err2, -2, idx))[..., 0, :]
    if tool_tolerance is not None:
        pe_t = (pe_t - tool_tolerance[..., :, 0]).clamp_min(0.0)
        re_t = (re_t - tool_tolerance[..., :, 1]).clamp_min(0.0)
    return cost, pe_t.amax(dim=-1), re_t.amax(dim=-1)


@dataclasses.dataclass(frozen=True)
class CSpaceCostConfig:
    weight: float = 50.0


def cspace_error(
    q: torch.Tensor, goal_q: torch.Tensor, joint_weight: torch.Tensor,
    cfg: CSpaceCostConfig = CSpaceCostConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted squared distance to a joint-space goal -> (cost, err)."""
    d = (q - goal_q) * joint_weight
    err2 = (d * d).sum(dim=-1)
    return cfg.weight * err2, torch.sqrt(err2.clamp_min(1e-16))


def null_space_cost(
    q: torch.Tensor, retract_q: torch.Tensor, null_weight: torch.Tensor, weight: float
) -> torch.Tensor:
    d = (q - retract_q) * null_weight
    return weight * (d * d).sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class BoundCostConfig:
    weight: float = 5000.0
    # fraction of the range used as soft margin from each limit
    margin: float = 0.0
    velocity_weight: float = 0.0
    acceleration_weight: float = 0.0
    jerk_weight: float = 0.0


def _hinge2(x: torch.Tensor, limit: torch.Tensor) -> torch.Tensor:
    v = (x.abs() - limit).clamp_min(0.0)
    return (v * v).sum(dim=-1)


def bound_cost(
    position: torch.Tensor,  # (..., D)
    limits: JointLimits,
    cfg: BoundCostConfig,
    velocity: Optional[torch.Tensor] = None,
    acceleration: Optional[torch.Tensor] = None,
    jerk: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Quadratic penalty outside the (optionally margin-shrunk) limits (...)."""
    if cfg.margin != 0.0:
        # guard unbounded joints: margin * inf would poison the whole cost
        rng = limits.upper - limits.lower
        rng = torch.where(torch.isfinite(rng), rng, torch.zeros_like(rng))
        lo = limits.lower + cfg.margin * rng
        hi = limits.upper - cfg.margin * rng
    else:
        lo, hi = limits.lower, limits.upper
    viol = (lo - position).clamp_min(0.0) + (position - hi).clamp_min(0.0)
    c = cfg.weight * (viol * viol).sum(dim=-1)
    if velocity is not None and cfg.velocity_weight > 0:
        c = c + cfg.velocity_weight * _hinge2(velocity, limits.velocity)
    if acceleration is not None and cfg.acceleration_weight > 0:
        c = c + cfg.acceleration_weight * _hinge2(acceleration, limits.acceleration)
    if jerk is not None and cfg.jerk_weight > 0:
        c = c + cfg.jerk_weight * _hinge2(jerk, limits.jerk)
    return c


def bound_violation(
    position: torch.Tensor, limits: JointLimits, eps: float = 0.0
) -> torch.Tensor:
    """True where any joint lies outside its limits by more than eps (...)."""
    return torch.any(
        (position < limits.lower - eps) | (position > limits.upper + eps), dim=-1
    )


@dataclasses.dataclass(frozen=True)
class CollisionCostConfig:
    weight: float = 100.0
    activation_distance: float = 0.025
    # substeps for swept (continuous) collision between horizon steps
    sweep_steps: int = 4
    # motion-aware (speed-metric) scaling of swept cost
    speed_metric: bool = False


def scene_collision_cost(
    world: world_mod.WorldData, spheres: torch.Tensor, cfg: CollisionCostConfig
) -> torch.Tensor:
    """Discrete collision cost summed over robot spheres: (..., S, 4) -> (...)."""
    per = world_mod.collision_cost(world, spheres, cfg.activation_distance)
    return cfg.weight * per.sum(dim=-1)


def swept_scene_collision_cost(
    world: world_mod.WorldData, spheres: torch.Tensor, cfg: CollisionCostConfig
) -> torch.Tensor:
    """Continuous collision along a trajectory: (..., H, S, 4) -> (..., H).

    K = ``cfg.sweep_steps`` samples from step h-1's spheres to step h's (step
    0 against itself), the activated cost averaged over them; optionally
    scaled by the spheres' speed between steps (CHOMP speed metric).
    """
    prev = torch.cat([spheres[..., :1, :, :], spheres[..., :-1, :, :]], dim=-3)
    K = cfg.sweep_steps
    alphas = torch.arange(1, K + 1, dtype=spheres.dtype, device=spheres.device) / K
    # (..., H, K, S, 4)
    interp = (
        prev[..., :, None, :, :] * (1.0 - alphas)[:, None, None]
        + spheres[..., :, None, :, :] * alphas[:, None, None]
    )
    per = world_mod.collision_cost(world, interp, cfg.activation_distance)
    per = per.sum(dim=-2) / K  # mean over samples -> (..., H, S)
    if cfg.speed_metric:
        speed = torch.linalg.vector_norm(spheres[..., :3] - prev[..., :3], dim=-1)
        per = per * (speed + 1e-3)
    return cfg.weight * per.sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class SelfCollisionCostConfig:
    weight: float = 500.0
    activation_distance: float = 0.0


def self_collision_cost_term(
    sc: SelfCollisionParams, spheres: torch.Tensor, cfg: SelfCollisionCostConfig
) -> torch.Tensor:
    return cfg.weight * self_collision_cost(sc, spheres, cfg.activation_distance)
