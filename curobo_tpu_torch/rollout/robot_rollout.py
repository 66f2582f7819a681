"""Robot rollout: goals, cost configuration, and the generic objective.

Counterpart of `curobo_tpu/rollout/robot_rollout.py`: `Goal`,
`RobotRolloutConfig` (fields and defaults equal), `RolloutResult`, and
`RobotRollout.evaluate_config` / `evaluate_trajectory`, the objective of the
non-kernel route (goal sets, c-space goals, per-tool criteria, configurations
the kernels refuse). It is plain PyTorch over `cost/terms.py` on purpose: the
JAX package runs this route as XLA, with no Pallas kernel, and its gradient
comes from autograd. Objectives take arbitrary leading batch axes; a
trajectory adds a horizon axis before the dof: (..., H, D).

The JAX package also has a B-last form of this objective (`ops/blast.py`); the
port has this one, which the tests hold against both. `cost_config` is the
cost of `evaluate_config` without its metrics, for the optimizers, which read
only the cost. The support-polygon term needs the hull baked into the config
(`cost/support_polygon.py:configure_rollout`). The torque-limit term runs the
RNEA of `robot/dynamics.py` over the trajectory, with the payload added to the
last link's mass. The `_env` variants route each problem to its own world of a
`stack_worlds` stack: the problems are grouped by world, each group is one
single-world call, and the results are put back in the problems' order (the
JAX package gathers and `vmap`s; the pair kernels of the self-collision sum
are launches inside an `autograd.Function`, which `vmap` cannot enter).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from curobo_tpu_torch.cost import support_polygon as sp_mod
from curobo_tpu_torch.cost import terms
from curobo_tpu_torch.geom import world as world_mod
from curobo_tpu_torch.geom.self_collision import self_collision_distance
from curobo_tpu_torch.robot import kinematics as kin_mod
from curobo_tpu_torch.robot.dynamics import compute_inverse_dynamics
from curobo_tpu_torch.robot.params import KinematicsParams
from curobo_tpu_torch.types.pose import Pose
from curobo_tpu_torch.types.state import JointState


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
        """Build from a Pose with batch shape (B,), (B, T) or (B, G, T).

        criteria: optional sequence of `ToolPoseCriteria`, one per tool frame."""
        pos, quat = pose.position, pose.quaternion
        if pos.ndim == 2:  # (B, 3) single tool, single goal
            pos = pos[:, None, None, :]
            quat = quat[:, None, None, :]
        elif pos.ndim == 3:  # (B, T, 3)
            pos = pos[:, None, :, :]
            quat = quat[:, None, :, :]
        tw = tt = None
        if criteria is not None:
            from curobo_tpu_torch.types.tool_pose import stack_criteria

            tw, tt = stack_criteria(criteria, device=pos.device)
        return Goal(goal_pos=pos, goal_quat=quat, tool_weight=tw, tool_tolerance=tt)

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
    # humanoid balance: centre-of-mass-inside-support-polygon penalty over
    # the hull baked by `cost.support_polygon.configure_rollout`; the
    # kernels refuse any value but None
    support_polygon: Optional[sp_mod.SupportPolygonConfig] = None
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


def _goal_rows(goal: Goal, rows: torch.Tensor) -> Goal:
    """The goals of problems `rows`; per-tool criteria are batch-free and pass
    through."""
    def take(a):
        return None if a is None else a[rows]

    return dataclasses.replace(
        goal, goal_pos=take(goal.goal_pos), goal_quat=take(goal.goal_quat),
        goal_cspace=take(goal.goal_cspace), current_position=take(goal.current_position),
    )


@functools.lru_cache(maxsize=8)
def _hull_tensor(hull: tuple, device: torch.device) -> torch.Tensor:
    """The baked hull as a (V, 2) tensor on `device`, copied there once."""
    return torch.tensor(hull, dtype=torch.float32, device=device)


def _support_polygon_cost(p: KinematicsParams, cfg: RobotRolloutConfig, state):
    """The balance term (...,) of FK state `state`, or None when it is off."""
    sp = cfg.support_polygon
    if sp is None or sp.weight <= 0:
        return None
    if cfg.support_hull is None:
        raise ValueError(
            "RobotRollout: the support-polygon term needs a hull; build the config with "
            "cost.support_polygon.configure_rollout(cfg, params, q_stance)"
        )
    com = kin_mod.compute_com(p, state.link_rot, state.link_pos)
    hull = _hull_tensor(cfg.support_hull, com.device)
    return sp_mod.support_polygon_cost(com[..., :2], hull, sp)


class RobotRollout:
    """Objective factory for a (robot, cost-config) pair; the world and goal
    are per-call arguments."""

    def __init__(self, params: KinematicsParams, cfg: RobotRolloutConfig):
        self.params = params
        self.cfg = cfg
        # the torque term's model: the payload sits at the last link's CoM
        self._dyn_params = params
        if cfg.payload_mass > 0.0:
            mass = params.link_mass.clone()
            mass[params.n_links - 1] += cfg.payload_mass
            self._dyn_params = dataclasses.replace(params, link_mass=mass)

    # -- single-state objective (IK) ------------------------------------
    def _config_cost(self, world, goal: Goal, q: torch.Tensor):
        """(FK state, cost, pos_err, rot_err, cspace_err) of configurations q."""
        p, cfg = self.params, self.cfg
        state = kin_mod.compute_kinematics(p, q)
        cost, pos_err, rot_err = terms.pose_error(
            state.tool_pose.position, state.tool_pose.quaternion,
            goal.goal_pos, goal.goal_quat, cfg.pose_cost,
            tool_weight=goal.tool_weight, tool_tolerance=goal.tool_tolerance,
        )
        cspace_err = None
        if goal.goal_cspace is not None:
            cs_c, cspace_err = terms.cspace_error(
                q, goal.goal_cspace, p.cspace_weight, cfg.cspace_cost
            )
            cost = cost + cs_c
        if cfg.null_space_weight > 0.0:
            cost = cost + terms.null_space_cost(
                q, p.retract_config, p.null_space_weight, cfg.null_space_weight
            )
        cost = cost + terms.bound_cost(q, p.joint_limits, cfg.bound_cost)
        cost = cost + terms.scene_collision_cost(world, state.spheres, cfg.collision_cost)
        cost = cost + terms.self_collision_cost_term(
            p.self_collision, state.spheres, cfg.self_collision_cost
        )
        spc = _support_polygon_cost(p, cfg, state)
        if spc is not None:
            cost = cost + spc
        return state, cost, pos_err, rot_err, cspace_err

    def cost_config(
        self, world: world_mod.WorldData, goal: Goal, q: torch.Tensor
    ) -> torch.Tensor:
        """The cost (...,) of `evaluate_config`, without its metrics."""
        return self._config_cost(world, goal, q)[1]

    def evaluate_config(
        self,
        world: world_mod.WorldData,
        goal: Goal,
        q: torch.Tensor,  # (..., D)
        collision_eps: float = 0.0,
    ) -> RolloutResult:
        p = self.params
        state, cost, pos_err, rot_err, cspace_err = self._config_cost(world, goal, q)

        # metrics / feasibility (no activation margin)
        live = state.spheres[..., 3] >= 0
        clearance = world_mod.sphere_clearance(world, state.spheres)
        in_collision = torch.any((clearance < -collision_eps) & live, dim=-1)
        self_colliding = self_collision_distance(p.self_collision, state.spheres) > collision_eps
        oob = terms.bound_violation(q, p.joint_limits, eps=1e-4)
        return RolloutResult(
            cost=cost, pos_err=pos_err, rot_err=rot_err, cspace_err=cspace_err,
            feasible=~(in_collision | self_colliding | oob), in_collision=in_collision,
            self_colliding=self_colliding, out_of_bounds=oob,
        )

    # -- multi-environment variants (reference SolveMode.MULTI_ENV) -------
    def _per_env(self, worlds: world_mod.WorldData, env_idx, batch: int, fn) -> RolloutResult:
        """fn(world, rows) over each world's problems of a `stack_worlds`
        stack, the results put back in the problems' order. The routing is
        read to the host once."""
        env = torch.as_tensor(env_idx).detach().cpu().long().reshape(-1)
        n_env = worlds.cuboids.pos.shape[0]
        if env.shape[0] != batch:
            raise ValueError(f"env_idx has {env.shape[0]} entries for {batch} problems")
        if bool(((env < 0) | (env >= n_env)).any()):
            raise IndexError(f"env_idx outside the {n_env} stacked worlds")
        dev = self.params.device
        rows_of, parts = [], []
        for e in torch.unique(env).tolist():
            rows = torch.nonzero(env == e)[:, 0]
            rows_of.append(rows)
            parts.append(fn(world_mod.world_at(worlds, e), rows.to(dev)))
        inv = torch.argsort(torch.cat(rows_of)).to(dev)

        def merge(name):
            vals = [getattr(r, name) for r in parts]
            return None if vals[0] is None else torch.cat(vals, dim=0)[inv]

        return RolloutResult(**{f.name: merge(f.name) for f in dataclasses.fields(RolloutResult)})

    def evaluate_config_env(
        self,
        worlds: world_mod.WorldData,  # tables stacked (E, ...) by `stack_worlds`
        env_idx,  # (B,) int: the world of each problem
        goal: Goal,  # (B, ...)
        q: torch.Tensor,  # (B, ..., D)
        collision_eps: float = 0.0,
    ) -> RolloutResult:
        """`evaluate_config` with each problem in its own world; equal to the
        single-world calls on each world's problems."""
        return self._per_env(worlds, env_idx, q.shape[0], lambda w, rows: self.evaluate_config(
            w, _goal_rows(goal, rows), q[rows], collision_eps))

    def evaluate_trajectory_env(
        self,
        worlds: world_mod.WorldData,
        env_idx,
        goal: Goal,
        traj: JointState,  # tensors (B, ..., H, D)
        collision_eps: float = 0.0,
    ) -> RolloutResult:
        """`evaluate_trajectory` with each problem in its own world."""

        def rows_of(rows):
            t = traj[rows]
            if traj.dt is not None and traj.dt.ndim > 0:
                t = dataclasses.replace(t, dt=traj.dt[rows])
            return t

        return self._per_env(worlds, env_idx, traj.position.shape[0],
                             lambda w, rows: self.evaluate_trajectory(
                                 w, _goal_rows(goal, rows), rows_of(rows), collision_eps))

    # -- trajectory objective (trajopt / MPC) ---------------------------
    def evaluate_trajectory(
        self,
        world: world_mod.WorldData,
        goal: Goal,
        traj: JointState,  # tensors (..., H, D)
        collision_eps: float = 0.0,
    ) -> RolloutResult:
        p, cfg = self.params, self.cfg
        q = traj.position
        state = kin_mod.compute_kinematics(p, q)  # (..., H, ...)

        # terminal pose cost (+ optional run weight on intermediate steps)
        pose_all, pos_err_all, rot_err_all = terms.pose_error(
            state.tool_pose.position, state.tool_pose.quaternion,
            goal.goal_pos[..., None, :, :, :], goal.goal_quat[..., None, :, :, :],
            cfg.pose_cost,
            tool_weight=goal.tool_weight, tool_tolerance=goal.tool_tolerance,
        )
        cost = pose_all[..., -1]
        if cfg.pose_run_weight > 0.0:
            cost = cost + cfg.pose_run_weight * pose_all[..., :-1].mean(dim=-1)
        pos_err = pos_err_all[..., -1]
        rot_err = rot_err_all[..., -1]

        cspace_err = None
        if goal.goal_cspace is not None:
            cs_c, cs_err_all = terms.cspace_error(
                q, goal.goal_cspace[..., None, :], p.cspace_weight, cfg.cspace_cost
            )
            cost = cost + cs_c[..., -1]
            cspace_err = cs_err_all[..., -1]

        # bounds over the whole trajectory (incl. derivatives)
        bc = terms.bound_cost(
            q, p.joint_limits, cfg.bound_cost,
            velocity=traj.velocity, acceleration=traj.acceleration, jerk=traj.jerk,
        )
        cost = cost + bc.sum(dim=-1)

        # smoothness
        for w, x in ((cfg.velocity_weight, traj.velocity),
                     (cfg.acceleration_weight, traj.acceleration),
                     (cfg.jerk_weight, traj.jerk)):
            if w > 0.0 and x is not None:
                cost = cost + w * (x * x).sum(dim=-1).mean(dim=-1)

        # inverse-dynamics torque limits (RNEA over the trajectory); the
        # effort is inf where the robot's YAML gives none, and adds 0 there
        if cfg.torque_limit_weight > 0.0 and traj.velocity is not None:
            tau = compute_inverse_dynamics(self._dyn_params, q, traj.velocity, traj.acceleration)
            over = (tau.abs() - p.joint_limits.effort).clamp_min(0.0)
            cost = cost + cfg.torque_limit_weight * (over * over).sum(dim=-1).sum(dim=-1)

        # collisions
        if cfg.use_swept_collision:
            cc = terms.swept_scene_collision_cost(world, state.spheres, cfg.collision_cost)
        else:
            cc = terms.scene_collision_cost(world, state.spheres, cfg.collision_cost)
        cost = cost + cc.sum(dim=-1)
        sc = terms.self_collision_cost_term(
            p.self_collision, state.spheres, cfg.self_collision_cost
        )
        cost = cost + sc.sum(dim=-1)
        spc = _support_polygon_cost(p, cfg, state)  # (..., H)
        if spc is not None:
            cost = cost + spc.sum(dim=-1)

        # feasibility over every step
        live = state.spheres[..., 3] >= 0
        clearance = world_mod.sphere_clearance(world, state.spheres)
        in_collision = torch.any(torch.any((clearance < -collision_eps) & live, dim=-1), dim=-1)
        self_d = self_collision_distance(p.self_collision, state.spheres)
        self_colliding = torch.any(self_d > collision_eps, dim=-1)
        oob = torch.any(terms.bound_violation(q, p.joint_limits, eps=1e-4), dim=-1)
        return RolloutResult(
            cost=cost, pos_err=pos_err, rot_err=rot_err, cspace_err=cspace_err,
            feasible=~(in_collision | self_colliding | oob), in_collision=in_collision,
            self_colliding=self_colliding, out_of_bounds=oob,
        )
