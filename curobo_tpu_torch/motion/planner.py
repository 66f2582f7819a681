"""Motion planner: IK -> seed selection/repair -> trajectory optimization.

Counterpart of `curobo_tpu/motion/planner.py` (reference `MotionPlanner`,
`motion/motion_planner.py:43`, `plan_pose:207`, retry loop
`_plan_pose_single:233`): IK for goal configurations (one `ik_solve` launch),
failed-seed repair from successful ones, trajectory optimization with finetune
rounds (two `traj_solve` launches and one `traj_cost_grad` check per attempt),
control-rate interpolation. An attempt that leaves a problem unsolved is
retried harder: 4x the IK seeds, 8 trajectory seeds and PRM graph seeding.
`plan_cspace` plans to a joint-space goal through `TrajOptSolver.solve_cspace`
(the generic trajectory route).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from curobo_tpu_torch import runtime
from curobo_tpu_torch.geom import world as world_mod
from curobo_tpu_torch.solver.ik import IKConfig, IKSolver
from curobo_tpu_torch.solver.trajopt import TrajOptConfig, TrajOptResult, TrajOptSolver
from curobo_tpu_torch.types.pose import Pose
from curobo_tpu_torch.types.state import JointState


@dataclasses.dataclass(frozen=True)
class MotionPlanConfig:
    ik: IKConfig = IKConfig()
    trajopt: TrajOptConfig = TrajOptConfig()
    n_trajopt_seeds: int = 4
    max_attempts: int = 2
    # attempt index at which PRM graph seeding kicks in (reference
    # `enable_graph_attempt`, `motion_planner.py:233-296`); -1 disables
    enable_graph_attempt: int = 1
    # retry escalation: a retry solves harder, not just differently (IK with
    # retry_ik_seed_scale x the seeds, trajectory optimization over more seeds)
    retry_ik_seed_scale: int = 4
    n_trajopt_seeds_retry: int = 8
    interpolation_dt: float = 0.02
    # interpolate on one horizon, bounded by the trajectory max_dt
    static_interpolation: bool = True


@dataclasses.dataclass(frozen=True)
class MotionPlanResult:
    success: torch.Tensor  # (B,) bool
    trajectory: JointState  # (B, H_interp, D) control-rate interpolated
    solver_trajectory: JointState  # (B, H, D) at solver dt
    motion_time: torch.Tensor  # (B,)
    position_error: torch.Tensor
    rotation_error: torch.Tensor
    ik_success: torch.Tensor
    plan_time: float = 0.0


def _pick(better: torch.Tensor, a, b):
    """Row-wise a where `better` else b, for tensors batched on dim 0 and
    JointStates; anything else keeps b."""
    B = better.shape[0]
    if isinstance(a, JointState):
        fields = {
            f: _pick(better, getattr(a, f), getattr(b, f))
            for f in ("position", "velocity", "acceleration", "jerk", "dt")
        }
        return dataclasses.replace(b, **fields)
    if isinstance(a, torch.Tensor) and a.ndim >= 1 and a.shape[0] == B:
        return torch.where(better.reshape((B,) + (1,) * (a.ndim - 1)), a, b)
    return b


class MotionPlanner:
    """Build once per (robot, config); the world, goals and start states are
    per-call arguments. ``device=None`` is the CUDA device and raises when
    there is none."""

    def __init__(self, params, cfg: MotionPlanConfig = MotionPlanConfig(), device=None):
        self.device = runtime.resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.ik = IKSolver(self.params, cfg.ik, self.device)
        self.ik_retry = self.ik
        if cfg.retry_ik_seed_scale > 1 and cfg.max_attempts > 1:
            self.ik_retry = IKSolver(
                self.params,
                dataclasses.replace(cfg.ik, n_seeds=cfg.ik.n_seeds * cfg.retry_ik_seed_scale),
                self.device,
            )
        self.trajopt = TrajOptSolver(self.params, cfg.trajopt, self.device)
        self._prm = None  # built at the first graph-seeded attempt
        self.last_attempts = 0
        self.last_attribution: dict = {}

    @staticmethod
    def _merge_best(res: TrajOptResult, best: TrajOptResult) -> TrajOptResult:
        better = res.success & (~best.success | (res.motion_time < best.motion_time))
        return TrajOptResult(**{
            f.name: _pick(better, getattr(res, f.name), getattr(best, f.name))
            for f in dataclasses.fields(TrajOptResult)
        })

    def _graph_seed_paths(self, world, q_start, seeds):
        """PRM paths from start to each seed configuration -> (B, S, P, D)
        waypoints (reference `_get_graph_seed_trajectories`,
        `motion_planner.py:386`)."""
        from curobo_tpu_torch.graph.prm import PRMConfig, PRMGraphPlanner

        if self._prm is None:
            self._prm = PRMGraphPlanner(self.params, PRMConfig(n_nodes=256))
        B, S, D = seeds.shape
        flat_goal = seeds.reshape(B * S, D)
        flat_start = q_start[:, None].expand(B, S, D).reshape(B * S, D)
        res = self._prm.plan(world, flat_start, flat_goal)
        return res.paths.reshape(B, S, res.paths.shape[1], D)

    # ------------------------------------------------------------------
    @staticmethod
    def _select_seeds(ik_res, n: int) -> torch.Tensor:
        """(B, n, D) trajectory end-configuration seeds: successful IK seeds
        first, failures repaired with the problem's best solution."""
        sols = ik_res.seed_solutions  # (B, S, D)
        succ = ik_res.seed_success  # (B, S)
        order = torch.argsort((~succ).to(torch.int8), dim=-1, stable=True)  # successes first
        top = order[:, :n]
        seeds = torch.gather(sols, 1, top[..., None].expand(-1, -1, sols.shape[-1]))
        ok = torch.gather(succ, 1, top)
        return torch.where(ok[..., None], seeds, ik_res.solution[:, None, :])

    def _interp_steps(self) -> Optional[int]:
        if not self.cfg.static_interpolation:
            return None
        tcfg = self.cfg.trajopt
        t_max = tcfg.max_dt * (tcfg.bspline.horizon - 1)
        return int(np.ceil(t_max / self.cfg.interpolation_dt)) + 1

    def plan_pose(
        self,
        world: world_mod.WorldData,
        goal_pose: Pose,  # (B,)
        start_state: JointState,  # (B, D)
        seed: int = 0,
        attribute: bool = False,
    ) -> MotionPlanResult:
        """Plan from start_state to tool-pose goals. `seed` keys the IK (and,
        when it is on, the trajectory) MPPI generators; each attempt draws its
        own. attribute=True synchronises the device after every phase and
        records wall-clock ms per phase in `self.last_attribution` (ik /
        seed_select / graph_seed / trajopt / interpolate / merge_sync, summed
        over attempts); the synchronisations make attributed plans slower."""
        cfg = self.cfg
        t0 = time.perf_counter()
        q_start = start_state.position.to(self.device)
        B = q_start.shape[0]
        attr: dict = {}
        sync = attribute and self.device.type == "cuda"
        mark_t = [t0]

        def mark(name):
            if attribute:
                if sync:
                    torch.cuda.synchronize(self.device)
                now = time.perf_counter()
                attr[name] = attr.get(name, 0.0) + (now - mark_t[0]) * 1e3
                mark_t[0] = now

        best: Optional[TrajOptResult] = None
        interp = None
        ik_success = torch.zeros((B,), dtype=torch.bool, device=self.device)
        h_out = self._interp_steps()
        attempt = 0
        for attempt in range(cfg.max_attempts):
            seed_ik = 2 * (seed * cfg.max_attempts + attempt)
            ik_solver = self.ik if attempt == 0 else self.ik_retry
            n_to_seeds = (
                cfg.n_trajopt_seeds if attempt == 0
                else max(cfg.n_trajopt_seeds_retry, cfg.n_trajopt_seeds)
            )
            ik_res = ik_solver.solve_pose(
                world, goal_pose, seed=seed_ik, seed_state=q_start if attempt == 0 else None
            )
            mark("ik_ms")
            ik_success = ik_success | ik_res.success
            seeds = self._select_seeds(ik_res, n_to_seeds)
            mark("seed_select_ms")
            seed_paths = None
            if 0 <= cfg.enable_graph_attempt <= attempt:
                seed_paths = self._graph_seed_paths(world, q_start, seeds)
                mark("graph_seed_ms")
            res = self.trajopt.solve_pose(
                world, goal_pose, q_start, seeds, seed=seed_ik + 1, seed_paths=seed_paths
            )
            mark("trajopt_ms")
            best = res if best is None else self._merge_best(res, best)
            interp = self.trajopt.interpolate(best, q_start, cfg.interpolation_dt, h_out)
            mark("interpolate_ms")
            all_ok = attempt == cfg.max_attempts - 1 or bool(best.success.all())
            mark("merge_sync_ms")
            if all_ok:
                break
        self.last_attempts = attempt + 1
        if attribute:
            attr["attempts"] = attempt + 1
            self.last_attribution = attr
        return MotionPlanResult(
            success=best.success,
            trajectory=interp,
            solver_trajectory=best.trajectory,
            motion_time=best.motion_time,
            position_error=best.position_error,
            rotation_error=best.rotation_error,
            ik_success=ik_success,
            plan_time=time.perf_counter() - t0,
        )

    # ------------------------------------------------------------------
    def plan_grasp(
        self,
        world: world_mod.WorldData,
        grasp_pose: Pose,  # (B,)
        start_state: JointState,
        approach_offset: float = 0.1,
        seed: int = 0,
    ):
        """Two-phase grasp: plan to a pre-grasp pose offset along the grasp
        frame's -z (approach) axis, then a straight, collision-checked
        approach to the grasp pose (reference `plan_grasp`,
        `motion_planner.py:419`).

        Returns (approach_plan: MotionPlanResult, grasp_traj: JointState,
        grasp_success (B,))."""
        from curobo_tpu_torch.collision.robot_scene import RobotSceneCollision
        from curobo_tpu_torch.math import quaternion as qm

        grasp_pose = grasp_pose.to(self.device)
        z = torch.tensor([0.0, 0.0, 1.0], device=self.device).expand_as(grasp_pose.position)
        z_axis = qm.quat_rotate(grasp_pose.quaternion, z)
        pregrasp = Pose(grasp_pose.position - approach_offset * z_axis, grasp_pose.quaternion)
        approach = self.plan_pose(world, pregrasp, start_state, seed=2 * seed)

        # grasp phase: IK at the grasp pose seeded from the pre-grasp end, then
        # a straight c-space approach, validated against the world
        q_pre = approach.solver_trajectory.position[:, -1]
        ik_res = self.ik.solve_pose(world, grasp_pose, seed=2 * seed + 1, seed_state=q_pre)
        H = 12
        alphas = torch.linspace(0.0, 1.0, H, device=self.device)[None, :, None]
        seg = q_pre[:, None] * (1 - alphas) + ik_res.solution[:, None] * alphas
        seg_ok = RobotSceneCollision(self.params).validate_trajectory(world, seg)
        grasp_traj = JointState.from_position(seg, self.params.joint_names)
        success = approach.success & ik_res.success & seg_ok
        return approach, grasp_traj, success

    def plan_cspace(
        self,
        world: world_mod.WorldData,
        goal_state: JointState,  # (B, D)
        start_state: JointState,  # (B, D)
        seed: int = 0,
    ) -> MotionPlanResult:
        """Plan to joint-space goals (reference `plan_cspace`,
        `motion_planner.py:325`): one trajectory optimization, no IK."""
        cfg = self.cfg
        t0 = time.perf_counter()
        q_start = start_state.position.to(self.device)
        res = self.trajopt.solve_cspace(world, goal_state.position.to(self.device), q_start,
                                        seed=seed)
        interp = self.trajopt.interpolate(res, q_start, cfg.interpolation_dt)
        B = q_start.shape[0]
        return MotionPlanResult(
            success=res.success,
            trajectory=interp,
            solver_trajectory=res.trajectory,
            motion_time=res.motion_time,
            position_error=res.position_error,
            rotation_error=res.rotation_error,
            ik_success=torch.ones((B,), dtype=torch.bool, device=self.device),
            plan_time=time.perf_counter() - t0,
        )
