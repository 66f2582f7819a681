"""Trajectory optimization solver: B-spline knots + swept collision + retiming.

Counterpart of `curobo_tpu/solver/trajopt.py`: seed trajectories (straight
lines to the IK solutions, or graph-planner paths) -> per-seed dt estimate ->
finetune rounds with the per-problem best seed kept -> the best trajectory at
its retimed dt, checked once more -> control-rate interpolation.

Two routes, chosen by the JAX package's conditions (`_use_kernel`). The
kernel route runs each round as one `traj_solve` launch (optional MPPI, L-BFGS
over the free knots, metrics, retimed dt) and the final check as one
`traj_cost_grad` launch in its metrics mode. The generic route (`_solve_seeds`)
serves c-space goals (`solve_cspace`), goal sets, more than one tool, per-tool
criteria, per-axis pose weights, a support polygon, a torque limit, worlds
with a voxel grid and ``use_pallas=False``: `mppi_optimize` and
`lbfgs_optimize` over `RobotRollout.evaluate_trajectory`, plain PyTorch with
autograd gradients. The route is decided before any launch; a failed kernel
build or launch raises and never moves the solve to the generic route. There
is no per-world kernel cache: obstacle capacities are launch arguments and
nothing is built per world.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from curobo_tpu_torch import runtime
from curobo_tpu_torch.cost import terms
from curobo_tpu_torch.geom import world as world_mod
from curobo_tpu_torch.ops import ik_kernels
from curobo_tpu_torch.ops.traj_kernels import TrajCost, traj_config_is_supported
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig, lbfgs_optimize
from curobo_tpu_torch.opt.mppi import MPPIConfig, mppi_optimize
from curobo_tpu_torch.robot import kinematics as kin_mod
from curobo_tpu_torch.robot.params import KinematicsParams
from curobo_tpu_torch.rollout.robot_rollout import Goal, RobotRollout, RobotRolloutConfig
from curobo_tpu_torch.transition.bspline import BSplineConfig, BSplineTransition
from curobo_tpu_torch.types.pose import Pose
from curobo_tpu_torch.types.state import JointState

BIG = 1.0e8


@dataclasses.dataclass(frozen=True)
class TrajOptConfig:
    n_seeds: int = 4
    bspline: BSplineConfig = BSplineConfig(degree=5, n_control=16, horizon=32)
    use_particle_stage: bool = False
    # the fused `traj_solve` kernel where the goal and config allow it; False
    # takes the generic route always
    use_pallas: bool = True
    mppi: MPPIConfig = MPPIConfig(n_particles=16, n_iters=4, init_std=0.1)
    # with pin_goal the terminal pose is exact by construction; L-BFGS only
    # shapes the path (collision, limits, smoothness)
    lbfgs: LBFGSConfig = LBFGSConfig(history=15, n_iters=56, max_step=0.5)
    rollout: RobotRolloutConfig = RobotRolloutConfig(
        pose_cost=terms.PoseCostConfig(position_weight=2000.0, rotation_weight=1000.0),
        bound_cost=terms.BoundCostConfig(
            weight=5000.0, velocity_weight=50.0, acceleration_weight=5.0, jerk_weight=0.05
        ),
        collision_cost=terms.CollisionCostConfig(weight=500.0, activation_distance=0.02),
        self_collision_cost=terms.SelfCollisionCostConfig(weight=2000.0),
        velocity_weight=0.5,
        acceleration_weight=0.05,
        jerk_weight=0.005,
        use_swept_collision=True,
        pose_run_weight=0.0,
    )
    position_threshold: float = 0.005
    rotation_threshold: float = 0.05
    # pin the spline's far end to the seed configuration (the IK solution):
    # the terminal state is exactly the collision-free IK result, at rest
    pin_goal: bool = True
    min_dt: float = 0.005
    max_dt: float = 0.15
    dt_safety: float = 1.2  # margin on the velocity-limit dt estimate
    finetune_attempts: int = 1
    finetune_dt_scale: float = 0.85
    # pose-weight boost for the last finetune round; 1.0 disables the second
    # objective (with pin_goal the terminal pose is exact already)
    finetune_pose_scale: float = 1.0

    @staticmethod
    def from_yaml(path_or_dict) -> "TrajOptConfig":
        from curobo_tpu_torch.util.config_io import dataclass_from_dict, load_yaml

        return dataclass_from_dict(TrajOptConfig, load_yaml(path_or_dict))


@dataclasses.dataclass(frozen=True)
class TrajOptResult:
    """Per-problem best trajectory + metrics."""

    trajectory: JointState  # (B, H, D) at per-problem dt
    success: torch.Tensor  # (B,) bool
    dt: torch.Tensor  # (B,) solver-state step duration
    motion_time: torch.Tensor  # (B,) = dt * (H - 1)
    position_error: torch.Tensor  # (B,)
    rotation_error: torch.Tensor  # (B,)
    cost: torch.Tensor  # (B,)
    free_knots: torch.Tensor  # (B, n_free, D) best spline knots (for resampling)
    # pinned terminal configuration (B, D) when cfg.pin_goal, else None
    q_end: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class SeedSolveOut:
    free_knots: torch.Tensor  # (B, S, n_free, D)
    cost: torch.Tensor  # (B, S)
    feasible: torch.Tensor
    converged: torch.Tensor
    pos_err: torch.Tensor
    rot_err: torch.Tensor
    dt_retimed: torch.Tensor  # (B, S) dt that fits the vel/acc/jerk limits


class TrajOptSolver:
    """Build once per (robot, config); the world, goals and seeds are per-call
    arguments. ``device=None`` is the CUDA device and raises when there is
    none."""

    def __init__(self, params: KinematicsParams, cfg: TrajOptConfig = TrajOptConfig(), device=None):
        self.device = runtime.resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.transition = BSplineTransition(cfg.bspline, device=self.device)
        self._ft_rollout_cfg = self._scaled_rollout_cfg()
        self.rollout = RobotRollout(self.params, cfg.rollout)
        self.rollout_ft = RobotRollout(self.params, self._ft_rollout_cfg)
        self._cost = self._solve_kernel = self._solve_kernel_ft = None
        if cfg.use_pallas and traj_config_is_supported(cfg.rollout):
            self._build_kernels()

    def _scaled_rollout_cfg(self) -> RobotRolloutConfig:
        """Rollout config with the pose weights boosted for the last finetune
        round (1.0 leaves it unchanged)."""
        cfg = self.cfg
        s = cfg.finetune_pose_scale
        if s == 1.0:
            return cfg.rollout
        pc = cfg.rollout.pose_cost
        return dataclasses.replace(
            cfg.rollout,
            pose_cost=dataclasses.replace(
                pc, position_weight=pc.position_weight * s, rotation_weight=pc.rotation_weight * s,
            ),
        )

    def _build_kernels(self):
        cfg = self.cfg
        self._cost = TrajCost(self.params, cfg.rollout, cfg.bspline, cfg.pin_goal, self.device)
        mp, lb = cfg.mppi, cfg.lbfgs
        kernel_opts = dict(
            mppi_iters=mp.n_iters if cfg.use_particle_stage else 0,
            n_particles=mp.n_particles,
            init_std=float(mp.init_std),
            std_decay=mp.std_decay,
            min_std=mp.min_std,
            temperature=mp.temperature,
            step_size=mp.step_size,
            lbfgs_iters=lb.n_iters,
            history=lb.history,
            max_step=lb.max_step,
        )
        self._solve_kernel = self._cost.build_solver(**kernel_opts)
        self._solve_kernel_ft = self._solve_kernel
        if cfg.finetune_pose_scale != 1.0 and cfg.finetune_attempts > 0:
            # a second objective with boosted pose weights for the last round
            # (no MPPI: it polishes warm starts)
            cost_ft = TrajCost(self.params, self._ft_rollout_cfg, cfg.bspline, cfg.pin_goal,
                               self.device)
            self._solve_kernel_ft = cost_ft.build_solver(**{**kernel_opts, "mppi_iters": 0})

    def _use_kernel(self, goal: Goal) -> bool:
        """The JAX `TrajOptSolver._use_pallas` conditions."""
        return (
            self.cfg.use_pallas
            and self.params.n_tools == 1  # the trajectory kernel tracks one tool frame
            and ik_kernels.goal_takes_kernel(goal)
            and traj_config_is_supported(self.cfg.rollout)
        )

    # ------------------------------------------------------------------
    def estimate_dt(self, q_start: torch.Tensor, q_end: torch.Tensor) -> torch.Tensor:
        """Per-problem dt from the velocity- and acceleration-limit time of
        the joint motion (the B-spline's peak velocity exceeds the mean by
        about 1.75x for clamped ends)."""
        cfg = self.cfg
        H = cfg.bspline.horizon
        lim = self.params.joint_limits
        dq = (q_end - q_start).abs()
        t_vel = (dq / lim.velocity).amax(dim=-1) * 1.75
        t_acc = torch.sqrt((6.0 * dq / lim.acceleration).amax(dim=-1))
        T = cfg.dt_safety * torch.maximum(t_vel, t_acc)
        return torch.clamp(T / (H - 1), cfg.min_dt, cfg.max_dt)

    def _retime_dt(self, traj: JointState, dt: torch.Tensor) -> torch.Tensor:
        """Smallest dt under which the (shape-fixed) spline respects limits."""
        lim = self.params.joint_limits
        rv = (traj.velocity.abs() / lim.velocity).amax(dim=(-1, -2))
        ra = (traj.acceleration.abs() / lim.acceleration).amax(dim=(-1, -2))
        rj = (traj.jerk.abs() / lim.jerk).amax(dim=(-1, -2))
        scale = torch.maximum(rv, torch.maximum(torch.sqrt(ra), rj.pow(1.0 / 3.0)))
        return torch.clamp(dt * scale * 1.01, self.cfg.min_dt, self.cfg.max_dt)

    # ------------------------------------------------------------------
    def _solve_seeds(
        self, world, goal: Goal, q_start, free0, dt, seed: int, q_end=None, finetune=False,
        signs: Optional[torch.Tensor] = None,
    ) -> SeedSolveOut:
        """The generic route's round over the B x S seed trajectories: MPPI
        (when on; signs from a generator keyed by `seed`, or the given (B, S,
        n_free * D) signs) and L-BFGS over the generic objective, then its
        metrics and the retimed dt."""
        cfg = self.cfg
        B, S, n_free, D = free0.shape
        goal_s = goal.tile_seeds(S)
        qs = q_start[:, None].expand(B, S, D)
        rollout = self.rollout_ft if finetune else self.rollout

        def traj_of(x):  # (..., B, S, n_free * D) with optional leading axes
            knots = x.reshape(x.shape[:-1] + (n_free, D))
            return self.transition.rollout(knots, qs, dt, q_goal=q_end)

        def cost(x):
            return rollout.evaluate_trajectory(world, goal_s, traj_of(x)).cost

        x = free0.reshape(B, S, n_free * D)
        if cfg.use_particle_stage:
            gen = torch.Generator(device=x.device).manual_seed(seed)
            x, _ = mppi_optimize(cost, x, gen, cfg.mppi, signs=signs)
        x, _ = lbfgs_optimize(cost, x, cfg.lbfgs)
        with torch.no_grad():
            traj = traj_of(x)
            res = rollout.evaluate_trajectory(world, goal_s, traj)
        return SeedSolveOut(
            free_knots=x.reshape(B, S, n_free, D),
            cost=res.cost,
            feasible=res.feasible,
            converged=res.converged(cfg.position_threshold, cfg.rotation_threshold),
            pos_err=res.pos_err,
            rot_err=res.rot_err,
            dt_retimed=self._retime_dt(traj, dt),
        )

    def _solve_seeds_kernel(
        self, world, goal: Goal, q_start, free0, dt, seed: int, q_end=None, finetune=False,
    ) -> SeedSolveOut:
        """One `traj_solve` launch over the B x S seed trajectories."""
        cfg = self.cfg
        B, S, n_free, D = free0.shape
        goal_s = goal.tile_seeds(S)
        goal7 = torch.cat(
            [goal_s.goal_pos[..., 0, 0, :], goal_s.goal_quat[..., 0, 0, :]], dim=-1
        ).reshape(B * S, 7)
        qs = q_start[:, None].expand(B, S, D).reshape(B * S, D)
        solve_kernel = self._solve_kernel_ft if finetune else self._solve_kernel
        x, c, pe, re, fe, dt_ret = solve_kernel(
            goal7.contiguous(), free0.reshape(B * S, n_free * D).contiguous(), qs.contiguous(),
            dt.reshape(B * S).contiguous(), seed, world,
            q_end=None if q_end is None else q_end.reshape(B * S, D).contiguous(),
        )
        pe, re = pe.reshape(B, S), re.reshape(B, S)
        feas = fe.reshape(B, S) > 0.5
        conv = (pe <= cfg.position_threshold) & (re <= cfg.rotation_threshold) & feas
        return SeedSolveOut(
            free_knots=x.reshape(B, S, n_free, D),
            cost=c.reshape(B, S),
            feasible=feas,
            converged=conv,
            pos_err=pe,
            rot_err=re,
            dt_retimed=torch.clamp(dt_ret.reshape(B, S), cfg.min_dt, cfg.max_dt),
        )

    def solve_pose(
        self,
        world: world_mod.WorldData,
        goal_pose: Pose,  # (B,)
        q_start: torch.Tensor,  # (B, D)
        seed_q: torch.Tensor,  # (B, S, D) end configurations (IK solutions)
        seed: int = 0,
        seed_paths: Optional[torch.Tensor] = None,  # (B, S, P, D) waypoint paths
    ) -> TrajOptResult:
        """Plan trajectories from q_start to pose goals, seeded by IK results
        (and optionally by graph-planner waypoint paths). `seed` keys the MPPI
        stage's generator when the particle stage is on."""
        from curobo_tpu_torch.util.checks import check_joint_config, check_pose_batch

        check_pose_batch("goal_pose", goal_pose)
        q_start = check_joint_config("q_start", q_start, self.params.n_dof).to(self.device)
        seed_q = check_joint_config("seed_q", seed_q, self.params.n_dof).to(self.device)
        goal = Goal.from_pose(goal_pose.to(self.device))
        if seed_paths is not None:
            seed_paths = seed_paths.to(self.device)
        return self._solve(world, goal, q_start, seed_q, seed, seed_paths)

    def solve_cspace(
        self,
        world: world_mod.WorldData,
        goal_q: torch.Tensor,  # (B, D)
        q_start: torch.Tensor,  # (B, D)
        seed: int = 0,
    ) -> TrajOptResult:
        """Plan to a joint-space goal: the goal pose is FK of the goal
        configuration (so the pose metrics stay meaningful), the c-space cost
        is added, and the goal configuration is the single seed. Always the
        generic route (the trajectory kernels hold a pose objective only)."""
        from curobo_tpu_torch.util.checks import check_joint_config

        goal_q = check_joint_config("goal_q", goal_q, self.params.n_dof).to(self.device)
        q_start = check_joint_config("q_start", q_start, self.params.n_dof).to(self.device)
        st = kin_mod.compute_kinematics(self.params, goal_q)
        goal = Goal.from_pose(Pose(st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0]))
        goal = dataclasses.replace(goal, goal_cspace=goal_q)
        return self._solve(world, goal, q_start, goal_q[:, None], seed)

    def _solve(self, world, goal, q_start, seed_q, seed, seed_paths=None) -> TrajOptResult:
        if world.device != self.device:
            raise ValueError(f"world lies on {world.device}, solver on {self.device}")
        return self._finetune_impl(world, goal, q_start, seed_q, seed_paths, seed,
                                   self._use_kernel(goal) and ik_kernels.world_is_supported(world))

    # ------------------------------------------------------------------
    def _finetune_impl(self, world, goal, q_start, seed_q, seed_paths, seed,
                       use_kernel: bool) -> TrajOptResult:
        """Seed construction, finetune rounds with the per-problem best-seed
        merge, and the final check of the best trajectory at its retimed dt
        (the kernel's metrics mode, or the generic objective)."""
        cfg = self.cfg
        B, S, D = seed_q.shape
        pin = cfg.pin_goal
        if seed_paths is not None:
            free0 = self.transition.path_seed(seed_paths, q_goal_pinned=pin)
        else:
            free0 = self.transition.linear_seed(
                q_start[:, None].expand(B, S, D), seed_q, q_goal_pinned=pin
            )
        q_end = seed_q if pin else None
        dt = self.estimate_dt(q_start[:, None], seed_q).expand(B, S)
        best = None
        rows = torch.arange(B, device=self.device)
        for attempt in range(cfg.finetune_attempts + 1):
            last = attempt == cfg.finetune_attempts and attempt > 0
            solve = self._solve_seeds_kernel if use_kernel else self._solve_seeds
            out = solve(world, goal, q_start, free0, dt, seed, q_end, finetune=last)
            ok = out.converged
            # candidate score: converged -> motion time, else BIG (+ pos_err)
            mt = out.dt_retimed * (cfg.bspline.horizon - 1)
            score = torch.where(ok, mt, BIG + out.pos_err)
            si = torch.argmin(score, dim=-1)
            cand = {
                "free_knots": out.free_knots[rows, si],
                "dt": out.dt_retimed[rows, si],
                "score": score[rows, si],
                "pos_err": out.pos_err[rows, si],
                "rot_err": out.rot_err[rows, si],
                "cost": out.cost[rows, si],
                "success": ok[rows, si],
            }
            if q_end is not None:
                cand["q_end"] = q_end[rows, si]
            if best is None:
                best = cand
            else:
                better = cand["score"] < best["score"]
                best = {
                    k: torch.where(better.reshape((B,) + (1,) * (v.ndim - 1)), cand[k], v)
                    for k, v in best.items()
                }
            if attempt < cfg.finetune_attempts:
                # warm-start the next round from these solutions, with the
                # retimed dt tightened toward minimum motion time
                free0 = out.free_knots
                dt = torch.clamp(out.dt_retimed * cfg.finetune_dt_scale, cfg.min_dt, cfg.max_dt)

        best_q_end = best.get("q_end")
        traj = self.transition.rollout(
            best["free_knots"], q_start, best["dt"], q_goal=best_q_end,
            joint_names=self.params.joint_names,
        )
        # final check at the retimed dt
        if use_kernel:  # the objective kernel's metrics mode
            goal7 = torch.cat([goal.goal_pos[:, 0, 0], goal.goal_quat[:, 0, 0]], dim=-1)
            cost, pe, re, fe, _ = self._cost.metrics(
                goal7.contiguous(), best["free_knots"].reshape(B, -1).contiguous(),
                q_start.contiguous(), best["dt"].contiguous(), world,
                q_end=None if best_q_end is None else best_q_end.contiguous(),
            )
            feasible = fe > 0.5
        else:
            with torch.no_grad():
                res = self.rollout.evaluate_trajectory(world, goal, traj)
            cost, pe, re, feasible = res.cost, res.pos_err, res.rot_err, res.feasible
        conv = (pe <= cfg.position_threshold) & (re <= cfg.rotation_threshold) & feasible
        return TrajOptResult(
            trajectory=traj,
            success=conv & best["success"],
            dt=best["dt"],
            motion_time=best["dt"] * (cfg.bspline.horizon - 1),
            position_error=pe,
            rotation_error=re,
            cost=cost,
            free_knots=best["free_knots"],
            q_end=best_q_end,
        )

    # ------------------------------------------------------------------
    def interpolate(
        self, result: TrajOptResult, q_start: torch.Tensor, dt_out: float,
        h_out: Optional[int] = None,
    ) -> JointState:
        """Resample the best trajectories to a fixed control rate on one
        horizon (h_out, or the longest motion); times beyond a problem's
        motion time hold its final state. Velocity and acceleration are
        central differences, as in the reference."""
        if h_out is not None:
            H_out = h_out
        else:
            H_out = int(np.ceil(float(result.motion_time.max()) / dt_out)) + 1
        ctrl = self.transition.assemble_control(result.free_knots, q_start, q_goal=result.q_end)
        t = torch.arange(H_out, dtype=torch.float32, device=q_start.device) * dt_out
        t_norm = t / result.motion_time[:, None]
        q = self.transition.evaluate_at(ctrl, result.dt, torch.clamp(t_norm, 0.0, 1.0))
        vel = torch.gradient(q, dim=-2)[0] / dt_out
        acc = torch.gradient(vel, dim=-2)[0] / dt_out
        return JointState(
            position=q, velocity=vel, acceleration=acc,
            dt=torch.full(result.dt.shape, dt_out, device=q.device),
            joint_names=self.params.joint_names,
        )
