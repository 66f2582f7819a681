"""Collision-free batched inverse kinematics solver.

Counterpart of `curobo_tpu/solver/ik.py`, both routes. The kernel route: goal
buffer (7 words per tool frame) -> seeds -> optional LM seed refinement
(`opt/lm.py`, PyTorch) -> one `ik_solve` launch (pose-only warm-up, optional
MPPI, L-BFGS, metrics, all inside the kernel) -> per-problem best-seed
selection. The generic route (`_solve_impl`), taken exactly where the JAX
`solve_pose` leaves its kernel (a goal set, per-tool criteria, a rollout
config the kernel refuses, a world with a voxel grid, ``use_pallas=False``)
and for a robot whose shapes
the kernels do not take (`ik_kernels.robot_takes_kernel`: the G1's 49 dof and
162k pairs), where the JAX package falls back after its kernel fails: the
optional LM refinement
of a larger seed pool cut to the best `n_seeds`, then `mppi_optimize` and
`lbfgs_optimize` over `RobotRollout.evaluate_config`, plain PyTorch with
autograd gradients. Seeds fold into the batch axis. The route is decided
before any launch; a failed kernel build or launch raises and never moves
the solve to the generic route. There is no per-world kernel cache: obstacle
capacities are launch arguments of the kernels.
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
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig, lbfgs_optimize
from curobo_tpu_torch.opt.lm import LMConfig, SeedIK
from curobo_tpu_torch.opt.mppi import MPPIConfig, mppi_optimize
from curobo_tpu_torch.robot.params import KinematicsParams
from curobo_tpu_torch.rollout.robot_rollout import Goal, RobotRollout, RobotRolloutConfig
from curobo_tpu_torch.types.pose import Pose
from curobo_tpu_torch.util.sampling import halton_sequence

BIG = 1.0e8


@dataclasses.dataclass(frozen=True)
class IKConfig:
    n_seeds: int = 32
    # kept for parity of fields with the reference: the JAX package has two
    # generic objectives (blast and RobotRollout), this package one
    # (RobotRollout), which serves whatever the kernel route does not
    use_blast: bool = True
    # the fused `ik_solve` kernel where the goal and config allow it; False
    # takes the generic route always
    use_pallas: bool = True
    use_particle_stage: bool = True
    # gradient (L-BFGS) polish stage; read by the non-kernel route only: as
    # in the reference, the kernel route always runs its L-BFGS stage
    use_gradient_stage: bool = True
    # LM seed-IK warm start: pose-only Levenberg-Marquardt on every seed
    # before the main optimizer (single goals, any tool count)
    use_lm_seed: bool = False
    lm_seed_iters: int = 10
    lm_step_clip: float = 0.5
    # generic route only: LM-refine this many seeds and keep the best n_seeds
    lm_seed_pool: int = 0
    # pose-only (no collision terms) in-kernel L-BFGS stage before
    # MPPI/L-BFGS: seeds land near the pose manifold before the expensive
    # stages, at no extra launch
    warmup_iters: int = 0
    # in-kernel backtracking line-search budget (evals per L-BFGS iter);
    # the candidate ladder is ls_base * ls_ratio**k, k < kernel_linesearch
    kernel_linesearch: int = 6
    kernel_ls_base: float = 1.5
    kernel_ls_ratio: float = 0.45
    mppi: MPPIConfig = MPPIConfig(n_particles=32, n_iters=8, init_std=0.6)
    lbfgs: LBFGSConfig = LBFGSConfig(history=12, n_iters=40)
    # IK treats scene collision as a constraint at contact (activation 0),
    # not a standoff: a nonzero activation pushes goals within `activation`
    # of an obstacle off the pose target.
    rollout: RobotRolloutConfig = RobotRolloutConfig(
        collision_cost=terms.CollisionCostConfig(weight=500.0, activation_distance=0.0)
    )
    position_threshold: float = 0.005
    rotation_threshold: float = 0.05

    @staticmethod
    def from_yaml(path_or_dict) -> "IKConfig":
        from curobo_tpu_torch.util.config_io import dataclass_from_dict, load_yaml

        return dataclass_from_dict(IKConfig, load_yaml(path_or_dict))


@dataclasses.dataclass(frozen=True)
class IKResult:
    """Per-problem best solution + per-seed data for downstream seeding."""

    solution: torch.Tensor  # (B, D)
    success: torch.Tensor  # (B,) bool
    position_error: torch.Tensor  # (B,)
    rotation_error: torch.Tensor  # (B,)
    cost: torch.Tensor  # (B,)
    seed_solutions: torch.Tensor  # (B, S, D) all optimized seeds
    seed_success: torch.Tensor  # (B, S) bool


class IKSolver:
    """Batched collision-aware IK. Build once per (robot, config); the world
    and goals are per-call arguments. ``device=None`` is the CUDA device and
    raises when there is none."""

    def __init__(self, params: KinematicsParams, cfg: IKConfig = IKConfig(), device=None):
        self.device = runtime.resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.rollout = RobotRollout(self.params, cfg.rollout)
        self._ik_cost = self._solve_kernel = None
        # the robot's shapes decide the route once, before any launch: a
        # robot the kernels do not take (the G1: 49 dof, 162k pairs) takes
        # the generic route on every device
        hist = max(cfg.lbfgs.history, ik_kernels.IKSolveBudget.warmup_history)
        self._robot_takes_kernel = ik_kernels.robot_takes_kernel(self.params, hist)
        if self._robot_takes_kernel and cfg.use_pallas and ik_kernels.rollout_config_is_supported(
            cfg.rollout
        ):
            self._build_kernel()
        # Halton seed bank in joint space (host constant, float64 as drawn).
        self._seed_bank = halton_sequence(max(cfg.n_seeds - 1, 1), params.n_dof)
        self._seed_ik = None
        if cfg.use_lm_seed:
            self._seed_ik = SeedIK(
                self.params, LMConfig(n_iters=cfg.lm_seed_iters, step_clip=cfg.lm_step_clip)
            )

    def _build_kernel(self):
        cfg = self.cfg
        self._ik_cost = ik_kernels.IKCost(self.params, cfg.rollout, self.device)
        lb, mp = cfg.lbfgs, cfg.mppi
        self._solve_kernel = self._ik_cost.build_solver(
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
            warmup_iters=cfg.warmup_iters,
            n_linesearch=cfg.kernel_linesearch,
            ls_base=cfg.kernel_ls_base,
            ls_ratio=cfg.kernel_ls_ratio,
        )

    # ------------------------------------------------------------------
    def generate_seeds(
        self, batch: int, seed_state: Optional[torch.Tensor] = None, n: Optional[int] = None
    ) -> torch.Tensor:
        """(B, S, D): seed 0 = retract (or provided state), rest Halton."""
        p = self.params
        S = n if n is not None else self.cfg.n_seeds
        # clamp unbounded (continuous) angular joints to +-pi for seeding
        lo_c, hi_c = p.dof_clip_bounds(angular_cap=np.pi)
        if S - 1 > self._seed_bank.shape[0]:
            self._seed_bank = halton_sequence(S - 1, p.n_dof)
        bank = self._seed_bank[: S - 1].astype(np.float32)
        halton = torch.as_tensor(lo_c + (hi_c - lo_c) * bank, device=self.device)
        first = p.retract_config if seed_state is None else seed_state.to(self.device)
        first = first.expand(batch, p.n_dof)
        rest = halton.expand(batch, S - 1, p.n_dof)
        return torch.cat([first[:, None], rest], dim=1)

    # ------------------------------------------------------------------
    def _use_kernel(self, goal: Goal) -> bool:
        """The JAX `solve_pose`'s conditions for its kernel route, and the
        robot's shapes."""
        return (
            self.cfg.use_pallas
            and self._robot_takes_kernel
            and ik_kernels.goal_takes_kernel(goal)
            and ik_kernels.rollout_config_is_supported(self.cfg.rollout)
        )

    def _lm_warm_start(self, goal_s: Goal, seeds: torch.Tensor):
        """Pose-only LM refinement of every seed (B, S, D) against its goal
        over all tool frames; goal sets pass through. Returns (seeds, LM
        squared residual (B, S) or None)."""
        if self._seed_ik is None:
            return seeds, None
        gp, gq = goal_s.goal_pos, goal_s.goal_quat
        if gp.shape[-3] != 1:
            return seeds, None
        return self._seed_ik._solve(seeds, gp[..., 0, :, :], gq[..., 0, :, :])

    @staticmethod
    def _select(x, cost, pos_err, rot_err, conv) -> IKResult:
        """Per-problem best seed: converged seeds by cost, else by position
        error."""
        B = x.shape[0]
        score = torch.where(conv, cost, BIG + pos_err)
        best = torch.argmin(score, dim=-1)  # (B,)

        def take(a):
            idx = best.reshape((B, 1) + (1,) * (a.ndim - 2)).expand((B, 1) + tuple(a.shape[2:]))
            return torch.gather(a, 1, idx)[:, 0]

        return IKResult(
            solution=take(x),
            success=take(conv),
            position_error=take(pos_err),
            rotation_error=take(rot_err),
            cost=take(cost),
            seed_solutions=x,
            seed_success=conv,
        )

    def _solve_impl(
        self,
        world: world_mod.WorldData,
        goal: Goal,  # batch (B,)
        seeds: torch.Tensor,  # (B, S, D)
        seed: int,
        signs: Optional[torch.Tensor] = None,
    ) -> IKResult:
        """The generic route: the LM refinement (a seed pool larger than
        `n_seeds` is cut to the best `n_seeds` by LM residual), MPPI (signs from
        a generator keyed by `seed`, or the given (B, n_seeds, D) signs), then
        L-BFGS over the generic objective, the metrics, and the best-seed
        selection."""
        cfg = self.cfg
        B, S, D = seeds.shape
        goal_s = goal.tile_seeds(S)
        seeds, lm_cost = self._lm_warm_start(goal_s, seeds)
        if lm_cost is not None and S > cfg.n_seeds:
            S = cfg.n_seeds
            idx = torch.argsort(lm_cost, dim=-1, stable=True)[:, :S]
            seeds = torch.gather(seeds, 1, idx[..., None].expand(B, S, D))
            goal_s = goal.tile_seeds(S)
        lo, hi = (torch.as_tensor(b, device=seeds.device) for b in self.params.dof_clip_bounds())

        def cost(x):  # (B, S, D) with optional leading particle/candidate axes
            return self.rollout.cost_config(world, goal_s, x)

        x = seeds
        if cfg.use_particle_stage:
            gen = torch.Generator(device=seeds.device).manual_seed(seed)
            x, _ = mppi_optimize(cost, x, gen, cfg.mppi, lower=lo, upper=hi, signs=signs)
        if cfg.use_gradient_stage:
            x, _ = lbfgs_optimize(cost, x, cfg.lbfgs, lower=lo, upper=hi)
        with torch.no_grad():
            res = self.rollout.evaluate_config(world, goal_s, x)
        conv = res.converged(cfg.position_threshold, cfg.rotation_threshold)
        return self._select(x, res.cost, res.pos_err, res.rot_err, conv)

    def _solve_impl_kernel(
        self,
        world: world_mod.WorldData,
        goal: Goal,
        seeds: torch.Tensor,  # (B, S, D)
        seed: int,
        noise: Optional[torch.Tensor] = None,
    ) -> IKResult:
        cfg = self.cfg
        B, S, D = seeds.shape
        goal_s = goal.tile_seeds(S)
        seeds, _ = self._lm_warm_start(goal_s, seeds)
        # (B S, 7 T): each tool frame's [position, quaternion] in turn
        T = self.params.n_tools
        goal7 = torch.cat(
            [goal_s.goal_pos[..., 0, :, :], goal_s.goal_quat[..., 0, :, :]], dim=-1
        ).reshape(B * S, T * 7)
        q, c, pe, re, fe = self._solve_kernel(
            goal7.contiguous(), seeds.reshape(B * S, D).contiguous(), seed, world, noise
        )
        x = q.reshape(B, S, D)
        cost = c.reshape(B, S)
        pos_err = pe.reshape(B, S)
        rot_err = re.reshape(B, S)
        feasible = fe.reshape(B, S) > 0.5

        conv = (
            (pos_err <= cfg.position_threshold)
            & (rot_err <= cfg.rotation_threshold)
            & feasible
        )
        return self._select(x, cost, pos_err, rot_err, conv)

    # ------------------------------------------------------------------
    def solve_pose(
        self,
        world: world_mod.WorldData,
        goal_pose: Pose,  # batch (B,) or (B, T); or a prepared Goal
        seed: int = 0,
        seed_state: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> IKResult:
        """Solve batched IK for tool pose goals (a goal set when the pose has
        batch shape (B, G, T)).

        seed: integer key of the MPPI stage's generator. noise: optional
        pre-drawn standard normals (mppi_iters, n_particles, B * n_seeds, D)
        used by the kernel route instead of its generator.
        """
        from curobo_tpu_torch.util.checks import check_joint_config, check_pose_batch

        if isinstance(goal_pose, Goal):
            goal = goal_pose
        else:
            check_pose_batch("goal_pose", goal_pose)
            goal = Goal.from_pose(goal_pose.to(self.device))
        if seed_state is not None:
            seed_state = check_joint_config("seed_state", seed_state, self.params.n_dof)
        if goal.goal_pos.shape[-2] != self.params.n_tools:
            raise ValueError(
                f"goal has {goal.goal_pos.shape[-2]} tool frames, robot has "
                f"{self.params.n_tools}"
            )
        if world.device != self.device:
            raise ValueError(f"world lies on {world.device}, solver on {self.device}")
        n_gen = self.cfg.n_seeds
        if (not self._takes_kernel(world, goal) and self._seed_ik is not None
                and self.cfg.lm_seed_pool > self.cfg.n_seeds):
            n_gen = self.cfg.lm_seed_pool
        seeds = self.generate_seeds(goal.batch, seed_state, n=n_gen)
        return self._solve_seeds(world, goal, seeds, seed, noise)

    def _takes_kernel(self, world: world_mod.WorldData, goal: Goal) -> bool:
        return self._use_kernel(goal) and ik_kernels.world_is_supported(world)

    def _solve_seeds(
        self,
        world: world_mod.WorldData,
        goal: Goal,
        seeds: torch.Tensor,  # (B, S, D)
        seed: int,
        noise: Optional[torch.Tensor] = None,
    ) -> IKResult:
        """One solve from the given seeds on the route `solve_pose` takes
        (`noise` is read by the kernel route only)."""
        if self._takes_kernel(world, goal):
            return self._solve_impl_kernel(world, goal, seeds, seed, noise)
        return self._solve_impl(world, goal, seeds, seed)
