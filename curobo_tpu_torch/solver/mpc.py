"""Model-predictive control: a warm-started receding-horizon trajectory solve
per control tick.

Counterpart of `curobo_tpu/solver/mpc.py` (reference `MPCSolver`,
`solver_mpc.py:33`): state filter, one trajectory optimisation over the free
B-spline knots per tick, a feasibility mask with a braking fallback, the next
command, and the knots carried to the next tick as its warm start.

Two routes, chosen by the JAX package's conditions (`_use_kernel`):

- the kernel route (`_step_impl_kernel`): the whole tick's optimisation (MPPI
  with the STOMP-smoothed noise, L-BFGS, metrics) is one `traj_solve` launch,
  then the B-spline rollout of the plan;
- the generic route (`_step_impl`), for c-space goals, goal sets, per-tool
  criteria, configurations the kernel refuses (a torque limit among them)
  and worlds with a voxel grid: `mppi_optimize` and `lbfgs_optimize` over
  `RobotRollout.evaluate_trajectory`.

Both end in `_finish_step`, which stays on the device: the feasibility test,
the brake fallback (`torch.where`), the command and the warm start read no
tensor back. The JAX PRNG key of the state becomes a host integer seed and a
tick counter: tick t draws its noise from the generator keyed by (seed, t).
`run_ticks` drives T ticks over a `stack_worlds` stack (the measured state fed
back from the previous command) with no host synchronisation until the caller
reads the stacked results. A failed kernel build or launch raises; nothing
falls back to the generic route.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from curobo_tpu_torch import runtime
from curobo_tpu_torch.cost import terms
from curobo_tpu_torch.geom import world as world_mod
from curobo_tpu_torch.ops import ik_kernels
from curobo_tpu_torch.ops.traj_kernels import TrajCost, traj_config_is_supported
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig, lbfgs_optimize
from curobo_tpu_torch.opt.mppi import MPPIConfig, mppi_optimize, smooth_sample_transform
from curobo_tpu_torch.robot.params import KinematicsParams
from curobo_tpu_torch.rollout.robot_rollout import Goal, RobotRollout, RobotRolloutConfig
from curobo_tpu_torch.transition.bspline import BSplineConfig, BSplineTransition
from curobo_tpu_torch.types.pose import Pose
from curobo_tpu_torch.types.state import JointState


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    bspline: BSplineConfig = BSplineConfig(degree=3, n_control=10, horizon=24)
    # the whole tick's optimisation as one `traj_solve` launch where the goal
    # and config allow it; False takes the generic route always
    use_pallas: bool = True
    # exploration stage (escapes local minima around obstacles)
    use_particle_stage: bool = True
    mppi: MPPIConfig = MPPIConfig(
        n_particles=64, n_iters=2, init_std=0.08, std_decay=0.9, temperature=0.02
    )
    # gradient refinement per tick
    use_gradient_stage: bool = True
    lbfgs: LBFGSConfig = LBFGSConfig(history=8, n_iters=8, max_step=0.3)
    control_dt: float = 0.03  # horizon step duration
    rollout: RobotRolloutConfig = RobotRolloutConfig(
        pose_cost=terms.PoseCostConfig(position_weight=150.0, rotation_weight=60.0),
        bound_cost=terms.BoundCostConfig(
            weight=5000.0, velocity_weight=20.0, acceleration_weight=0.5
        ),
        collision_cost=terms.CollisionCostConfig(weight=1000.0, activation_distance=0.03),
        self_collision_cost=terms.SelfCollisionCostConfig(weight=5000.0),
        velocity_weight=0.1,
        acceleration_weight=0.01,
        jerk_weight=0.0,
        use_swept_collision=True,
        pose_run_weight=0.5,
    )
    # state filter blending (measured vs predicted), 1.0 = trust measurement
    state_filter_alpha: float = 1.0
    # deceleration fallback: max fraction of velocity kept per step
    brake_decay: float = 0.75
    # read by nothing, as in the JAX package (kept for parity of fields)
    cold_start_iters: int = 4

    @staticmethod
    def from_yaml(path_or_dict) -> "MPCConfig":
        from curobo_tpu_torch.util.config_io import dataclass_from_dict, load_yaml

        return dataclass_from_dict(MPCConfig, load_yaml(path_or_dict))


@dataclasses.dataclass(frozen=True)
class MPCState:
    """Carried across ticks (warm start)."""

    free_knots: torch.Tensor  # (B, n_free, D)
    q_filtered: torch.Tensor  # (B, D)
    seed: int = 0  # host integer key of the ticks' noise
    tick: int = 0  # host tick counter: tick t draws from (seed, t)


@dataclasses.dataclass(frozen=True)
class MPCResult:
    command: JointState  # (B, D) next command (position + velocity)
    plan: JointState  # (B, H, D) full horizon plan
    cost: torch.Tensor  # (B,)
    feasible: torch.Tensor  # (B,) plan passes collision/bounds
    pos_err: torch.Tensor
    rot_err: torch.Tensor


def tick_seed(seed: int, tick: int) -> int:
    """The 64-bit key of tick `tick` of a run keyed by `seed`: the pair (seed
    in the high word, tick in the low word) through the splitmix64 finaliser,
    so that the low 32 bits, all a CPU generator's seed keeps, differ too."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(tick) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def _stack_results(results) -> MPCResult:
    def js(states):
        s0 = states[0]
        fields = {
            f: None if getattr(s0, f) is None else torch.stack([getattr(s, f) for s in states])
            for f in ("position", "velocity", "acceleration", "jerk", "dt")
        }
        return JointState(joint_names=s0.joint_names, **fields)

    return MPCResult(
        command=js([r.command for r in results]),
        plan=js([r.plan for r in results]),
        **{f: torch.stack([getattr(r, f) for r in results])
           for f in ("cost", "feasible", "pos_err", "rot_err")},
    )


class MPCSolver:
    """Build once per (robot, config); the world, goal and state are per-call
    arguments. ``device=None`` is the CUDA device and raises when there is
    none."""

    def __init__(self, params: KinematicsParams, cfg: MPCConfig = MPCConfig(), device=None):
        self.device = runtime.resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.rollout = RobotRollout(self.params, cfg.rollout)
        self.transition = BSplineTransition(cfg.bspline, device=self.device)
        # STOMP-style smooth noise over the knot axis: random particles stay
        # low-acceleration, so exploration is not killed by the bound costs
        self._smooth_L = smooth_sample_transform(cfg.bspline.n_free, params.n_dof).to(self.device)
        self._solve_kernel = None
        if cfg.use_pallas and traj_config_is_supported(cfg.rollout) and params.n_tools == 1:
            mp, lb = cfg.mppi, cfg.lbfgs
            self._solve_kernel = TrajCost(
                self.params, cfg.rollout, cfg.bspline, pin_goal=False, device=self.device
            ).build_solver(
                eps_smooth=self._smooth_L,
                mppi_iters=mp.n_iters if cfg.use_particle_stage else 0,
                n_particles=mp.n_particles,
                init_std=float(mp.init_std),
                std_decay=mp.std_decay,
                min_std=mp.min_std,
                temperature=mp.temperature,
                step_size=mp.step_size,
                lbfgs_iters=lb.n_iters if cfg.use_gradient_stage else 0,
                history=lb.history,
                max_step=lb.max_step,
            )

    # ------------------------------------------------------------------
    def _use_kernel(self, goal: Goal) -> bool:
        """The JAX `MPCSolver._use_pallas` conditions (reads no tensor)."""
        return (
            self.cfg.use_pallas
            and self.params.n_tools == 1  # the trajectory kernel tracks one tool frame
            and ik_kernels.goal_takes_kernel(goal)
            and traj_config_is_supported(self.cfg.rollout)
        )

    def setup(self, q_start: torch.Tensor, seed: int = 0) -> MPCState:
        """Warm-start state that holds position (reference `setup`, :261)."""
        q_start = q_start.to(self.device)
        free = self.transition.linear_seed(q_start, q_start)
        return MPCState(free_knots=free, q_filtered=q_start, seed=int(seed), tick=0)

    def make_goal(self, goal_pose: Pose) -> Goal:
        return Goal.from_pose(goal_pose.to(self.device))

    # ------------------------------------------------------------------
    def _filter(self, state: MPCState, q_measured: torch.Tensor):
        B = q_measured.shape[0]
        dt = torch.full((B,), self.cfg.control_dt, device=q_measured.device)
        a = self.cfg.state_filter_alpha
        return a * q_measured + (1.0 - a) * state.q_filtered, dt

    def _step_impl_kernel(
        self,
        world: world_mod.WorldData,
        goal: Goal,
        state: MPCState,
        q_measured: torch.Tensor,  # (B, D)
        qd_measured: torch.Tensor,  # (B, D)
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[MPCResult, MPCState]:
        """One `traj_solve` launch, then the rollout of the plan. `noise`, when
        given, replaces the kernel's draw: (mppi_iters, n_particles, B,
        n_free * D) standard normals (smoothed by the kernel)."""
        B, D = q_measured.shape
        q0, dt = self._filter(state, q_measured)
        goal7 = torch.cat([goal.goal_pos[..., 0, 0, :], goal.goal_quat[..., 0, 0, :]], dim=-1)
        x, c, pe, re, fe, _ = self._solve_kernel(
            goal7.contiguous(), state.free_knots.reshape(B, -1).contiguous(), q0.contiguous(),
            dt, tick_seed(state.seed, state.tick), world, noise=noise,
        )
        knots = x.reshape(B, self.cfg.bspline.n_free, D)
        traj = self.transition.rollout(knots, q0, dt, joint_names=self.params.joint_names)
        return self._finish_step(knots, traj, q0, qd_measured, fe > 0.5, c, pe, re, state, dt)

    def _step_impl(
        self,
        world: world_mod.WorldData,
        goal: Goal,
        state: MPCState,
        q_measured: torch.Tensor,  # (B, D)
        qd_measured: torch.Tensor,  # (B, D)
        signs: Optional[torch.Tensor] = None,
    ) -> Tuple[MPCResult, MPCState]:
        """The generic route: MPPI with the smoothed quasi-random particles
        (signs from the tick's generator, or the given (B, n_free * D) signs)
        and L-BFGS over the generic objective."""
        cfg = self.cfg
        B, D = q_measured.shape
        n_free = cfg.bspline.n_free
        q0, dt = self._filter(state, q_measured)

        def cost(x):  # (..., B, n_free * D)
            knots = x.reshape(x.shape[:-1] + (n_free, D))
            traj = self.transition.rollout(knots, q0, dt)
            return self.rollout.evaluate_trajectory(world, goal, traj).cost

        def smooth_eps(eps):  # (P, B, n_free * D): smooth over the knot axis
            e = eps.reshape(eps.shape[:-1] + (n_free, D))
            return torch.einsum("kj,...jd->...kd", self._smooth_L, e).reshape(eps.shape)

        x = state.free_knots.reshape(B, -1)
        if cfg.use_particle_stage:
            gen = torch.Generator(device=x.device).manual_seed(tick_seed(state.seed, state.tick))
            x, _ = mppi_optimize(cost, x, gen, cfg.mppi, eps_transform=smooth_eps, signs=signs)
        if cfg.use_gradient_stage:
            x, _ = lbfgs_optimize(cost, x, cfg.lbfgs)
        knots = x.reshape(B, n_free, D)
        with torch.no_grad():
            traj = self.transition.rollout(knots, q0, dt, joint_names=self.params.joint_names)
            res = self.rollout.evaluate_trajectory(world, goal, traj)
        return self._finish_step(knots, traj, q0, qd_measured, res.feasible, res.cost,
                                 res.pos_err, res.rot_err, state, dt)

    def _finish_step(
        self, knots, traj, q0, qd_measured, feasible, cost, pos_err, rot_err, state, dt,
    ) -> Tuple[MPCResult, MPCState]:
        """Shared tick tail: brake fallback, command extraction, warm start."""
        cfg = self.cfg
        names = self.params.joint_names
        # safe deceleration for an infeasible plan: the measured velocity bled
        # off exponentially, integrated from the filtered state
        H = cfg.bspline.horizon
        steps = torch.arange(1, H + 1, dtype=q0.dtype, device=q0.device)
        decay = torch.pow(torch.full_like(steps, cfg.brake_decay), steps)
        brake_v = qd_measured[:, None, :] * decay[:, None]  # (B, H, D)
        brake_q = q0[:, None, :] + torch.cumsum(brake_v, dim=1) * cfg.control_dt
        ok = feasible[:, None, None]
        plan_q = torch.where(ok, traj.position, brake_q)
        plan_v = torch.where(ok, traj.velocity, brake_v)
        plan_a = torch.where(ok, traj.acceleration, torch.zeros_like(traj.acceleration))
        plan = JointState(position=plan_q, velocity=plan_v, acceleration=plan_a, dt=dt,
                          joint_names=names)
        command = JointState(position=plan_q[:, 1], velocity=plan_v[:, 1],
                             acceleration=plan_a[:, 1], joint_names=names)
        # warm start: the optimised free knots carry over unchanged; pinning
        # the start to the advanced robot state is itself the receding shift
        new_state = MPCState(free_knots=knots, q_filtered=plan_q[:, 1], seed=state.seed,
                             tick=state.tick + 1)
        result = MPCResult(command=command, plan=plan, cost=cost, feasible=feasible,
                           pos_err=pos_err, rot_err=rot_err)
        return result, new_state

    # ------------------------------------------------------------------
    def _impl(self, world: world_mod.WorldData, goal: Goal):
        if world.device != self.device:
            raise ValueError(f"world lies on {world.device}, solver on {self.device}")
        use_kernel = self._use_kernel(goal) and ik_kernels.world_is_supported(world)
        return self._step_impl_kernel if use_kernel else self._step_impl

    def _measured(self, joint_state: JointState):
        from curobo_tpu_torch.util.checks import check_joint_config

        q = check_joint_config("joint_state.position", joint_state.position,
                               self.params.n_dof).to(self.device)
        qd = (torch.zeros_like(q) if joint_state.velocity is None
              else joint_state.velocity.to(self.device))
        return q, qd

    def step(
        self,
        world: world_mod.WorldData,
        goal: Goal,
        state: MPCState,
        joint_state: JointState,  # measured (B, D)
    ) -> Tuple[MPCResult, MPCState]:
        """One control tick (reference `optimize_action_sequence`, :581)."""
        q, qd = self._measured(joint_state)
        return self._impl(world, goal)(world, goal, state, q, qd)

    def run_ticks(
        self,
        worlds: world_mod.WorldData,  # tables stacked (T, ...): one world per tick
        goal: Goal,
        state: MPCState,
        joint_state: JointState,  # measured (B, D) at tick 0
    ) -> Tuple[MPCResult, MPCState]:
        """T ticks, the measured state of tick t + 1 being the command of tick
        t (perfect tracking), with no host synchronisation: every tick's work
        is queued on the device. Returns the per-tick results stacked on a
        leading T axis and the final warm-start state."""
        T = worlds.cuboids.pos.shape[0]
        q, qd = self._measured(joint_state)
        impl = self._impl(world_mod.world_at(worlds, 0), goal)
        results = []
        for t in range(T):
            res, state = impl(world_mod.world_at(worlds, t), goal, state, q, qd)
            q, qd = res.command.position, res.command.velocity
            results.append(res)
        return _stack_results(results), state
