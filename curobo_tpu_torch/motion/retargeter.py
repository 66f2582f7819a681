"""Motion retargeter: track multi-link pose targets (teleop / mocap).

Counterpart of `curobo_tpu/motion/retargeter.py` (reference
`MotionRetargeter`, `curobo/_src/motion/motion_retargeter.py:56,224-310`): a
stateful facade. The FIRST frame solves global IK with many seeds
(`_solve_global`, `IKSolver`: a robot of more than 4 tool frames, as the
retargeting G1's 14, takes its generic route); later frames run either
warm-started local IK (`_solve_local`: `lbfgs_optimize` with autograd over
`_cost`, called eagerly where the JAX package jits it) or MPC ticks per target
(`_solve_mpc`, `MPCSolver`, `steps_per_target`), with per-tool weights.
`reset()` clears the warm-start state. On a CUDA device the self-collision
sum of `_cost` runs the pair kernels (`geom/self_collision.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from curobo_tpu_torch import runtime
from curobo_tpu_torch.geom.self_collision import self_collision_cost
from curobo_tpu_torch.math import quaternion as qm
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig, lbfgs_optimize
from curobo_tpu_torch.robot.kinematics import compute_kinematics
from curobo_tpu_torch.robot.params import KinematicsParams
from curobo_tpu_torch.types.pose import Pose
from curobo_tpu_torch.types.state import JointState


@dataclasses.dataclass(frozen=True)
class RetargetConfig:
    # frame-to-frame tracking mode: "local_ik" (warm-started gradient
    # solve) or "mpc" (receding-horizon ticks); the FIRST frame always
    # runs global IK with `global_seeds` seeds (reference mode selection,
    # `motion_retargeter.py:224-310`)
    mode: str = "local_ik"
    # per-tool (position_weight, rotation_weight); broadcast if single
    tool_weights: Tuple[Tuple[float, float], ...] = ((50.0, 10.0),)
    # smoothness regularization to the previous frame's solution
    smoothness_weight: float = 5.0
    null_space_weight: float = 0.05
    bound_weight: float = 1000.0
    self_collision_weight: float = 500.0
    lbfgs: LBFGSConfig = LBFGSConfig(history=8, n_iters=20, max_step=0.3)
    # global-IK first frame
    global_seeds: int = 24
    # MPC mode: control ticks executed per target frame
    steps_per_target: int = 2

    def __post_init__(self):
        if self.mode not in ("local_ik", "mpc"):
            raise ValueError(f"mode must be 'local_ik' or 'mpc', got {self.mode!r}")


@dataclasses.dataclass
class RetargetResult:
    """Per-frame result (reference `RetargetResult`)."""

    joint_state: JointState  # (B, D) solution
    cost: torch.Tensor  # (B,)
    success: Optional[torch.Tensor] = None  # (B,) global-IK frames only
    trajectory: Optional[JointState] = None  # (B, steps, D) MPC mode


class MotionRetargeter:
    """Stateful multi-tool pose tracking. First `solve_frame` = global IK;
    later frames warm-start from the previous solution (local-IK or MPC).
    ``device=None`` is the CUDA device and raises when there is none."""

    def __init__(
        self, params: KinematicsParams, cfg: RetargetConfig = RetargetConfig(), device=None
    ):
        self.device = runtime.resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self._prev_q: Optional[torch.Tensor] = None
        self._ik = None  # global-IK solver, built lazily
        self._mpc = None
        self._mpc_state = None
        self._world = None

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Clear warm-start state; the next frame solves global IK."""
        self._prev_q = None
        self._mpc_state = None

    def _pose_weights(self):
        T = self.params.n_tools
        w = self.cfg.tool_weights
        return w * T if len(w) == 1 else w

    def _get_world(self, world):
        if world is not None:
            return world
        if self._world is None:
            from curobo_tpu_torch.geom import world as wm

            self._world = wm.empty_world(device=self.device)
        return self._world

    # ------------------------------------------------------------------
    def _cost(self, q, goal_pos, goal_quat, q_prev):
        p, cfg = self.params, self.cfg
        st = compute_kinematics(p, q)
        weights = self._pose_weights()
        cost = 0.0
        for t in range(p.n_tools):
            dp = st.tool_pose.position[..., t, :] - goal_pos[..., t, :]
            dr = qm.quat_error(goal_quat[..., t, :], st.tool_pose.quaternion[..., t, :])
            wp, wr = weights[t]
            cost = cost + wp * torch.sum(dp * dp, dim=-1) + wr * torch.sum(dr * dr, dim=-1)
        # smoothness + retract + bounds + self collision
        cost = cost + cfg.smoothness_weight * torch.sum((q - q_prev) ** 2, dim=-1)
        if cfg.null_space_weight > 0:
            dn = (q - p.retract_config) * p.null_space_weight
            cost = cost + cfg.null_space_weight * torch.sum(dn * dn, dim=-1)
        lim = p.joint_limits
        viol = torch.clamp_min(lim.lower - q, 0.0) + torch.clamp_min(q - lim.upper, 0.0)
        cost = cost + cfg.bound_weight * torch.sum(viol * viol, dim=-1)
        cost = cost + cfg.self_collision_weight * self_collision_cost(p.self_collision, st.spheres)
        return cost

    def _solve_frame(self, q_prev, goal_pos, goal_quat):
        def cost(q):
            return self._cost(q, goal_pos, goal_quat, q_prev)

        return lbfgs_optimize(cost, q_prev, self.cfg.lbfgs)

    # ------------------------------------------------------------------
    def _solve_global(self, goal_poses: Pose, world) -> RetargetResult:
        """First frame: multi-seed global IK (reference `_solve_global_ik`)."""
        from curobo_tpu_torch.cost.terms import PoseCostConfig
        from curobo_tpu_torch.rollout.robot_rollout import RobotRolloutConfig
        from curobo_tpu_torch.solver.ik import IKConfig, IKSolver

        if self._ik is None:
            wp, wr = self._pose_weights()[0]
            self._ik = IKSolver(
                self.params,
                IKConfig(
                    n_seeds=self.cfg.global_seeds,
                    rollout=RobotRolloutConfig(
                        pose_cost=PoseCostConfig(
                            position_weight=max(wp, 1.0) * 10.0,
                            rotation_weight=max(wr, 1.0) * 10.0,
                        )
                    ),
                ),
                device=self.device,
            )
        res = self._ik.solve_pose(self._get_world(world), goal_poses)
        self._prev_q = res.solution
        if self.cfg.mode == "mpc":
            self._mpc_state = None  # (re)setup on the next frame
        return RetargetResult(
            joint_state=JointState.from_position(res.solution, self.params.joint_names),
            cost=res.cost,
            success=res.success,
        )

    def _solve_local(self, goal_poses: Pose) -> RetargetResult:
        q, c = self._solve_frame(self._prev_q, goal_poses.position, goal_poses.quaternion)
        self._prev_q = q
        return RetargetResult(
            joint_state=JointState.from_position(q, self.params.joint_names), cost=c
        )

    def _solve_mpc(self, goal_poses: Pose, world) -> RetargetResult:
        """MPC mode: `steps_per_target` control ticks toward the target
        (reference `_solve_mpc_frame:282`)."""
        from curobo_tpu_torch.solver.mpc import MPCConfig, MPCSolver

        world = self._get_world(world)
        if self._mpc is None:
            self._mpc = MPCSolver(self.params, MPCConfig(), device=self.device)
        if self._mpc_state is None:
            self._mpc_state = self._mpc.setup(self._prev_q)
        goal = self._mpc.make_goal(goal_poses)
        js = JointState.from_position(self._prev_q, self.params.joint_names)
        qs, vs = [], []
        res = None
        for _ in range(self.cfg.steps_per_target):
            res, self._mpc_state = self._mpc.step(world, goal, self._mpc_state, js)
            js = res.command
            qs.append(res.command.position)
            vs.append(res.command.velocity)
        self._prev_q = res.command.position
        traj = JointState(
            position=torch.stack(qs, dim=1),
            velocity=torch.stack(vs, dim=1),
            joint_names=self.params.joint_names,
        )
        return RetargetResult(joint_state=res.command, cost=res.cost, trajectory=traj)

    # ------------------------------------------------------------------
    def solve_frame(
        self, goal_poses: Pose, q_prev: Optional[torch.Tensor] = None, world=None
    ) -> RetargetResult:
        """goal_poses batched (B, T) over the robot's tool frames.

        First call (or after `reset()`): global IK. Later: local-IK or MPC
        per `cfg.mode`. Passing q_prev overrides the warm-start state.

        Parity: reference `solve_frame:122`.
        """
        goal_poses = goal_poses.to(self.device)
        if q_prev is not None:
            self._prev_q = q_prev.to(self.device)
        if self._prev_q is None:
            return self._solve_global(goal_poses, world)
        if self.cfg.mode == "mpc":
            return self._solve_mpc(goal_poses, world)
        return self._solve_local(goal_poses)

    def solve_sequence(
        self, goal_sequence: Pose, q0: Optional[torch.Tensor] = None, world=None
    ) -> JointState:
        """goal_sequence (F, T) pose sequence -> JointState trajectory (F, D).

        Parity: reference `solve_sequence:153`: frame-chained warm starts
        (global IK on frame 0 unless q0 seeds the state).
        """
        self.reset()
        if q0 is not None:
            q0 = q0.to(self.device)
            self._prev_q = q0[None] if q0.ndim == 1 else q0
        F = goal_sequence.position.shape[0]
        qs = []
        for f in range(F):
            frame = Pose(goal_sequence.position[f][None], goal_sequence.quaternion[f][None])
            res = self.solve_frame(frame, world=world)
            qs.append(res.joint_state.position[0])
        return JointState.from_position(torch.stack(qs), self.params.joint_names)
