"""Batched Levenberg-Marquardt step and the LM seed-IK solver.

Counterpart of `curobo_tpu/opt/lm.py`: `LMConfig` (fields and defaults equal),
`lm_step` and `SeedIK`, the pose-only warm start that refines every IK seed
before the main optimizer. It is plain PyTorch on tensors: the JAX package runs
it as XLA outside any Pallas kernel, so there is no kernel to port.

The factorisation is `torch.linalg.cholesky_ex` with `torch.cholesky_solve`,
which never reads its `info` on the host (no device synchronisation per
iteration) and does not raise on a matrix that is not positive definite. JAX's
Cholesky gives NaNs there, its `c_new < c` is then false and the step is
rejected; here a failed factorisation rejects the step explicitly, and its
configuration never reaches the result.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from curobo_tpu_torch.math import quaternion as qm
from curobo_tpu_torch.robot import kinematics as kin_mod
from curobo_tpu_torch.robot.params import KinematicsParams
from curobo_tpu_torch.types.pose import Pose


@dataclasses.dataclass(frozen=True)
class LMConfig:
    n_iters: int = 20
    damping: float = 1e-3
    # adaptive damping multipliers
    damping_up: float = 2.0
    damping_down: float = 0.5
    step_clip: float = 0.5
    position_weight: float = 1.0
    rotation_weight: float = 0.5


def lm_step(
    J: torch.Tensor,  # (..., R, D) residual Jacobian
    r: torch.Tensor,  # (..., R) residuals
    damping: torch.Tensor,  # (...,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped Gauss-Newton step: (delta (..., D) minimising
    |J d + r|^2 + damping |d|^2, ok (...,)), by Cholesky of (J^T J + l I) when
    R >= D or of the (R, R) matrix of the dual form J^T (J J^T + l I)^-1 when
    R < D. Where the matrix is not positive definite, ok is False and the step
    is 0 (JAX's `lm_step` returns NaN there)."""
    D = J.shape[-1]
    R = J.shape[-2]
    if R < D:
        A = J @ J.transpose(-1, -2)
        A = A + damping[..., None, None] * torch.eye(R, dtype=J.dtype, device=J.device)
        L, info = torch.linalg.cholesky_ex(A)
        y = torch.cholesky_solve(r[..., None], L)
        d = -(J.transpose(-1, -2) @ y)[..., 0]
    else:
        A = J.transpose(-1, -2) @ J
        A = A + damping[..., None, None] * torch.eye(D, dtype=J.dtype, device=J.device)
        b = -(J.transpose(-1, -2) @ r[..., None])
        L, info = torch.linalg.cholesky_ex(A)
        d = torch.cholesky_solve(b, L)[..., 0]
    ok = (info == 0) & torch.isfinite(d).all(dim=-1)
    return torch.where(ok[..., None], d, torch.zeros_like(d)), ok


class SeedIK:
    """LM warm-seed IK: fast pose-only convergence, no collision terms."""

    def __init__(self, params: KinematicsParams, cfg: LMConfig = LMConfig()):
        self.params = params
        self.cfg = cfg

    def _residual_and_jac(self, q, goal_pos, goal_quat):
        """goal_pos (..., T, 3) / goal_quat (..., T, 4) over all tool frames ->
        residual (..., 6 T) and its Jacobian (..., 6 T, D); the angular rows
        are turned into the goal frame, in which the rotation residual is
        taken (small-error approximation; the damping absorbs the rest)."""
        cfg = self.cfg
        st = kin_mod.compute_kinematics(self.params, q, compute_jacobian=True)
        D = q.shape[-1]
        T = goal_pos.shape[-2]
        dp = (st.tool_pose.position - goal_pos) * cfg.position_weight
        dr = qm.quat_error(goal_quat, st.tool_pose.quaternion) * cfg.rotation_weight
        r = torch.cat([dp, dr], dim=-1)  # (..., T, 6)
        J = st.jacobian  # (..., T, 6, D)
        Rg = qm.quat_to_matrix(goal_quat)  # (..., T, 3, 3)
        J_rot = torch.einsum("...ji,...jd->...id", Rg, J[..., 3:, :])
        J = torch.cat(
            [J[..., :3, :] * cfg.position_weight, J_rot * cfg.rotation_weight], dim=-2
        )
        lead = tuple(r.shape[:-2])
        return r.reshape(lead + (T * 6,)), J.reshape(lead + (T * 6, D))

    def _residual_only(self, q, goal_pos, goal_quat):
        """The residual without the Jacobian (the acceptance test needs only
        the cost)."""
        cfg = self.cfg
        st = kin_mod.compute_kinematics(self.params, q)
        T = goal_pos.shape[-2]
        dp = (st.tool_pose.position - goal_pos) * cfg.position_weight
        dr = qm.quat_error(goal_quat, st.tool_pose.quaternion) * cfg.rotation_weight
        r = torch.cat([dp, dr], dim=-1)
        return r.reshape(tuple(r.shape[:-2]) + (T * 6,))

    def _solve(self, q0, goal_pos, goal_quat) -> Tuple[torch.Tensor, torch.Tensor]:
        """q0 (..., D), goals (..., T, 3/4) -> (best q, its squared residual):
        step clip, clip to the joint limits, accept on a lower cost, damping
        down on acceptance and up on rejection within [1e-6, 1e3]."""
        cfg = self.cfg
        lim = self.params.joint_limits
        lo, hi = lim.lower, lim.upper
        with torch.no_grad():
            damping = torch.full(q0.shape[:-1], cfg.damping, dtype=q0.dtype, device=q0.device)
            r0 = self._residual_only(q0, goal_pos, goal_quat)
            q = best_q = q0
            best_c = (r0 * r0).sum(dim=-1)
            for _ in range(cfg.n_iters):
                r, J = self._residual_and_jac(q, goal_pos, goal_quat)
                c = (r * r).sum(dim=-1)
                d, ok = lm_step(J, r, damping)
                dn = d.abs().amax(dim=-1, keepdim=True)
                d = d * torch.clamp(cfg.step_clip / dn.clamp_min(1e-9), max=1.0)
                q_new = torch.minimum(torch.maximum(q + d, lo), hi)
                r2 = self._residual_only(q_new, goal_pos, goal_quat)
                c_new = (r2 * r2).sum(dim=-1)
                # a failed factorisation is a rejected step (NaN in JAX)
                c_new = torch.where(ok, c_new, torch.full_like(c_new, float("inf")))
                improved = c_new < c
                q = torch.where(improved[..., None], q_new, q)
                damping = torch.where(
                    improved, damping * cfg.damping_down, damping * cfg.damping_up
                ).clamp(1e-6, 1e3)
                better = c_new < best_c
                best_q = torch.where(better[..., None], q_new, best_q)
                best_c = torch.minimum(best_c, c_new)
        return best_q, best_c

    def solve(self, goal_pose: Pose, q0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """goal_pose batch (...,) or (..., T), q0 (..., D) ->
        (q (..., D), squared residual (...,))."""
        gp, gq = goal_pose.position, goal_pose.quaternion
        if gp.ndim == q0.ndim:  # no tool axis: single-tool caller
            gp, gq = gp[..., None, :], gq[..., None, :]
        return self._solve(q0, gp, gq)
