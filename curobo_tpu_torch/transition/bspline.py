"""Clamped B-spline trajectory parameterization (knots -> dense trajectory).

Counterpart of `curobo_tpu/transition/bspline.py`. The basis (Cox-de Boor
through scipy) is computed once on the host in float64 into dense
(H, n_ctrl) matrices for value, velocity, acceleration and jerk; a trajectory
is then one product per derivative. These products are plain PyTorch (the JAX
package leaves them to XLA), in float32 at full precision: TF32 is off for
the whole package (`curobo_tpu_torch/__init__.py`), since reduced precision
inflated the jerk readout 2.4x in the JAX package. Boundary conditions pin the
first N_PIN control points to the start state, optionally the last N_PIN to a
goal state.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.interpolate import BSpline as ScipyBSpline

from curobo_tpu_torch.types.state import JointState

N_PIN = 3  # control points pinned at each constrained end (pos/vel/acc)


def _knot_vector(n_ctrl: int, degree: int) -> np.ndarray:
    n_interior = n_ctrl - degree - 1
    return np.concatenate(
        [
            np.zeros(degree + 1),
            (np.arange(1, n_interior + 1)) / (n_interior + 1),
            np.ones(degree + 1),
        ]
    )


@functools.lru_cache(maxsize=64)
def _basis_matrices(
    n_ctrl: int, degree: int, horizon: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(B0, B1, B2, B3): (H, n_ctrl) float64 basis value/1st/2nd/3rd-derivative
    matrices for a clamped uniform B-spline on t in [0, 1]."""
    if n_ctrl <= degree:
        raise ValueError(f"n_ctrl ({n_ctrl}) must exceed degree ({degree})")
    knots = _knot_vector(n_ctrl, degree)
    ts = np.linspace(0.0, 1.0, horizon)
    # clamp the right endpoint inside the domain for derivative evaluation
    ts_eval = np.minimum(ts, 1.0 - 1e-9)
    mats = []
    eye = np.eye(n_ctrl)
    for order in range(4):
        M = np.zeros((horizon, n_ctrl))
        for i in range(n_ctrl):
            spl = ScipyBSpline(knots, eye[i], degree, extrapolate=False)
            d = spl.derivative(order) if order > 0 else spl
            M[:, i] = np.nan_to_num(d(ts_eval))
        mats.append(M)
    return tuple(mats)


@dataclasses.dataclass(frozen=True)
class BSplineConfig:
    degree: int = 5
    n_control: int = 16  # total control points incl. pinned boundary points
    horizon: int = 32  # dense evaluation steps

    @property
    def n_free(self) -> int:
        return self.n_control - N_PIN

    @property
    def n_free_cspace(self) -> int:
        """Free knots when both ends are pinned (cspace goal)."""
        return self.n_control - 2 * N_PIN


class BSplineTransition:
    """Maps free knots + boundary states to a dense JointState trajectory."""

    def __init__(self, cfg: BSplineConfig, device="cpu", dtype=torch.float32):
        self.cfg = cfg
        mats = _basis_matrices(cfg.n_control, cfg.degree, cfg.horizon)
        self.B0, self.B1, self.B2, self.B3 = (
            torch.as_tensor(m, dtype=dtype, device=device) for m in mats
        )

    # ------------------------------------------------------------------
    def assemble_control(
        self,
        free_knots: torch.Tensor,  # (..., n_free, D)
        q_start: torch.Tensor,  # (..., D)
        q_goal: Optional[torch.Tensor] = None,  # (..., D) pins the far end
    ) -> torch.Tensor:
        """Prepend (and optionally append) pinned control points. free_knots
        may carry extra leading axes; boundary states broadcast against them."""
        D = free_knots.shape[-1]
        lead = torch.broadcast_shapes(free_knots.shape[:-2], q_start.shape[:-1])
        free_b = free_knots.expand(lead + free_knots.shape[-2:])
        parts = [q_start[..., None, :].expand(lead + (N_PIN, D)), free_b]
        if q_goal is not None:
            parts.append(q_goal[..., None, :].expand(lead + (N_PIN, D)))
        return torch.cat(parts, dim=-2)

    def evaluate(
        self,
        control: torch.Tensor,  # (..., n_control, D)
        dt: torch.Tensor,  # (...,) per-problem step duration
        joint_names=(),
    ) -> JointState:
        """Dense trajectory: one product per derivative order."""
        T = (dt * (self.cfg.horizon - 1))[..., None, None]  # total duration
        pos = torch.einsum("hc,...cd->...hd", self.B0, control)
        vel = torch.einsum("hc,...cd->...hd", self.B1, control) / T
        acc = torch.einsum("hc,...cd->...hd", self.B2, control) / T**2
        jerk = torch.einsum("hc,...cd->...hd", self.B3, control) / T**3
        return JointState(
            position=pos, velocity=vel, acceleration=acc, jerk=jerk,
            dt=dt, joint_names=tuple(joint_names),
        )

    def rollout(
        self,
        free_knots: torch.Tensor,
        q_start: torch.Tensor,
        dt: torch.Tensor,
        q_goal: Optional[torch.Tensor] = None,
        joint_names=(),
    ) -> JointState:
        ctrl = self.assemble_control(free_knots, q_start, q_goal)
        return self.evaluate(ctrl, dt, joint_names)

    # ------------------------------------------------------------------
    def linear_seed(
        self, q_start: torch.Tensor, q_end: torch.Tensor, q_goal_pinned: bool = False
    ) -> torch.Tensor:
        """Free knots approximating the straight line q_start -> q_end: a
        B-spline with collinear, uniformly spaced control points traces it."""
        n = self.cfg.n_control
        a = torch.as_tensor(np.linspace(0.0, 1.0, n), dtype=q_start.dtype,
                            device=q_start.device)[:, None]
        ctrl = q_start[..., None, :] * (1.0 - a) + q_end[..., None, :] * a
        if q_goal_pinned:
            return ctrl[..., N_PIN : n - N_PIN, :]
        return ctrl[..., N_PIN:, :]

    def path_seed(self, waypoints: torch.Tensor, q_goal_pinned: bool = False) -> torch.Tensor:
        """Free knots approximating a waypoint path (..., P, D): control points
        at uniform parameter positions along the piecewise-linear path."""
        n = self.cfg.n_control
        P = waypoints.shape[-2]
        t = np.linspace(0.0, 1.0, n) * (P - 1)
        i0 = np.clip(np.floor(t).astype(int), 0, P - 2)
        frac = torch.as_tensor(t - i0, dtype=waypoints.dtype, device=waypoints.device)[:, None]
        i0_t = torch.as_tensor(i0, device=waypoints.device)
        w0 = waypoints[..., i0_t, :]
        w1 = waypoints[..., i0_t + 1, :]
        ctrl = w0 * (1.0 - frac) + w1 * frac
        if q_goal_pinned:
            return ctrl[..., N_PIN : n - N_PIN, :]
        return ctrl[..., N_PIN:, :]

    def evaluate_at(
        self, control: torch.Tensor, dt: torch.Tensor, t_query: torch.Tensor,
    ) -> torch.Tensor:
        """Positions (..., Q, D) at normalized times t in [0, 1] (..., Q), the
        basis built on the fly by the Cox-de Boor recursion."""
        cfg = self.cfg
        degree = cfg.degree
        knots = torch.as_tensor(
            _knot_vector(cfg.n_control, degree), dtype=control.dtype, device=control.device
        )
        t = torch.clamp(t_query, 0.0, 1.0 - 1e-6)[..., None]  # (..., Q, 1)
        left, right = knots[:-1], knots[1:]
        N = ((t >= left) & (t < right)).to(control.dtype)
        for k in range(1, degree + 1):
            d1 = knots[k:-1] - knots[: -k - 1]
            d2 = knots[k + 1 :] - knots[1:-k]
            one = torch.ones_like(d1)
            a = torch.where(d1 > 0, (t - knots[: -k - 1]) / torch.where(d1 > 0, d1, one),
                            torch.zeros_like(t - d1))
            b = torch.where(d2 > 0, (knots[k + 1 :] - t) / torch.where(d2 > 0, d2, one),
                            torch.zeros_like(t - d2))
            N = a * N[..., :-1] + b * N[..., 1:]
        return torch.einsum("...qc,...cd->...qd", N, control)
