"""Trajectory utilities: smoothing, resampling, execution buffering.

Counterpart of `curobo_tpu/util/trajectory.py` (reference `util/trajectory.py`
`linear_smooth`, `util/trajectory_execution_manager.py:20` and
`util/state_filter.py:45`). Plain PyTorch and numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from curobo_tpu_torch.types.state import JointState


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """numpy/jnp `interp` along the first axis of fp (xp increasing):
    fp[i-1] + (x - xp[i-1]) / (xp[i] - xp[i-1]) * (fp[i] - fp[i-1]), held at
    the ends."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    shape = (-1,) + (1,) * (fp.ndim - 1)
    f = f0 + ((x - x0) / (x1 - x0)).reshape(shape) * (f1 - f0)
    f = torch.where((x <= xp[0]).reshape(shape), fp[0], f)
    return torch.where((x >= xp[-1]).reshape(shape), fp[-1], f)


def linear_resample(traj: JointState, n_out: int) -> JointState:
    """Uniform-in-time linear resampling of a position trajectory (..., H, D)."""
    q = traj.position
    H = q.shape[-2]
    t_in = torch.linspace(0.0, 1.0, H, dtype=q.dtype, device=q.device)
    t_out = torch.linspace(0.0, 1.0, n_out, dtype=q.dtype, device=q.device)
    out = torch.movedim(_interp(t_out, t_in, torch.movedim(q, -2, 0)), 0, -2)
    dt = None
    if traj.dt is not None:
        dt = traj.dt * (H - 1) / max(n_out - 1, 1)
    return dataclasses.replace(JointState.from_position(out, traj.joint_names), dt=dt)


def linear_smooth(traj: JointState, window: int = 5, passes: int = 2) -> JointState:
    """Moving-average smoothing with pinned endpoints (reference
    `linear_smooth`, `util/trajectory.py:24`)."""
    q = traj.position
    pad = window // 2
    w = 1.0 / window
    out = q
    for _ in range(passes):
        padded = torch.cat(
            [
                out[..., :1, :].repeat_interleave(pad, dim=-2),
                out,
                out[..., -1:, :].repeat_interleave(pad, dim=-2),
            ],
            dim=-2,
        )
        sm = torch.zeros_like(out)
        for k in range(window):
            sm = sm + w * padded[..., k : k + q.shape[-2], :]
        # pin endpoints exactly
        sm[..., 0, :] = q[..., 0, :]
        sm[..., -1, :] = q[..., -1, :]
        out = sm
    return dataclasses.replace(traj, position=out)


@dataclasses.dataclass
class JointStateFilter:
    """Exponential blend of measured vs commanded state (MPC input filter)."""

    alpha: float = 0.9  # weight on the new measurement
    state: Optional[JointState] = None

    def __call__(self, measured: JointState) -> JointState:
        if self.state is None:
            self.state = measured
            return measured
        a = self.alpha
        blended = JointState(
            position=a * measured.position + (1 - a) * self.state.position,
            velocity=(
                a * measured.velocity + (1 - a) * self.state.velocity
                if measured.velocity is not None and self.state.velocity is not None
                else measured.velocity
            ),
            joint_names=measured.joint_names,
        )
        self.state = blended
        return blended


class TrajectoryExecutionManager:
    """Ring buffer of commands ahead of execution (MPC -> robot bridge).

    Reference `TrajectoryExecutionManager`
    (`util/trajectory_execution_manager.py:20`)."""

    def __init__(self, control_dt: float, buffer_horizon: int = 8):
        self.control_dt = control_dt
        self.buffer_horizon = buffer_horizon
        self._plan: Optional[np.ndarray] = None  # (H, D) positions
        self._vel: Optional[np.ndarray] = None
        self._cursor = 0

    def update_plan(self, plan: JointState) -> None:
        """Accept a fresh plan (B=1 or unbatched)."""
        q = plan.position.detach().cpu().numpy()
        v = plan.velocity.detach().cpu().numpy() if plan.velocity is not None else None
        if q.ndim == 3:
            q = q[0]
            v = v[0] if v is not None else None
        self._plan = q
        self._vel = v
        self._cursor = 1  # step 0 is the current state

    def next_command(self):
        """Pop the next (position, velocity) command; holds the last one when
        the buffer drains (safe behavior between plan updates)."""
        if self._plan is None:
            raise RuntimeError("no plan set")
        i = min(self._cursor, len(self._plan) - 1, self.buffer_horizon)
        self._cursor += 1
        v = self._vel[i] if self._vel is not None else None
        return self._plan[i], v

    @property
    def steps_remaining(self) -> int:
        if self._plan is None:
            return 0
        return max(min(len(self._plan) - 1, self.buffer_horizon) - self._cursor + 1, 0)
