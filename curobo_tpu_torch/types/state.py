"""JointState: batched joint-space state (plain dataclass of tensors), and
RobotState, the joint state with its task-space quantities.

Counterpart of `curobo_tpu/types/state.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from curobo_tpu_torch.types.pose import Pose


@dataclasses.dataclass(frozen=True)
class JointState:
    """All tensors share leading shape (..., dof); a trajectory adds a
    horizon axis (..., horizon, dof). ``dt`` is a per-problem timestep."""

    position: torch.Tensor
    velocity: Optional[torch.Tensor] = None
    acceleration: Optional[torch.Tensor] = None
    jerk: Optional[torch.Tensor] = None
    dt: Optional[torch.Tensor] = None
    joint_names: Tuple[str, ...] = ()

    @staticmethod
    def from_position(position: torch.Tensor, joint_names: Sequence[str] = ()) -> "JointState":
        return JointState(
            position=position,
            velocity=torch.zeros_like(position),
            acceleration=torch.zeros_like(position),
            jerk=torch.zeros_like(position),
            joint_names=tuple(joint_names),
        )

    @staticmethod
    def zeros(shape, joint_names: Sequence[str] = (), dtype=torch.float32, device="cpu") -> "JointState":
        return JointState.from_position(
            torch.zeros(shape, dtype=dtype, device=device), joint_names
        )

    @property
    def dof(self) -> int:
        return self.position.shape[-1]

    @property
    def shape(self):
        return tuple(self.position.shape)

    def _map(self, fn) -> "JointState":
        return JointState(
            position=fn(self.position),
            velocity=None if self.velocity is None else fn(self.velocity),
            acceleration=None if self.acceleration is None else fn(self.acceleration),
            jerk=None if self.jerk is None else fn(self.jerk),
            dt=self.dt,
            joint_names=self.joint_names,
        )

    def reshape(self, *shape) -> "JointState":
        return self._map(lambda a: a.reshape(shape))

    def __getitem__(self, idx) -> "JointState":
        return self._map(lambda a: a[idx])

    def tile_seeds(self, n_seeds: int) -> "JointState":
        """(B, ..., dof) -> (B, n_seeds, ..., dof)."""
        return self._map(
            lambda a: a[:, None].expand((a.shape[0], n_seeds) + tuple(a.shape[1:]))
        )

    def reorder(self, joint_names: Sequence[str]) -> "JointState":
        """Columns permuted to match ``joint_names``."""
        if tuple(joint_names) == self.joint_names:
            return self
        if not self.joint_names:
            raise ValueError("JointState has no joint_names to reorder by")
        missing = [n for n in joint_names if n not in self.joint_names]
        if missing:
            raise ValueError(
                f"joints {missing} not in JointState (has {list(self.joint_names)})"
            )
        idx = [self.joint_names.index(n) for n in joint_names]
        out = self._map(lambda a: a[..., idx])
        return dataclasses.replace(out, joint_names=tuple(joint_names))

    def select_joints(self, joint_names: Sequence[str]) -> "JointState":
        return self.reorder(joint_names)


@dataclasses.dataclass(frozen=True)
class RobotState:
    """Full robot state: the joint state and what follows from it (tool and
    link poses, collision spheres, joint torques)."""

    joint_state: JointState
    tool_poses: Optional[Pose] = None  # (..., n_tools) batched pose
    robot_spheres: Optional[torch.Tensor] = None  # (..., n_spheres, 4) xyzr
    link_poses: Optional[Pose] = None  # (..., n_links)
    torque: Optional[torch.Tensor] = None  # (..., dof)
