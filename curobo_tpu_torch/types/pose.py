"""Pose: batched position + wxyz quaternion (plain dataclass of tensors).

Counterpart of `curobo_tpu/types/pose.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from curobo_tpu_torch.math import quaternion as quat_math


@dataclasses.dataclass(frozen=True)
class Pose:
    """position (..., 3), quaternion (..., 4) wxyz unit norm."""

    position: torch.Tensor
    quaternion: torch.Tensor

    # ---- constructors -------------------------------------------------
    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device="cpu") -> "Pose":
        pos = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
        q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
        q[..., 0] = 1.0
        return Pose(pos, q)

    @staticmethod
    def from_list(vals, dtype=torch.float32, device="cpu") -> "Pose":
        """[x, y, z, qw, qx, qy, qz] (or batched nested lists)."""
        arr = torch.as_tensor(vals, dtype=dtype, device=device)
        return Pose(arr[..., :3], quat_math.quat_normalize(arr[..., 3:7]))

    @staticmethod
    def from_matrix(mat: torch.Tensor) -> "Pose":
        return Pose(mat[..., :3, 3], quat_math.matrix_to_quat(mat[..., :3, :3]))

    @staticmethod
    def from_rotation(R: torch.Tensor, p: torch.Tensor) -> "Pose":
        return Pose(p, quat_math.matrix_to_quat(R))

    # ---- shape ops ----------------------------------------------------
    @property
    def batch_shape(self):
        return tuple(self.position.shape[:-1])

    @property
    def shape(self):
        return self.batch_shape

    def to(self, device) -> "Pose":
        return Pose(self.position.to(device), self.quaternion.to(device))

    def reshape(self, *batch_shape) -> "Pose":
        return Pose(
            self.position.reshape(tuple(batch_shape) + (3,)),
            self.quaternion.reshape(tuple(batch_shape) + (4,)),
        )

    def repeat(self, n: int, axis: int = 0) -> "Pose":
        return Pose(
            torch.repeat_interleave(self.position, n, dim=axis),
            torch.repeat_interleave(self.quaternion, n, dim=axis),
        )

    def tile_seeds(self, n_seeds: int) -> "Pose":
        """(B, ...) -> (B, n_seeds, ...) broadcast over a new seed axis."""
        p, q = self.position, self.quaternion
        return Pose(
            p[:, None].expand((p.shape[0], n_seeds) + tuple(p.shape[1:])),
            q[:, None].expand((q.shape[0], n_seeds) + tuple(q.shape[1:])),
        )

    def __getitem__(self, idx) -> "Pose":
        return Pose(self.position[idx], self.quaternion[idx])

    # ---- algebra ------------------------------------------------------
    def multiply(self, other: "Pose") -> "Pose":
        return Pose(
            self.position + quat_math.quat_rotate(self.quaternion, other.position),
            quat_math.quat_normalize(
                quat_math.quat_multiply(self.quaternion, other.quaternion)
            ),
        )

    def inverse(self) -> "Pose":
        q_inv = quat_math.quat_conjugate(self.quaternion)
        return Pose(-quat_math.quat_rotate(q_inv, self.position), q_inv)

    def transform_points(self, pts: torch.Tensor) -> torch.Tensor:
        return (
            quat_math.quat_rotate(self.quaternion[..., None, :], pts)
            + self.position[..., None, :]
        )

    def rotation_matrix(self) -> torch.Tensor:
        return quat_math.quat_to_matrix(self.quaternion)

    def to_matrix(self) -> torch.Tensor:
        m = torch.zeros(
            self.batch_shape + (4, 4),
            dtype=self.position.dtype,
            device=self.position.device,
        )
        m[..., :3, :3] = self.rotation_matrix()
        m[..., :3, 3] = self.position
        m[..., 3, 3] = 1.0
        return m

    # ---- metrics ------------------------------------------------------
    def position_error(self, other: "Pose") -> torch.Tensor:
        return torch.linalg.norm(self.position - other.position, dim=-1)

    def rotation_error(self, other: "Pose") -> torch.Tensor:
        return quat_math.quat_geodesic_distance(self.quaternion, other.quaternion)

    def to_numpy(self) -> np.ndarray:
        return np.concatenate(
            [self.position.detach().cpu().numpy(), self.quaternion.detach().cpu().numpy()],
            axis=-1,
        )
