"""Object pose estimation from point clouds against a mesh SDF.

Counterpart of `curobo_tpu/perception/pose_estimation.py`: `SDFPoseDetector`
bakes the mesh into an SDF grid (`geom/mesh.py`) once and refines poses by
damped Levenberg-Marquardt on the sampled SDF at the observed points, with a
left-applied rotation-vector delta, a step clip and the best pose so far kept.
A fixed number of iterations; no host read inside the loop.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from curobo_tpu_torch.geom import types as gt
from curobo_tpu_torch.geom.mesh import mesh_to_sdf_grid
from curobo_tpu_torch.geom.sdf import sample_voxel_grid
from curobo_tpu_torch.math import quaternion as qm
from curobo_tpu_torch.runtime import resolve_device
from curobo_tpu_torch.types.pose import Pose


@dataclasses.dataclass(frozen=True)
class PoseEstimationConfig:
    n_iters: int = 30
    damping: float = 1e-2
    step_clip: float = 0.1
    # sampling-based init
    n_orientation_samples: int = 32


class SDFPoseDetector:
    """LM pose refinement: minimize sum sdf(T^-1 p_i)^2 over the object pose.
    ``device=None`` is the CUDA device (raises when there is none)."""

    def __init__(self, mesh: gt.MeshObstacle, cfg: PoseEstimationConfig = PoseEstimationConfig(),
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        sdf_grid, origin, cell = mesh_to_sdf_grid(mesh)
        self._grid = torch.as_tensor(sdf_grid, device=self.device)
        self._origin = torch.as_tensor(origin, device=self.device)
        self._cell = float(cell)

    def _residuals(self, pos, quat, points):
        """SDF at the object-local coordinates of the observed points."""
        local = qm.quat_rotate(qm.quat_conjugate(quat)[..., None, :], points - pos[..., None, :])
        return sample_voxel_grid(self._grid, local, self._origin, self._cell, outside_value=0.3)

    @staticmethod
    def _apply_delta(pos, quat, delta):
        """delta (..., 6): [translation, rotation vector], left-applied."""
        rv = delta[..., 3:]
        angle = torch.sqrt((rv * rv).sum(dim=-1) + 1e-12)
        dq = qm.quat_from_axis_angle(rv / angle[..., None], angle)
        return pos + delta[..., :3], qm.quat_normalize(qm.quat_multiply(dq, quat))

    def _refine(self, pos0, quat0, points):
        cfg = self.cfg
        eye = torch.eye(6, dtype=pos0.dtype, device=pos0.device)
        r0 = self._residuals(pos0, quat0, points)
        pos, quat = pos0, quat0
        damping = torch.full(pos0.shape[:-1], cfg.damping, dtype=pos0.dtype, device=pos0.device)
        best_pos, best_quat, best_c = pos0, quat0, (r0 * r0).mean(dim=-1)
        batch = pos0.shape[:-1]
        pts_b = points.expand(batch + points.shape[-2:]).reshape((-1,) + points.shape[-2:])

        def res_one(delta, p, q, x):
            # one pose, kept a batch of one: forward-mode derivatives of 0-d
            # quaternion components plus Python floats come out in float64
            return self._residuals(*self._apply_delta(p[None], q[None], delta[None]), x[None])[0]

        # the Jacobian in the 6 delta parameters at delta = 0: forward mode,
        # the 6 tangents and the poses batched by vmap
        jac = torch.func.vmap(torch.func.jacfwd(res_one))
        for _ in range(cfg.n_iters):
            zero = torch.zeros(batch + (6,), dtype=pos.dtype, device=pos.device)
            r = self._residuals(*self._apply_delta(pos, quat, zero), points)
            c = (r * r).mean(dim=-1)
            J = jac(zero.reshape(-1, 6), pos.reshape(-1, 3), quat.reshape(-1, 4), pts_b)
            J = J.reshape(batch + J.shape[-2:])  # (..., N, 6)
            JtJ = torch.einsum("...ni,...nj->...ij", J, J)
            b = -torch.einsum("...ni,...n->...i", J, r)
            L = torch.linalg.cholesky(JtJ + damping[..., None, None] * eye)
            delta = torch.cholesky_solve(b[..., None], L)[..., 0]
            dn = delta.abs().amax(dim=-1, keepdim=True)
            delta = delta * (cfg.step_clip / dn.clamp_min(1e-9)).clamp_max(1.0)
            pos_n, quat_n = self._apply_delta(pos, quat, delta)
            r_n = self._residuals(pos_n, quat_n, points)
            c_n = (r_n * r_n).mean(dim=-1)
            improved = c_n < c
            pos = torch.where(improved[..., None], pos_n, pos)
            quat = torch.where(improved[..., None], quat_n, quat)
            damping = torch.where(improved, damping * 0.5, damping * 2.0).clamp(1e-6, 1e3)
            better = c_n < best_c
            best_pos = torch.where(better[..., None], pos_n, best_pos)
            best_quat = torch.where(better[..., None], quat_n, best_quat)
            best_c = torch.minimum(c_n, best_c)
        return best_pos, best_quat, best_c

    def refine(self, pose0: Pose, points: torch.Tensor) -> Tuple[Pose, torch.Tensor]:
        """Refine pose(s) against world points (..., N, 3). Returns (refined
        Pose, rms residual (...,))."""
        pos, quat, c = self._refine(pose0.position, pose0.quaternion, points)
        return Pose(pos, quat), torch.sqrt(c)

    def detect(self, points: torch.Tensor, position_hint: torch.Tensor, seed: int = 0
               ) -> Tuple[Pose, torch.Tensor]:
        """Sampling-based init (a fan of random orientations drawn from
        `seed`) + refinement; the best refined pose and its rms residual."""
        n = self.cfg.n_orientation_samples
        gen = torch.Generator().manual_seed(seed)
        quats = qm.quat_normalize(torch.randn((n, 4), generator=gen)).to(points.device)
        pos = position_hint.expand(n, 3)
        pose, res = self.refine(Pose(pos, quats), points[None])
        best = torch.argmin(res)
        return Pose(pose.position[best], pose.quaternion[best]), res[best]
