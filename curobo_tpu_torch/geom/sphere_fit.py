"""Sphere fitting: approximate a mesh volume with collision spheres.

Counterpart of `curobo_tpu/geom/sphere_fit.py`: greedy deepest-voxel seeding
on the baked SDF grid (`geom/mesh.py`), then Adam (`torch.optim.Adam`, the
same learning rate, betas and eps as the JAX package's optax Adam) on the
outside, coverage, overlap and tangency losses, gradients by autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from curobo_tpu_torch.geom import types as gt
from curobo_tpu_torch.geom.mesh import mesh_to_sdf_grid
from curobo_tpu_torch.geom.sdf import sample_voxel_grid
from curobo_tpu_torch.runtime import resolve_device

_BIG_DIAG = 1.0e6  # masks the self-pair in nearest-neighbor reductions


@dataclasses.dataclass(frozen=True)
class SphereFitConfig:
    n_spheres: int = 16
    n_iters: int = 200
    learning_rate: float = 1e-2
    # loss weights
    outside_weight: float = 10.0  # spheres must stay inside the mesh
    coverage_weight: float = 1.0  # surface samples should be inside a sphere
    overlap_weight: float = 0.1  # discourage redundant spheres
    tangency_weight: float = 0.05  # neighbors should touch (no gaps)
    min_radius: float = 0.005


def voxel_init(sdf: np.ndarray, origin: np.ndarray, cell: float, n_spheres: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy deepest-voxel seeding."""
    s = sdf.copy()
    centers = []
    radii = []
    grid_idx = np.stack(np.meshgrid(*[np.arange(n) for n in s.shape], indexing="ij"), axis=-1)
    for _ in range(n_spheres):
        idx = np.unravel_index(np.argmin(s), s.shape)
        r = -s[idx]
        if r <= 0:
            idx = np.unravel_index(np.argmax(-s), s.shape)
            r = max(-s[idx], cell)
        centers.append(origin + np.asarray(idx) * cell)
        radii.append(max(r, cell))
        # suppress the covered neighborhood
        d = np.linalg.norm((grid_idx - np.asarray(idx)) * cell, axis=-1)
        s = np.where(d < r, 1.0e6, s)
    return np.asarray(centers, dtype=np.float32), np.asarray(radii, dtype=np.float32)


def _fit_problem(mesh: gt.MeshObstacle, cfg: SphereFitConfig, dev, dtype=torch.float32):
    """The baked SDF, the voxel seeds and the loss over (centers, raw radii).
    The grid, its origin and the surface samples hold float32 values in any
    `dtype`, as in the JAX package."""
    sdf_grid, origin, cell = mesh_to_sdf_grid(mesh)
    centers0, radii0 = voxel_init(sdf_grid, origin, cell, cfg.n_spheres)
    grid = torch.as_tensor(sdf_grid, device=dev).to(dtype)
    org = torch.as_tensor(origin, device=dev).to(dtype)

    # surface samples for the coverage loss: voxels near sdf=0
    near = np.argwhere(np.abs(sdf_grid) < cell)
    if len(near) > 512:
        near = near[np.random.RandomState(0).choice(len(near), 512, replace=False)]
    surf = torch.as_tensor(origin + near * cell, dtype=torch.float32, device=dev).to(dtype)
    eye = torch.eye(cfg.n_spheres, dtype=dtype, device=dev)
    min_r = torch.tensor(cfg.min_radius, dtype=dtype, device=dev)

    def loss(c, r_raw):
        r = torch.maximum(r_raw, min_r)
        sd = sample_voxel_grid(grid, c, org, cell, outside_value=1.0)
        # outside: the sphere must fit inside the mesh, sdf(c) <= -r
        l_out = ((sd + r).clamp_min(0.0) ** 2).sum()
        # coverage: each surface sample close to some sphere surface (safe
        # norm: a finite gradient where a sample sits on a centre)
        d = torch.sqrt(((surf[:, None] - c[None]) ** 2).sum(dim=-1) + 1e-12) - r[None]
        l_cov = (d.amin(dim=-1).clamp_min(0.0) ** 2).sum()
        # overlap: penalize deeply contained sphere pairs (diagonal masked)
        cc = torch.sqrt(((c[:, None] - c[None]) ** 2).sum(dim=-1) + 1e-12)
        contained = (r[:, None] - (cc + r[None])).clamp_min(0.0) * (1.0 - eye)
        l_ov = (contained ** 2).sum() / 2.0
        # tangency: each sphere's nearest neighbor should touch it
        gap = cc - (r[:, None] + r[None]) + _BIG_DIAG * eye
        l_tan = (gap.amin(dim=-1).clamp_min(0.0) ** 2).sum()
        return (cfg.outside_weight * l_out + cfg.coverage_weight * l_cov
                + cfg.overlap_weight * l_ov + cfg.tangency_weight * l_tan)

    return centers0, radii0, loss


def fit_spheres_to_mesh(mesh: gt.MeshObstacle, cfg: SphereFitConfig = SphereFitConfig(),
                        device=None, dtype=torch.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (centers (K, 3), radii (K,)) in the mesh's local frame, as
    `dtype` (the fit's parameters and Adam state). ``device=None`` is the
    CUDA device (raises when there is none)."""
    dev = resolve_device(device)
    centers0, radii0, loss = _fit_problem(mesh, cfg, dev, dtype)
    c = torch.tensor(centers0, dtype=dtype, device=dev, requires_grad=True)
    r_raw = torch.tensor(radii0, dtype=dtype, device=dev, requires_grad=True)
    opt = torch.optim.Adam([c, r_raw], lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(cfg.n_iters):
        opt.zero_grad()
        loss(c, r_raw).backward()
        opt.step()
    with torch.no_grad():
        r = r_raw.clamp_min(cfg.min_radius)
    return c.detach().cpu().numpy(), r.cpu().numpy()


def estimate_sphere_count(mesh: gt.MeshObstacle, target_ratio: float = 0.02) -> int:
    """Heuristic sphere budget from mesh extents vs voxel size."""
    sdf_grid, _, _ = mesh_to_sdf_grid(mesh)
    interior = int((sdf_grid < 0).sum())
    return int(np.clip(interior * target_ratio, 1, 64))
