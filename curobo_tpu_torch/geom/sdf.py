"""Analytic signed-distance primitives and voxel-grid sampling (PyTorch).

Counterpart of `curobo_tpu/geom/sdf.py`. Convention: sdf(x) > 0 outside the
obstacle, < 0 inside. Batched over arbitrary leading dims; differentiable by
autograd.
"""

from __future__ import annotations

import functools

import torch


def _safe_norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """norm with finite gradient at 0."""
    return torch.sqrt(torch.sum(v * v, dim=-1) + eps)


def sdf_box(x_local: torch.Tensor, half_dims: torch.Tensor) -> torch.Tensor:
    """Box centred at origin. x_local (..., 3), half_dims (..., 3) -> (...)."""
    q = x_local.abs() - half_dims
    outside = _safe_norm(q.clamp_min(0.0))
    inside = q.amax(dim=-1).clamp_max(0.0)
    return outside + inside


def sdf_sphere(x, center, radius):
    return _safe_norm(x - center) - radius


def sdf_capsule(x, a, b, radius):
    """Capsule with world-space endpoints a, b and given radius."""
    pa = x - a
    ba = b - a
    denom = torch.sum(ba * ba, dim=-1).clamp_min(1e-12)
    h = (torch.sum(pa * ba, dim=-1) / denom).clamp(0.0, 1.0)
    return _safe_norm(pa - ba * h[..., None]) - radius


def sdf_cylinder(x_local, radius, half_height):
    """Capped cylinder along local z, centred at origin."""
    d_r = _safe_norm(x_local[..., :2]) - radius
    d_z = x_local[..., 2].abs() - half_height
    outside = _safe_norm(
        torch.stack([d_r.clamp_min(0.0), d_z.clamp_min(0.0)], dim=-1)
    )
    inside = torch.maximum(d_r, d_z).clamp_max(0.0)
    return outside + inside


# the eight corners of a voxel cell, x fastest: the order of the JAX
# package's gathers, so the trilinear blend adds in the same order
_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


@functools.lru_cache(maxsize=16)
def _grid_tables(shape: tuple, device: torch.device):
    """(corner offsets (8, 3), grid shape (3,)) on `device`, copied there once
    per grid shape: a host-to-device copy waits for the device's queue."""
    return (torch.tensor(_CORNERS, device=device), torch.tensor(shape, device=device))


def sample_voxel_grid(
    grid: torch.Tensor,
    x_local: torch.Tensor,
    origin: torch.Tensor,
    cell_size,
    outside_value: float = 1.0,
) -> torch.Tensor:
    """Trilinear sample of a dense SDF grid.

    grid (X, Y, Z) values, x_local (..., 3) in the grid frame, origin (3,)
    the grid-frame position of voxel (0, 0, 0)'s centre. A corner outside
    the grid reads ``outside_value``, so points near the boundary blend into
    it. Differentiable with respect to x_local (through the cell fraction;
    the floor gives no gradient).
    """
    corners, dims = _grid_tables(tuple(grid.shape), grid.device)
    u = (x_local - origin) / cell_size  # voxel coordinates
    u0 = torch.floor(u)
    frac = u - u0
    idx = u0.long()[..., None, :] + corners  # (..., 8, 3)
    valid = ((idx >= 0) & (idx < dims)).all(dim=-1)
    ic = torch.minimum(idx.clamp_min(0), dims - 1)
    flat = (ic[..., 0] * grid.shape[1] + ic[..., 1]) * grid.shape[2] + ic[..., 2]
    v = torch.where(valid, grid.reshape(-1)[flat], outside_value)  # (..., 8)
    fx, fy, fz = (frac[..., k, None] for k in range(3))
    c = v[..., 0::2] * (1 - fx) + v[..., 1::2] * fx  # c00, c10, c01, c11
    c = c[..., 0::2] * (1 - fy) + c[..., 1::2] * fy  # c0, c1
    return c[..., 0] * (1 - fz[..., 0]) + c[..., 1] * fz[..., 0]
