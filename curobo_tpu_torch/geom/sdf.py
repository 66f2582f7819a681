"""Analytic signed-distance primitives (PyTorch).

Counterpart of `curobo_tpu/geom/sdf.py`. Convention: sdf(x) > 0 outside the
obstacle, < 0 inside. Batched over arbitrary leading dims; differentiable by
autograd. Voxel-grid sampling waits for the perception slice.
"""

from __future__ import annotations

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
