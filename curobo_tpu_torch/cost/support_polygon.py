"""Support-polygon balance cost for legged and humanoid robots (PyTorch).

Counterpart of `curobo_tpu/cost/support_polygon.py`: keeps the robot's centre
of mass, projected to the ground plane, inside the convex hull of its
foot-contact spheres. The hull is built once on the host (numpy monotone
chain) from a static stance and baked into the rollout config as a tuple of
vertices (`configure_rollout`); the signed distance and the cost are tensor
operations over a fixed vertex table, differentiable by autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SupportPolygonConfig:
    """foot_sphere_indices: indices into the robot's collision-sphere table
    whose (x, y) projections span the support region."""

    weight: float = 0.0  # 0 disables the term
    foot_sphere_indices: Tuple[int, ...] = ()
    # alternative to explicit indices: links whose spheres are the feet;
    # resolved by `stance_hull`
    foot_link_names: Tuple[str, ...] = ()
    padding: float = 0.05  # hull inflation
    # linear pull toward a margin_target clearance from the hull boundary,
    # even while balanced
    inside_cost_weight: float = 0.001
    margin_target: float = 0.1


def convex_hull_2d(points: np.ndarray, padding: float = 0.0) -> np.ndarray:
    """CCW convex hull of (N, 2) points by Andrew's monotone chain, with
    optional outward padding (vertices pushed radially from the centroid).

    Returns (V, 2) float32 vertices in CCW order.
    """
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[-1] != 2:
        raise ValueError(f"expected (N, 2) points, got {pts.shape}")
    pts = np.unique(pts, axis=0)
    if pts.shape[0] < 3:
        hull = pts
    else:
        pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

        def cross2(o, a, b):
            return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

        def half(seq):
            out = []
            for p in seq:
                while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                    out.pop()
                out.append(p)
            return out

        lower = half(pts)
        upper = half(pts[::-1])
        hull = np.asarray(lower[:-1] + upper[:-1])
    if padding != 0.0 and hull.shape[0] >= 1:
        c = hull.mean(axis=0)
        d = hull - c
        n = np.linalg.norm(d, axis=-1, keepdims=True)
        hull = hull + padding * d / np.maximum(n, 1e-9)
    return hull.astype(np.float32)


def signed_distance_to_hull(p_xy: torch.Tensor, hull: torch.Tensor) -> torch.Tensor:
    """Exact signed distance from points (..., 2) to a CCW convex polygon
    (V, 2): negative inside, positive outside. Repeated vertices (zero-length
    edges) fall back to the vertex distance and never flip the inside test."""
    a = hull  # (V, 2)
    e = torch.roll(hull, -1, dims=0) - a  # (V, 2)
    pa = p_xy[..., None, :] - a  # (..., V, 2)
    ee = (e * e).sum(dim=-1)  # (V,)
    t = (pa * e).sum(dim=-1) / ee.clamp_min(1e-12)
    t = t.clamp(0.0, 1.0) * (ee > 1e-12).to(t.dtype)
    closest = a + t[..., None] * e  # (..., V, 2)
    d_min = torch.linalg.vector_norm(p_xy[..., None, :] - closest, dim=-1).amin(dim=-1)
    cross = e[..., 0] * pa[..., 1] - e[..., 1] * pa[..., 0]  # (..., V)
    inside = torch.all(cross >= -1e-9, dim=-1)
    return torch.where(inside, -d_min, d_min)


def support_polygon_cost(
    com_xy: torch.Tensor,  # (..., 2) ground-projected centre of mass
    hull: torch.Tensor,  # (V, 2) CCW
    cfg: SupportPolygonConfig,
) -> torch.Tensor:
    """Balance penalty (...,). Outside the hull: the exit distance. Inside
    (with inside_cost_weight > 0): a small linear pull until the centre of
    mass is margin_target clear of the boundary."""
    sd = signed_distance_to_hull(com_xy, hull)
    if cfg.inside_cost_weight > 0.0:
        inside_c = cfg.inside_cost_weight * (cfg.margin_target + sd).clamp_min(0.0)
        c = torch.where(sd < 0.0, inside_c, sd)
    else:
        c = sd.clamp_min(0.0)
    return cfg.weight * c


def foot_indices_from_links(params, link_names) -> Tuple[int, ...]:
    """Collision-sphere indices attached to the named foot links."""
    want = {params.link_names.index(name) for name in link_names}
    return tuple(i for i, li in enumerate(params.sphere_link_idx) if li in want)


def stance_hull(params, q_stance, cfg: SupportPolygonConfig) -> torch.Tensor:
    """The (V, 2) support hull from the foot spheres of a stance
    configuration, built on the host once per task, on the robot's device."""
    from curobo_tpu_torch.robot.kinematics import compute_kinematics

    idx = cfg.foot_sphere_indices
    if not idx and cfg.foot_link_names:
        idx = foot_indices_from_links(params, cfg.foot_link_names)
    if not idx:
        raise ValueError("support polygon needs foot spheres or foot links")
    if isinstance(q_stance, torch.Tensor):
        q = q_stance.to(device=params.device, dtype=torch.float32)
    else:
        q = torch.as_tensor(np.asarray(q_stance, np.float32), device=params.device)
    with torch.no_grad():
        st = compute_kinematics(params, q)
    feet = st.spheres[..., list(idx), :2].cpu().numpy().reshape(-1, 2)
    return torch.as_tensor(convex_hull_2d(feet, padding=cfg.padding), device=params.device)


def configure_rollout(rollout_cfg, params, q_stance):
    """A rollout config with `support_hull` baked from the stance; unchanged
    when the support-polygon term is off. The hull is a tuple of (x, y), so
    the config stays hashable."""
    sp = rollout_cfg.support_polygon
    if sp is None or sp.weight <= 0.0:
        return rollout_cfg
    hull = stance_hull(params, q_stance, sp).cpu().numpy()
    return dataclasses.replace(rollout_cfg, support_hull=tuple(map(tuple, hull.tolist())))
