"""Plain reference of a world of primitive obstacles: signed distances of
points to cuboids and spheres, worked out from the world's specification
(centre pose `[x, y, z, qw, qx, qy, qz]`, a cuboid's full extents `dims`, a
sphere's `radius`), never from a table the program compiled."""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference.robot import quat_to_matrix


def signed_distance(points: torch.Tensor, obstacles: List[Dict]) -> torch.Tensor:
    """Least signed distance (...,) of points (..., 3) to the obstacles:
    negative inside one, infinite without obstacles."""
    best = torch.full(points.shape[:-1], float("inf"), dtype=points.dtype, device=points.device)
    for o in obstacles:
        pose = torch.tensor(o["pose"], dtype=points.dtype, device=points.device)
        u = points - pose[:3]
        if o["type"] == "cuboid":
            R = quat_to_matrix(pose[3:])
            local = u @ R  # R^T u, row vectors
            half = torch.tensor(o["dims"], dtype=points.dtype, device=points.device) / 2
            qv = local.abs() - half
            d = torch.linalg.vector_norm(qv.clamp_min(0), dim=-1) + qv.amax(-1).clamp_max(0)
        elif o["type"] == "sphere":
            d = torch.linalg.vector_norm(u, dim=-1) - o["radius"]
        else:
            raise NotImplementedError(f"obstacle type {o['type']!r}")
        best = torch.minimum(best, d)
    return best


def clearance(centres: torch.Tensor, radii: torch.Tensor, obstacles: List[Dict]) -> torch.Tensor:
    """Least clearance (N,) of spheres (N, S, 3) with radii (S,): the signed
    distance of each centre less its radius; negative where a sphere
    penetrates an obstacle."""
    d = signed_distance(centres, obstacles) - radii.to(centres.dtype)
    return d.amin(-1)

