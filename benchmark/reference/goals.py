"""Inputs that the reference makes from a seed: collision-free joint
configurations drawn uniformly within the joint limits, and their tool
poses (the goals of the IK cells)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import scene
from benchmark.reference.robot import F64, Robot


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of one input stream of a run keyed by `seed` (any whole
    number)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def collision_free(robot: Robot, obstacles: List[Dict], n: int, rng: np.random.Generator,
                   chunk: int = 4096) -> torch.Tensor:
    """n configurations (n, D) float64, uniform within the position limits,
    with no sphere inside an obstacle and no self-collision pair closer than
    its margin."""
    lo, hi = robot.lower.cpu().numpy(), robot.upper.cpu().numpy()
    out, have = [], 0
    while have < n:
        q = torch.as_tensor(lo + (hi - lo) * rng.random((chunk, robot.n_dof)), dtype=F64,
                            device=robot.device)
        c = robot.spheres(q)
        ok = (robot.self_slack(c) >= 0) & (scene.clearance(c, robot.sphere_radius, obstacles) >= 0)
        out.append(q[ok])
        have += int(ok.sum())
    return torch.cat(out)[:n]
