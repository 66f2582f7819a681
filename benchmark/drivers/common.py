"""What the drivers share: the configuration's files, its world for the
program, and the sample of answers to check."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def data_path(config: Dict, key: str) -> str:
    return os.path.join(config["_dir"], config[key])


def program_scene(obstacles: List[Dict]):
    """The program's scene of a world specification."""
    from curobo_tpu_torch.geom import types as gt

    scene = gt.Scene()
    for o in obstacles:
        if o["type"] == "cuboid":
            scene.add(gt.Cuboid(name=o["name"], pose=list(o["pose"]), dims=list(o["dims"])))
        elif o["type"] == "sphere":
            scene.add(gt.SphereObstacle(name=o["name"], pose=list(o["pose"]), radius=o["radius"]))
        else:
            raise NotImplementedError(f"obstacle type {o['type']!r}")
    return scene


def sample(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """k of n indices drawn from the seed (all of them where k >= n), sorted."""
    if k >= n:
        return np.arange(n)
    return np.sort(rng.choice(n, size=k, replace=False))


def thresholds(cfg) -> Dict:
    return dict(position=float(cfg.position_threshold), rotation=float(cfg.rotation_threshold))
