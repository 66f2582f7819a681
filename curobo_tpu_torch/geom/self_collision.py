"""Self-collision distance over a precomputed sphere-pair list (PyTorch).

Counterpart of `curobo_tpu/geom/self_collision.py`: gather + pairwise
distance + masked reduction with index tensors. The chunked scan for
humanoid-scale pair lists waits for the humanoid slice.
"""

from __future__ import annotations

import torch

from curobo_tpu_torch.robot.params import SelfCollisionParams


def _pair_dist(sc: SelfCollisionParams, spheres: torch.Tensor) -> torch.Tensor:
    pos = spheres[..., :3]
    ca = pos[..., sc.pair_a.long(), :]
    cb = pos[..., sc.pair_b.long(), :]
    d2 = torch.sum((ca - cb) ** 2, dim=-1)
    return torch.sqrt(d2.clamp_min(1e-12))


def self_collision_distance(sc: SelfCollisionParams, spheres: torch.Tensor) -> torch.Tensor:
    """Max pairwise violation (...,): margin - distance, clipped at 0.
    spheres: (..., S, 4). 0 = clear."""
    if sc.pair_a.shape[0] == 0:
        return spheres.new_zeros(spheres.shape[:-2])
    dist = _pair_dist(sc, spheres)
    return (sc.pair_margin - dist).clamp_min(0.0).amax(dim=-1)
