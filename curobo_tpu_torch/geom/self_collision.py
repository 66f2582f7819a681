"""Self-collision distance over a precomputed sphere-pair list (PyTorch).

Counterpart of `curobo_tpu/geom/self_collision.py`: gather + pairwise
distance + masked reduction with index tensors. The pair distance is
``sqrt(max(d2, 1e-12))`` as in the JAX generic path (the kernels use
``sqrt(d2 + 1e-12)``). The chunked scan for humanoid-scale pair lists waits
for the humanoid slice.
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


def self_collision_cost(
    sc: SelfCollisionParams, spheres: torch.Tensor, activation_distance: float = 0.0
) -> torch.Tensor:
    """Summed pair violation (...,) for optimization: sum over pairs of
    max(margin + activation - distance, 0)."""
    if sc.pair_a.shape[0] == 0:
        return spheres.new_zeros(spheres.shape[:-2])
    dist = _pair_dist(sc, spheres)
    return (sc.pair_margin + activation_distance - dist).clamp_min(0.0).sum(dim=-1)
