"""Self-collision distance over a precomputed sphere-pair list (PyTorch).

Counterpart of `curobo_tpu/geom/self_collision.py`. The pair distance is
``sqrt(max(d2, 1e-12))`` as in the JAX generic path (the IK kernels use
``sqrt(d2 + 1e-12)``).

The one routing point of the pair sum for every caller (the generic
objective's `self_collision_cost_term`, `RobotSceneCollision`, the PRM, the
retargeter): the positions are laid out sphere-major, (S, 3, N), and a tensor
on the CPU goes through the plain chunked versions, a tensor on a CUDA device
through the hand-written pair kernels (`ops/self_collision_kernels.py`:
`sc_pair_cost` and `sc_pair_grad` for the cost and its gradient,
`sc_pair_viol` for the distance). A missing `nvcc`, a failed build or a
refused launch raises; nothing moves to the plain versions on its own.
"""

from __future__ import annotations

import torch

from curobo_tpu_torch.ops.self_collision_kernels import (
    _sphere_major,
    pair_hinge_sum,
    pair_violation,
)
from curobo_tpu_torch.robot.params import SelfCollisionParams


def self_collision_distance(sc: SelfCollisionParams, spheres: torch.Tensor) -> torch.Tensor:
    """Max pairwise violation (...,): margin - distance, clipped at 0.
    spheres: (..., S, 4). 0 = clear. A metric: no gradient."""
    if sc.pair_a.shape[0] == 0:
        return spheres.new_zeros(spheres.shape[:-2])
    with torch.no_grad():
        v = pair_violation(sc, _sphere_major(spheres))
    return v.reshape(spheres.shape[:-2])


def self_collision_cost(
    sc: SelfCollisionParams, spheres: torch.Tensor, activation_distance: float = 0.0
) -> torch.Tensor:
    """Summed pair violation (...,) for optimization: sum over pairs of
    max(margin + activation - distance, 0)."""
    if sc.pair_a.shape[0] == 0:
        return spheres.new_zeros(spheres.shape[:-2])
    c = pair_hinge_sum(sc, _sphere_major(spheres), float(activation_distance))
    return c.reshape(spheres.shape[:-2])
