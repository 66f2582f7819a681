"""Rosenbrock toy rollout: the optimizer-protocol demonstrator.

Counterpart of `curobo_tpu/rollout/rosenbrock.py`. A rollout here is a batched
cost function with the leading-candidate-axis contract (`(..., D) -> (...)`),
so this class is both documentation of that contract and a hard non-convex
objective for the `opt/` tests (global minimum at x = a).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RosenbrockConfig:
    dof: int = 2
    a: float = 1.0
    b: float = 100.0


class RosenbrockRollout:
    """Batched N-dimensional Rosenbrock objective.

    cost(x) = sum_i [ b (x_{i+1} - x_i^2)^2 + (a - x_i)^2 ]
    """

    def __init__(self, cfg: RosenbrockConfig = RosenbrockConfig()):
        if cfg.dof < 2:
            raise ValueError("RosenbrockRollout needs dof >= 2")
        self.cfg = cfg

    @property
    def dof(self) -> int:
        return self.cfg.dof

    @property
    def optimum(self) -> torch.Tensor:
        return torch.full((self.cfg.dof,), self.cfg.a, dtype=torch.float32)

    def cost(self, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (...): any batch shape, differentiable by autograd."""
        head, tail = x[..., :-1], x[..., 1:]
        return (self.cfg.b * (tail - head**2) ** 2 + (self.cfg.a - head) ** 2).sum(dim=-1)

    __call__ = cost
