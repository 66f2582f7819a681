"""MPPI particle optimizer, its configuration and the STOMP noise smoothing.

Counterpart of `curobo_tpu/opt/mppi.py`: `MPPIConfig` (fields and defaults
equal), `smooth_sample_transform` and `mppi_optimize`, the particle stage of
the non-kernel route. Particles come from a Halton quasi-random normal bank
(bit-equal Halton points, inverse CDF in float64) times per-problem random
sign flips, drawn from an explicit `torch.Generator` (or injected through
`signs=`: the JAX package draws them from its own PRNG, which no generator
here reproduces). The kernel routes run their MPPI inside `ik_solve` and
`traj_solve`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from curobo_tpu_torch.util.sampling import gaussian_halton_bank


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    n_particles: int = 64
    n_iters: int = 16
    temperature: float = 0.05
    init_std: float = 0.4
    # multiplicative std decay per iteration (annealing)
    std_decay: float = 0.9
    min_std: float = 0.01
    # particle 0 copies the mean exactly (null-action particle): no regress
    elite_keep: bool = True
    step_size: float = 0.9


def smooth_sample_transform(n_knots: int, dof: int, reg: float = 1e-4) -> torch.Tensor:
    """STOMP-style smoothness covariance factor over a knot axis (host numpy,
    float64, returned as float32).

    Returns L (n_knots, n_knots) with L L^T proportional to (A^T A + reg I)^-1,
    A the second-difference operator: samples drawn as L @ z concentrate on
    low-acceleration perturbations. Apply per dof:
    eps'[k, d] = sum_j L[k, j] eps[j, d]. MPC and the trajectory kernel's MPPI
    stage take it as `eps_smooth`.
    """
    A = np.zeros((n_knots + 2, n_knots))
    for i in range(n_knots):
        A[i, i] += 1.0
        A[i + 1, i] += -2.0
        A[i + 2, i] += 1.0
    cov = np.linalg.inv(A.T @ A + reg * np.eye(n_knots))
    L = np.linalg.cholesky(cov)
    # normalize so the per-knot marginal std is about 1 (keeps init_std's scale)
    L = L / np.sqrt(np.diag(cov)).max()
    return torch.as_tensor(L, dtype=torch.float32)


@functools.lru_cache(maxsize=16)
def _bank(n: int, dim: int, device: str) -> torch.Tensor:
    """The quasi-random normal bank, built once per shape and device (read
    only; keeps the host-to-device copy out of every call)."""
    return gaussian_halton_bank(n, dim, device=device)


def rademacher_signs(shape, generator: torch.Generator, device, dtype=torch.float32):
    """+1 / -1 with equal odds, drawn on `device` from `generator`."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator, device=device)
    return (2 * bits - 1).to(dtype)


def mppi_optimize(
    cost_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,  # (..., D)
    generator: Optional[torch.Generator],
    cfg: MPPIConfig,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
    eps_transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    signs: Optional[torch.Tensor] = None,  # (..., D) +-1, replaces the draw
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimize cost_fn from x0 -> (x_best (..., D), cost_best (...,)).

    cost_fn maps (..., D) -> (...,) and is also called with a leading particle
    axis: (P, ..., D) -> (P, ...). Particle 0 of every iteration is the mean
    (elite_keep); the result is the best particle ever seen or the final mean,
    whichever costs less. eps_transform optionally correlates the raw normals
    (P, ..., D) before they are scaled by the std (smooth sampling).
    """
    x0 = x0.detach()
    batch_shape = tuple(x0.shape[:-1])
    D = x0.shape[-1]
    P = cfg.n_particles
    nb = len(batch_shape)
    std = torch.full_like(x0, cfg.init_std)

    bank = _bank(cfg.n_iters * P, D, str(x0.device)).to(x0.dtype)
    bank = bank.reshape((cfg.n_iters, P) + (1,) * nb + (D,))
    if signs is None:
        signs = rademacher_signs(batch_shape + (D,), generator, x0.device, x0.dtype)
    elif tuple(signs.shape) != batch_shape + (D,):
        raise ValueError(f"signs must have shape {batch_shape + (D,)}, got {tuple(signs.shape)}")

    with torch.no_grad():
        mean = x0
        best_x, best_c = x0, cost_fn(x0[None])[0]
        for i in range(cfg.n_iters):
            eps = bank[i] * signs  # (P, ..., D)
            if eps_transform is not None:
                eps = eps_transform(eps)
            x = mean + std * eps
            if cfg.elite_keep:
                x = torch.cat([mean[None], x[1:]], dim=0)
            if lower is not None:
                x = torch.clamp(x, lower, upper)
            c = cost_fn(x)  # (P, ...)

            # softmax weights over the particles (leading axis)
            c_min = c.amin(dim=0, keepdim=True)
            w = torch.softmax(-(c - c_min) / cfg.temperature, dim=0)
            new_mean = (w[..., None] * x).sum(dim=0)
            mean = mean + cfg.step_size * (new_mean - mean)
            std = torch.clamp(std * cfg.std_decay, min=cfg.min_std)

            # best particle ever
            cb, i_best = c.min(dim=0)
            xb = torch.gather(x, 0, i_best[None, ..., None].expand((1,) + x.shape[1:]))[0]
            improved = cb < best_c
            best_x = torch.where(improved[..., None], xb, best_x)
            best_c = torch.minimum(cb, best_c)

        # best-ever against the final mean
        c_mean = cost_fn(mean[None])[0]
        use_mean = c_mean < best_c
        return torch.where(use_mean[..., None], mean, best_x), torch.minimum(c_mean, best_c)
