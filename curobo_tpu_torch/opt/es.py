"""Evolution-strategies particle optimizer (antithetic OpenAI-ES flavor).

Counterpart of `curobo_tpu/opt/es.py`: a rank-based gradient estimate with
antithetic pairs, for rough cost landscapes. The perturbations are the Halton
normal bank (`util/sampling.py`) times per-problem random sign flips drawn
from an explicit `torch.Generator` (the JAX package draws them from its own
PRNG, which no generator here reproduces).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from curobo_tpu_torch.opt.mppi import _bank, rademacher_signs


@dataclasses.dataclass(frozen=True)
class ESConfig:
    n_particles: int = 64  # must be even (antithetic pairs)
    n_iters: int = 16
    init_std: float = 0.3
    std_decay: float = 0.99
    min_std: float = 0.01
    learning_rate: float = 0.5


def es_optimize(
    cost_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,  # (..., D)
    generator: Optional[torch.Generator],
    cfg: ESConfig,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimize cost_fn (leading-particle-axis contract, like mppi) ->
    (x_best (..., D), cost_best (...,))."""
    if cfg.n_particles % 2:
        raise ValueError(f"ESConfig.n_particles must be even, got {cfg.n_particles}")
    x0 = x0.detach()
    batch_shape = tuple(x0.shape[:-1])
    D = x0.shape[-1]
    P = cfg.n_particles
    half = P // 2
    nb = len(batch_shape)

    bank = _bank(cfg.n_iters * half, D, str(x0.device)).to(x0.dtype)
    bank = bank.reshape((cfg.n_iters, half) + (1,) * nb + (D,))
    signs = rademacher_signs(batch_shape + (D,), generator, x0.device, x0.dtype)

    with torch.no_grad():
        mean = x0
        std = torch.full_like(x0, cfg.init_std)
        best_x, best_c = x0, cost_fn(x0[None])[0]
        for i in range(cfg.n_iters):
            eps_h = bank[i] * signs  # (half, ..., D)
            eps = torch.cat([eps_h, -eps_h], dim=0)  # antithetic
            x = mean + std * eps
            if lower is not None:
                x = torch.clamp(x, lower, upper)
            c = cost_fn(x)  # (P, ...)

            # rank-based fitness shaping: lower cost -> higher weight
            order = torch.argsort(c, dim=0, stable=True)
            ranks = torch.argsort(order, dim=0, stable=True).to(x0.dtype)
            w = (P - 1.0 - ranks) / (P - 1.0) - 0.5  # in [-0.5, 0.5]
            # normalized rank-weighted step: magnitude ~ lr * std regardless of P
            step = (w[..., None] * eps).sum(dim=0) / w.abs().sum(dim=0)[..., None]
            mean = mean + cfg.learning_rate * std * step
            if lower is not None:
                mean = torch.clamp(mean, lower, upper)
            std = torch.clamp(std * cfg.std_decay, min=cfg.min_std)

            cb, i_best = c.min(dim=0)
            xb = torch.gather(x, 0, i_best[None, ..., None].expand((1,) + x.shape[1:]))[0]
            improved = cb < best_c
            best_x = torch.where(improved[..., None], xb, best_x)
            best_c = torch.minimum(cb, best_c)

        c_mean = cost_fn(mean[None])[0]
        use_mean = c_mean < best_c
        return torch.where(use_mean[..., None], mean, best_x), torch.minimum(c_mean, best_c)
