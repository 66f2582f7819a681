"""Optimizer registry and the gradient-descent / nonlinear-CG / L-SR1
variants that complete the optimizer menu.

Counterpart of `curobo_tpu/opt/factory.py`: the registry (lbfgs,
gradient_descent, line_search_gradient_descent, conjugate_gradient, lsr1,
mppi, es, scipy, torch) over one batched contract: cost_fn maps (..., D) ->
(...,) and may be called with one extra LEADING candidate axis (the line
search folds its candidates there, MPPI and ES their particles). Gradients
come from autograd unless a ``cost_grad_fn`` (x -> (cost, grad), the same
contract) is given. The random methods take a `torch.Generator` where the
JAX package takes a PRNG key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from curobo_tpu_torch.opt.es import ESConfig, es_optimize
from curobo_tpu_torch.opt.external import (
    ScipyOptConfig,
    TorchOptConfig,
    scipy_optimize,
    torch_optimize,
)
from curobo_tpu_torch.opt.lbfgs import (
    LBFGSConfig,
    LineSearchConfig,
    _line_search,
    cost_grad_of,
    lbfgs_optimize,
)
from curobo_tpu_torch.opt.mppi import MPPIConfig, mppi_optimize

Tensor = torch.Tensor


def _clamp_dir(d, max_step, eps):
    dn = d.abs().amax(dim=-1, keepdim=True)
    return d * torch.clamp(max_step / dn.clamp_min(eps), max=1.0)


class _Loop:
    """What the three line-search methods share: the cost-and-gradient
    function, the projection onto the bounds, the line-search scales as a
    tensor, and the end (the best point projected and evaluated again)."""

    def __init__(self, cost_fn, x0, cfg, lower, upper, cost_grad_fn):
        self.cg = cost_grad_fn if cost_grad_fn is not None else cost_grad_of(cost_fn)
        self.lower, self.upper = lower, upper
        self.ls = cfg.line_search
        self.scales = torch.tensor(cfg.line_search.scales, dtype=x0.dtype, device=x0.device)

    def project(self, x):
        return torch.clamp(x, self.lower, self.upper) if self.lower is not None else x

    def search(self, x, d, c, g):
        return _line_search(self.cg, x, d, c, g, self.ls, self.scales)

    def finish(self, best_x, best_c):
        if self.lower is not None:
            best_x = self.project(best_x)
            best_c, _ = self.cg(best_x)
        return best_x, best_c


@dataclasses.dataclass(frozen=True)
class GDConfig:
    """(Line-search) gradient descent."""

    n_iters: int = 100
    line_search: LineSearchConfig = LineSearchConfig()
    max_step: float = 1.0
    epsilon: float = 1e-8


def gd_optimize(
    cost_fn, x0, cfg: GDConfig, lower=None, upper=None, cost_grad_fn=None
) -> Tuple[Tensor, Tensor]:
    loop = _Loop(cost_fn, x0, cfg, lower, upper, cost_grad_fn)
    x = loop.project(x0.detach())
    c, g = loop.cg(x)
    best_x, best_c = x, c
    for _ in range(cfg.n_iters):
        d = _clamp_dir(-g, cfg.max_step, cfg.epsilon)
        x, c, g = loop.search(x, d, c, g)
        improved = c < best_c
        best_x = torch.where(improved[..., None], x, best_x)
        best_c = torch.minimum(c, best_c)
    return loop.finish(best_x, best_c)


@dataclasses.dataclass(frozen=True)
class CGConfig:
    """Polak-Ribiere+ nonlinear conjugate gradient."""

    n_iters: int = 100
    line_search: LineSearchConfig = LineSearchConfig()
    max_step: float = 1.0
    epsilon: float = 1e-8


def cg_optimize(
    cost_fn, x0, cfg: CGConfig, lower=None, upper=None, cost_grad_fn=None
) -> Tuple[Tensor, Tensor]:
    loop = _Loop(cost_fn, x0, cfg, lower, upper, cost_grad_fn)
    x = loop.project(x0.detach())
    c, g = loop.cg(x)
    d = -g
    best_x, best_c = x, c
    for _ in range(cfg.n_iters):
        step_dir = _clamp_dir(d, cfg.max_step, cfg.epsilon)
        x_new, c_new, g_new = loop.search(x, step_dir, c, g)
        # Polak-Ribiere+ restart: beta = max(0, g1.(g1-g0)/g0.g0)
        beta = (g_new * (g_new - g)).sum(dim=-1) / (g * g).sum(dim=-1).clamp_min(cfg.epsilon)
        beta = beta.clamp_min(0.0)
        d_new = -g_new + beta[..., None] * d
        # safeguard: restart with steepest descent if not a descent direction
        descent = (d_new * g_new).sum(dim=-1) < 0
        d = torch.where(descent[..., None], d_new, -g_new)
        improved = c_new < best_c
        best_x = torch.where(improved[..., None], x_new, best_x)
        best_c = torch.minimum(c_new, best_c)
        x, c, g = x_new, c_new, g_new
    return loop.finish(best_x, best_c)


@dataclasses.dataclass(frozen=True)
class LSR1Config:
    """Limited-memory SR1 quasi-Newton. SR1 admits indefinite curvature
    updates (better on saddle-rich landscapes than BFGS's positive-definite
    ones); the line search keeps the step globally safe."""

    history: int = 8
    n_iters: int = 60
    line_search: LineSearchConfig = LineSearchConfig()
    max_step: float = 1.0
    epsilon: float = 1e-8
    skip_tol: float = 1e-8  # |u.y| > tol * |u| |y| update guard


def _sr1_direction(g, S, Y, valid, eps, skip_tol):
    """d = -H g where H applies m SR1 updates to gamma*I.

    H_i = H_{i-1} + u_i u_i^T / (u_i . y_i), u_i = s_i - H_{i-1} y_i.
    The u_i are built oldest-to-newest (each needs H_{i-1} y_i, i.e. all
    previous u's): O(m^2) batched dot products, m is small.
    """
    m = S.shape[0]
    sy = (S[m - 1] * Y[m - 1]).sum(dim=-1)
    yy = (Y[m - 1] * Y[m - 1]).sum(dim=-1)
    gamma = torch.where(valid[m - 1] > 0, sy / yy.clamp_min(eps), torch.ones_like(sy))
    gamma = gamma.abs() + eps  # keep the seed positive

    us = []
    denoms = []
    for i in range(m):
        hv = gamma[..., None] * Y[i]
        for j in range(i):
            coef = (us[j] * Y[i]).sum(dim=-1) * denoms[j]
            hv = hv + coef[..., None] * us[j]
        u = S[i] - hv
        uy = (u * Y[i]).sum(dim=-1)
        # SR1 skip rule: tiny |u.y| makes the update unstable
        un = torch.sqrt((u * u).sum(dim=-1))
        yn = torch.sqrt((Y[i] * Y[i]).sum(dim=-1))
        ok = (uy.abs() > skip_tol * un * yn) & (valid[i] > 0)
        denom = torch.where(ok, 1.0 / torch.where(ok, uy, torch.ones_like(uy)),
                            torch.zeros_like(uy))
        us.append(u)
        denoms.append(denom)

    hg = gamma[..., None] * g
    for j in range(m):
        coef = (us[j] * g).sum(dim=-1) * denoms[j]
        hg = hg + coef[..., None] * us[j]
    return -hg


def lsr1_optimize(
    cost_fn, x0, cfg: LSR1Config, lower=None, upper=None, cost_grad_fn=None
) -> Tuple[Tensor, Tensor]:
    loop = _Loop(cost_fn, x0, cfg, lower, upper, cost_grad_fn)
    batch_shape = tuple(x0.shape[:-1])
    D = x0.shape[-1]
    m = cfg.history
    x = loop.project(x0.detach())
    c, g = loop.cg(x)
    S = x.new_zeros((m,) + batch_shape + (D,))
    Y = x.new_zeros((m,) + batch_shape + (D,))
    valid = x.new_zeros((m,) + batch_shape)
    best_x, best_c = x, c
    for _ in range(cfg.n_iters):
        d = _sr1_direction(g, S, Y, valid, cfg.epsilon, cfg.skip_tol)
        descent = (d * g).sum(dim=-1) < 0
        d = torch.where(descent[..., None], d, -g)
        d = _clamp_dir(d, cfg.max_step, cfg.epsilon)
        x_new, c_new, g_new = loop.search(x, d, c, g)
        s = x_new - x
        y = g_new - g
        moved = (s * s).sum(dim=-1) > 1e-16
        zero = torch.zeros_like(s)
        S = torch.cat([S[1:], torch.where(moved[..., None], s, zero)[None]], dim=0)
        Y = torch.cat([Y[1:], torch.where(moved[..., None], y, zero)[None]], dim=0)
        valid = torch.cat([valid[1:], moved.to(x.dtype)[None]], dim=0)
        improved = c_new < best_c
        best_x = torch.where(improved[..., None], x_new, best_x)
        best_c = torch.minimum(c_new, best_c)
        x, c, g = x_new, c_new, g_new
    return loop.finish(best_x, best_c)


# ---------------------------------------------------------------------------
# Registry: name -> (config class, runner(cost_fn, x0, cfg, lower, upper,
# generator, cost_grad_fn))
# ---------------------------------------------------------------------------
def _default_generator(x0):
    return torch.Generator(device=x0.device).manual_seed(0)


def _run_lbfgs(cost_fn, x0, cfg, lower, upper, generator, cost_grad_fn):
    return lbfgs_optimize(cost_fn, x0, cfg, lower, upper, cost_grad_fn)


def _run_gd(cost_fn, x0, cfg, lower, upper, generator, cost_grad_fn):
    return gd_optimize(cost_fn, x0, cfg, lower, upper, cost_grad_fn)


def _run_cg(cost_fn, x0, cfg, lower, upper, generator, cost_grad_fn):
    return cg_optimize(cost_fn, x0, cfg, lower, upper, cost_grad_fn)


def _run_lsr1(cost_fn, x0, cfg, lower, upper, generator, cost_grad_fn):
    return lsr1_optimize(cost_fn, x0, cfg, lower, upper, cost_grad_fn)


def _run_mppi(cost_fn, x0, cfg, lower, upper, generator, cost_grad_fn):
    return mppi_optimize(cost_fn, x0, generator or _default_generator(x0), cfg, lower, upper)


def _run_es(cost_fn, x0, cfg, lower, upper, generator, cost_grad_fn):
    return es_optimize(cost_fn, x0, generator or _default_generator(x0), cfg, lower, upper)


def _run_scipy(cost_fn, x0, cfg, lower, upper, generator, cost_grad_fn):
    return scipy_optimize(cost_fn, x0, cfg, lower, upper, cost_grad_fn)


def _run_torch(cost_fn, x0, cfg, lower, upper, generator, cost_grad_fn):
    return torch_optimize(cost_fn, x0, cfg, lower, upper, cost_grad_fn)


OPTIMIZERS = {
    "lbfgs": (LBFGSConfig, _run_lbfgs),
    "gradient_descent": (GDConfig, _run_gd),
    "line_search_gradient_descent": (GDConfig, _run_gd),
    "conjugate_gradient": (CGConfig, _run_cg),
    "lsr1": (LSR1Config, _run_lsr1),
    "mppi": (MPPIConfig, _run_mppi),
    "es": (ESConfig, _run_es),
    "scipy": (ScipyOptConfig, _run_scipy),
    "torch": (TorchOptConfig, _run_torch),
}


def _entry(name: str):
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name]


def make_config(name: str, **kwargs):
    """Build the config dataclass registered under ``name``."""
    return _entry(name)[0](**kwargs)


def optimize(
    name: str,
    cost_fn: Callable[[Tensor], Tensor],
    x0: Tensor,
    cfg=None,
    lower: Optional[Tensor] = None,
    upper: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    cost_grad_fn: Optional[Callable] = None,
) -> Tuple[Tensor, Tensor]:
    """Run a registered optimizer by name -> (x_best, cost_best). The random
    methods (mppi, es) draw from ``generator``, by default a generator on
    x0's device seeded with 0."""
    cfg_cls, run = _entry(name)
    if cfg is None:
        cfg = cfg_cls()
    return run(cost_fn, x0, cfg, lower, upper, generator, cost_grad_fn)
