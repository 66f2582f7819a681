"""Batched L-BFGS with a parallel multi-candidate Wolfe line search.

Counterpart of `curobo_tpu/opt/lbfgs.py`: the config dataclasses (fields and
defaults equal) and `lbfgs_optimize`, the optimizer of the non-kernel route
(goal sets, c-space goals, MPC's generic tick). Every step is a batched
tensor operation over all problems at once; the two-loop recursion runs over
(m, ..., D) history tensors, and the line search folds its L candidates into
one leading axis of a single cost-and-gradient call. Cost and gradient come
from one forward and one backward pass: `torch.autograd.grad` of the summed
cost, which is the per-problem gradient since the problems are independent.
The kernel routes run their own L-BFGS inside `ik_solve` and `traj_solve`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LineSearchConfig:
    # candidate step scales
    scales: Tuple[float, ...] = (0.01, 0.1, 0.3, 0.5, 0.7, 1.0, 1.5)
    armijo_c1: float = 1e-4
    wolfe_c2: float = 0.9
    kind: str = "strong_wolfe"  # greedy | armijo | wolfe | strong_wolfe


@dataclasses.dataclass(frozen=True)
class LBFGSConfig:
    history: int = 15
    n_iters: int = 60
    line_search: LineSearchConfig = LineSearchConfig()
    epsilon: float = 1e-8
    # clamp on the step direction's inf-norm (stability on hard problems)
    max_step: float = 1.0


def _two_loop_direction(
    g: torch.Tensor,  # (..., D)
    S: torch.Tensor,  # (m, ..., D)
    Y: torch.Tensor,  # (m, ..., D)
    rho: torch.Tensor,  # (m, ...)
    valid: torch.Tensor,  # (m, ...) 0/1
    epsilon: float,
) -> torch.Tensor:
    """Two-loop recursion, batched over problems; slot m-1 is the newest pair."""
    m = S.shape[0]
    q = g
    alphas = []
    for i in range(m - 1, -1, -1):
        a = rho[i] * (S[i] * q).sum(dim=-1) * valid[i]
        q = q - a[..., None] * Y[i]
        alphas.append(a)
    alphas = alphas[::-1]

    # initial Hessian scaling from the newest valid pair
    sy = (S[m - 1] * Y[m - 1]).sum(dim=-1)
    yy = (Y[m - 1] * Y[m - 1]).sum(dim=-1)
    gamma = torch.where(valid[m - 1] > 0, sy / yy.clamp_min(epsilon), torch.ones_like(sy))
    r = gamma[..., None] * q

    for i in range(m):
        b = rho[i] * (Y[i] * r).sum(dim=-1) * valid[i]
        r = r + S[i] * (alphas[i] - b)[..., None]
    return -r


def _take0(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[idx[...], ...] along the leading axis: a (L, ...[, D]), idx (...)."""
    i = idx[None]
    if a.ndim > idx.ndim + 1:
        i = i[..., None].expand((1,) + tuple(a.shape[1:]))
    return torch.gather(a, 0, i)[0]


def _line_search(cost_grad_fn, x, d, c0, g0, ls: LineSearchConfig, scales: torch.Tensor):
    """Parallel multi-candidate Wolfe search: all L candidate steps in one
    batched cost-and-gradient call, then per problem the largest candidate
    meeting the conditions, else the cheapest; never a point worse than x.
    `scales` is ls.scales as a tensor on x's device, built once by the caller
    (a host-to-device copy). Returns (x_new, c_new, g_new)."""
    L = len(ls.scales)
    nb = x.ndim - 1
    scales = scales.reshape((L,) + (1,) * nb)
    cand = x[None] + scales[..., None] * d[None]  # (L, ..., D)
    c, g = cost_grad_fn(cand)  # (L, ...), (L, ..., D)

    slope0 = (g0 * d).sum(dim=-1)  # (...,) negative on a descent direction
    gd = (g * d[None]).sum(dim=-1)  # (L, ...)
    armijo = c <= c0[None] + ls.armijo_c1 * scales * slope0[None]
    if ls.kind == "greedy":
        ok = c < c0[None]
    elif ls.kind == "armijo":
        ok = armijo
    elif ls.kind == "wolfe":
        ok = armijo & (gd >= ls.wolfe_c2 * slope0[None])
    else:  # strong_wolfe
        ok = armijo & (gd.abs() <= ls.wolfe_c2 * slope0.abs()[None])

    # largest satisfying index, else the first minimum of the cost
    idx_range = torch.arange(L, device=x.device).reshape((L,) + (1,) * nb)
    best_ok = torch.where(ok, idx_range, torch.full_like(idx_range, -1)).amax(dim=0)
    choice = torch.where(best_ok >= 0, best_ok, torch.argmin(c, dim=0))

    x_new, c_new, g_new = _take0(cand, choice), _take0(c, choice), _take0(g, choice)
    keep = c_new > c0
    x_new = torch.where(keep[..., None], x, x_new)
    c_new = torch.where(keep, c0, c_new)
    g_new = torch.where(keep[..., None], g0, g_new)
    return x_new, c_new, g_new


def cost_grad_of(cost_fn: Callable[[torch.Tensor], torch.Tensor]):
    """(cost, grad) of a batched cost by one forward and one backward pass."""

    def cg(x):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            c = cost_fn(xx)
            (g,) = torch.autograd.grad(c.sum(), xx)
        return c.detach(), g

    return cg


def lbfgs_optimize(
    cost_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,  # (..., D)
    cfg: LBFGSConfig,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
    cost_grad_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimize cost_fn (batched) from x0 -> (x_best, cost_best).

    cost_fn maps (..., D) -> (...,) and is also called with one extra leading
    candidate axis (the line-search fold): (L, ..., D) -> (L, ...); autograd
    derives its gradient unless `cost_grad_fn` (x -> (cost, grad), same
    contract) is given. Candidates are not projected; with bounds, the best
    point is projected once at the end and evaluated again, so the returned
    cost is the cost of the returned point.
    """
    batch_shape = tuple(x0.shape[:-1])
    D = x0.shape[-1]
    m = cfg.history
    cg = cost_grad_fn if cost_grad_fn is not None else cost_grad_of(cost_fn)

    def project(x):
        return torch.clamp(x, lower, upper) if lower is not None else x

    x = project(x0.detach())
    c, g = cg(x)
    S = x.new_zeros((m,) + batch_shape + (D,))
    Y = x.new_zeros((m,) + batch_shape + (D,))
    rho = x.new_zeros((m,) + batch_shape)
    valid = x.new_zeros((m,) + batch_shape)
    best_x, best_c = x, c
    scales = torch.tensor(cfg.line_search.scales, dtype=x.dtype, device=x.device)

    for _ in range(cfg.n_iters):
        d = _two_loop_direction(g, S, Y, rho, valid, cfg.epsilon)
        # safeguard: if not a descent direction, fall back to -g
        descent = (d * g).sum(dim=-1) < 0
        d = torch.where(descent[..., None], d, -g)
        # clamp the step's inf-norm
        dn = d.abs().amax(dim=-1, keepdim=True)
        d = d * torch.clamp(cfg.max_step / dn.clamp_min(cfg.epsilon), max=1.0)

        x_new, c_new, g_new = _line_search(cg, x, d, c, g, cfg.line_search, scales)

        s = x_new - x
        y = g_new - g
        sy = (s * y).sum(dim=-1)
        ok = sy > 1e-10
        new_rho = torch.where(ok, 1.0 / sy.clamp_min(1e-10), torch.zeros_like(sy))
        zero = torch.zeros_like(s)
        # roll the history (newest at slot m-1)
        S = torch.cat([S[1:], torch.where(ok[..., None], s, zero)[None]], dim=0)
        Y = torch.cat([Y[1:], torch.where(ok[..., None], y, zero)[None]], dim=0)
        rho = torch.cat([rho[1:], new_rho[None]], dim=0)
        valid = torch.cat([valid[1:], ok.to(x.dtype)[None]], dim=0)

        improved = c_new < best_c
        best_x = torch.where(improved[..., None], x_new, best_x)
        best_c = torch.minimum(c_new, best_c)
        x, c, g = x_new, c_new, g_new

    if lower is not None:
        best_x = project(best_x)
        best_c, _ = cg(best_x)
    return best_x, best_c
