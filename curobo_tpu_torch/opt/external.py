"""External optimizer adapters: scipy on the host, `torch.optim` on the
cost's device.

Counterpart of `curobo_tpu/opt/external.py`: wrap a general-purpose optimizer
around the same batched cost contract the package's optimizers use
(``cost_fn`` maps ``(..., D) -> (...)`` and accepts a leading batch axis), for
small offline problems or as a convergence oracle in tests. Gradients come
from autograd unless ``cost_grad_fn`` (x -> (cost, grad)) is given.

- `scipy_optimize` solves problem by problem on the host; problem i's cost
  and gradient are row i of one call of ``cost_fn`` on the batch (x0's
  device) whose row i is scipy's point, so a cost with per-problem constants
  (goals) is held to problem i's. The JAX adapter calls ``cost_fn`` on the
  point alone, at batch position 0, so there every problem is solved
  against problem 0's constants.
- `torch_optimize` applies a `torch.optim` rule to the whole batch at once on
  x0's device (the JAX package keeps the cost on its device and the update
  on the host; here both are on the device).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from curobo_tpu_torch.opt.lbfgs import cost_grad_of

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ScipyOptConfig:
    """scipy.optimize.minimize settings."""

    method: str = "L-BFGS-B"
    max_iters: int = 200
    tol: Optional[float] = None


def scipy_optimize(
    cost_fn: Callable[[Tensor], Tensor],
    x0: Tensor,
    cfg: ScipyOptConfig = ScipyOptConfig(),
    lower: Optional[Tensor] = None,
    upper: Optional[Tensor] = None,
    cost_grad_fn: Optional[Callable] = None,
) -> Tuple[Tensor, Tensor]:
    """Minimize per problem with scipy -> (x_best, cost_best) on x0's device.

    ``x0``: (..., D); bounds broadcast against the trailing D axis.
    """
    from scipy.optimize import minimize

    x0 = torch.as_tensor(x0, dtype=torch.float32)
    dev = x0.device
    batch_shape, D = tuple(x0.shape[:-1]), x0.shape[-1]
    start = x0.reshape(-1, D).detach()
    flat = start.cpu().numpy().astype(np.float64)
    cg = cost_grad_fn if cost_grad_fn is not None else cost_grad_of(cost_fn)

    def fun_of(i):
        def fun(z):
            x = start.clone()
            x[i] = torch.as_tensor(z, dtype=torch.float32, device=dev)
            c, g = cg(x.reshape(*batch_shape, D))
            return (float(c.reshape(-1)[i]),
                    g.reshape(-1, D)[i].detach().cpu().numpy().astype(np.float64))

        return fun

    def host(b, fill):
        a = np.asarray(fill if b is None else torch.as_tensor(b).cpu().numpy(), np.float64)
        return np.broadcast_to(a, (D,))

    bounds = None
    if lower is not None or upper is not None:
        bounds = list(zip(host(lower, -np.inf), host(upper, np.inf)))

    xs, cs = [], []
    for i, z in enumerate(flat):
        r = minimize(
            fun_of(i), z, jac=True, method=cfg.method, bounds=bounds, tol=cfg.tol,
            options={"maxiter": cfg.max_iters},
        )
        xs.append(r.x)
        cs.append(r.fun)
    x_best = torch.as_tensor(np.asarray(xs), dtype=torch.float32, device=dev)
    c_best = torch.as_tensor(np.asarray(cs), dtype=torch.float32, device=dev)
    return x_best.reshape(*batch_shape, D), c_best.reshape(batch_shape)


@dataclasses.dataclass(frozen=True)
class TorchOptConfig:
    """torch.optim settings. The whole batch is optimized jointly (sum of
    per-problem costs; gradients stay per problem because problems are
    independent), with a per-problem best tracker."""

    method: str = "adam"  # adam | lbfgs | sgd
    max_iters: int = 100
    lr: float = 0.1


def torch_optimize(
    cost_fn: Callable[[Tensor], Tensor],
    x0: Tensor,
    cfg: TorchOptConfig = TorchOptConfig(),
    lower: Optional[Tensor] = None,
    upper: Optional[Tensor] = None,
    cost_grad_fn: Optional[Callable] = None,
) -> Tuple[Tensor, Tensor]:
    """Minimize with a torch optimizer on x0's device -> (x_best, cost_best).

    Each iteration evaluates cost and gradient at the parameters clipped to
    the bounds, keeps the best point per problem, and hands the gradient to
    the optimizer's update of the unclipped parameters.
    """
    x0 = torch.as_tensor(x0, dtype=torch.float32)
    batch_shape = tuple(x0.shape[:-1])
    cg = cost_grad_fn if cost_grad_fn is not None else cost_grad_of(cost_fn)

    param = x0.detach().clone().requires_grad_(True)
    method = cfg.method.lower()
    if method == "adam":
        opt = torch.optim.Adam([param], lr=cfg.lr)
    elif method == "sgd":
        opt = torch.optim.SGD([param], lr=cfg.lr)
    elif method == "lbfgs":
        opt = torch.optim.LBFGS([param], lr=cfg.lr, max_iter=1, history_size=10)
    else:
        raise ValueError(f"unknown torch method '{cfg.method}'")

    best_x = x0.detach().clone()
    best_c = torch.full(batch_shape, float("inf"), dtype=x0.dtype, device=x0.device)

    for _ in range(cfg.max_iters):
        z = param.detach()
        if lower is not None or upper is not None:
            z = torch.clamp(z, lower, upper)
        c, g = cg(z)
        better = c < best_c
        best_c = torch.where(better, c, best_c)
        best_x = torch.where(better[..., None], z, best_x)

        def closure(c=c, g=g):
            opt.zero_grad()
            param.grad = g.detach().clone()
            return c.sum()

        if method == "lbfgs":
            opt.step(closure)
        else:
            closure()
            opt.step()

    return best_x, best_c
