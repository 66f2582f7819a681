"""Optimizer debug recorder: capture per-iteration traces for analysis.

Counterpart of `curobo_tpu/opt/debug.py`: a host-side trace store and a plain
gradient-descent run that records its cost curve and gradient norms, for
diagnosing cost shaping.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class DebugRecorder:
    """Host-side iteration trace store (values copied to numpy)."""

    traces: Dict[str, List[np.ndarray]] = dataclasses.field(default_factory=dict)

    def add(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        self.traces.setdefault(name, []).append(np.asarray(value))

    def stacked(self, name: str) -> np.ndarray:
        return np.stack(self.traces[name])

    def clear(self) -> None:
        self.traces.clear()

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, vals in self.traces.items():
            arr = np.stack(vals)
            out[name] = {
                "n": len(vals),
                "first": float(arr.reshape(len(vals), -1).mean(-1)[0]),
                "last": float(arr.reshape(len(vals), -1).mean(-1)[-1]),
                "min": float(arr.min()),
            }
        return out


def record_gradient_descent(
    cost_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    n_iters: int,
    lr: float = 1e-2,
) -> DebugRecorder:
    """Plain gradient descent with a full per-iteration trace (cost curve and
    gradient norms per problem of the leading axis)."""
    rec = DebugRecorder()
    x = x0.detach()
    for _ in range(n_iters):
        xx = x.requires_grad_(True)
        c = cost_fn(xx)
        (g,) = torch.autograd.grad(c.sum(), xx)
        x = (xx - lr * g).detach()
        rec.add("cost", c)
        rec.add("grad_norm", torch.linalg.vector_norm(g.reshape(g.shape[0], -1), dim=-1))
    rec.add("x_final", x)
    return rec
