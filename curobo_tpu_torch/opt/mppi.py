"""MPPI configuration and the STOMP noise-smoothing matrix.

Counterpart of `curobo_tpu/opt/mppi.py`: `MPPIConfig` (fields and defaults
equal) and `smooth_sample_transform`. The batched optimizer `mppi_optimize`
waits with the non-kernel solver route; the IK and trajectory solves run their
MPPI stages inside the `ik_solve` and `traj_solve` kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
