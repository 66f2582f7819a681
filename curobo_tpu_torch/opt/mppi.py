"""MPPI configuration.

Counterpart of `curobo_tpu/opt/mppi.py`: only `MPPIConfig` (fields and
defaults equal) is ported, because `IKConfig` holds it. The batched optimizer
`mppi_optimize` waits with the non-kernel solver route; the IK solve runs its
MPPI stage inside the `ik_solve` kernel.
"""

from __future__ import annotations

import dataclasses


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
