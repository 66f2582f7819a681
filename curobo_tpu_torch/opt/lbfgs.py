"""L-BFGS configuration.

Counterpart of `curobo_tpu/opt/lbfgs.py`: only the config dataclasses (fields
and defaults equal) are ported, because `IKConfig` holds them. The batched
optimizer `lbfgs_optimize` waits with the non-kernel solver route; the IK
solve runs its L-BFGS inside the `ik_solve` kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


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
