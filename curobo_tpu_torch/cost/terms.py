"""Cost term configuration: pose / c-space / bounds / collision.

Counterpart of `curobo_tpu/cost/terms.py`: the config dataclasses (fields and
defaults equal). The IK objective itself lives in `ops/ik_kernels.py` (kernels
and their plain versions); the stand-alone term functions come with the
generic rollout `RobotRollout.evaluate_*`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PoseCostConfig:
    position_weight: float = 50.0
    rotation_weight: float = 30.0
    # Optional per-axis weights (len-3 tuples); None = isotropic.
    position_axis_weight: Optional[Tuple[float, float, float]] = None
    rotation_axis_weight: Optional[Tuple[float, float, float]] = None
    # square-root-of-quadratic (metric-like) vs quadratic accumulation
    quadratic: bool = True


@dataclasses.dataclass(frozen=True)
class CSpaceCostConfig:
    weight: float = 50.0


@dataclasses.dataclass(frozen=True)
class BoundCostConfig:
    weight: float = 5000.0
    # fraction of the range used as soft margin from each limit
    margin: float = 0.0
    velocity_weight: float = 0.0
    acceleration_weight: float = 0.0
    jerk_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class CollisionCostConfig:
    weight: float = 100.0
    activation_distance: float = 0.025
    # substeps for swept (continuous) collision between horizon steps
    sweep_steps: int = 4
    # motion-aware (speed-metric) scaling of swept cost
    speed_metric: bool = False


@dataclasses.dataclass(frozen=True)
class SelfCollisionCostConfig:
    weight: float = 500.0
    activation_distance: float = 0.0
