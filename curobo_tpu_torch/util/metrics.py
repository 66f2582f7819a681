"""Benchmark metrics containers with percentile aggregation.

Counterpart of `curobo_tpu/util/metrics.py` (robometrics-compatible field
names: success, time percentiles, motion time, jerk, position error), numpy
over host copies of a `MotionPlanResult`'s tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


def _np(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array-like."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class PlanMetrics:
    """Metrics for one planning problem."""

    success: bool
    plan_time: float = 0.0
    solve_time: float = 0.0
    motion_time: float = 0.0
    path_length: float = 0.0
    jerk: float = 0.0
    position_error: float = 0.0  # metres
    rotation_error: float = 0.0  # radians

    @staticmethod
    def from_result(result, index: int, plan_time: Optional[float] = None) -> "PlanMetrics":
        """Build from a MotionPlanResult-like object at problem ``index``."""
        traj = result.trajectory
        q = _np(traj.position[index])
        path_length = float(np.sum(np.linalg.norm(np.diff(q, axis=0), axis=-1)))
        jerk = (
            float(np.max(np.abs(_np(traj.jerk[index]))))
            if traj.jerk is not None
            else 0.0
        )
        return PlanMetrics(
            success=bool(_np(result.success[index])),
            plan_time=plan_time if plan_time is not None else getattr(result, "plan_time", 0.0),
            motion_time=float(_np(result.motion_time[index])),
            path_length=path_length,
            jerk=jerk,
            position_error=float(_np(result.position_error[index])),
            rotation_error=float(_np(result.rotation_error[index])),
        )


@dataclasses.dataclass
class GroupMetrics:
    """Aggregate over many problems (percentile summary)."""

    n: int
    success_rate: float
    plan_time_mean: float
    plan_time_median: float
    plan_time_p75: float
    plan_time_p98: float
    motion_time_mean: float
    path_length_mean: float
    jerk_mean: float
    position_error_mean: float
    position_error_p98: float

    @staticmethod
    def aggregate(metrics: Sequence[PlanMetrics]) -> "GroupMetrics":
        if not metrics:
            raise ValueError("no metrics to aggregate")
        ok = [m for m in metrics if m.success]
        t = np.asarray([m.plan_time for m in ok]) if ok else np.asarray([0.0])
        pe = np.asarray([m.position_error for m in ok]) if ok else np.asarray([0.0])
        return GroupMetrics(
            n=len(metrics),
            success_rate=sum(m.success for m in metrics) / len(metrics),
            plan_time_mean=float(t.mean()),
            plan_time_median=float(np.median(t)),
            plan_time_p75=float(np.percentile(t, 75)),
            plan_time_p98=float(np.percentile(t, 98)),
            motion_time_mean=float(np.mean([m.motion_time for m in ok])) if ok else 0.0,
            path_length_mean=float(np.mean([m.path_length for m in ok])) if ok else 0.0,
            jerk_mean=float(np.mean([m.jerk for m in ok])) if ok else 0.0,
            position_error_mean=float(pe.mean()),
            position_error_p98=float(np.percentile(pe, 98)),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
