"""Per-tool pose goal criteria.

Counterpart of `curobo_tpu/types/tool_pose.py`: criteria stack into two dense
tensors, (T, 6) axis weight factors and (T, 2) convergence tolerances, that
ride on the `Goal` and broadcast into the batched pose cost
(`cost/terms.py:pose_error`). Only the generic objective reads them; a goal
that carries them never takes the kernel route.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ToolPoseCriteria:
    """How one tool frame's pose error enters the objective.

    pose_axes_weight_factor: 6 scale factors (x, y, z position axes then 3
    rotation-vector axes), multiplied with the rollout's pose weights.
    convergence_tolerance: (position m, rotation rad) slack subtracted from
    the reported error before threshold checks: a tool within tolerance
    counts as exactly on-goal.
    """

    pose_axes_weight_factor: Tuple[float, ...] = (1.0,) * 6
    convergence_tolerance: Tuple[float, float] = (0.0, 0.0)

    def __post_init__(self):
        if len(self.pose_axes_weight_factor) != 6:
            raise ValueError(
                f"pose_axes_weight_factor needs 6 floats, got {self.pose_axes_weight_factor}"
            )
        if len(self.convergence_tolerance) != 2:
            raise ValueError(
                f"convergence_tolerance needs 2 floats, got {self.convergence_tolerance}"
            )

    @staticmethod
    def disabled() -> "ToolPoseCriteria":
        """A tool whose pose does not matter (weight zero, infinite slack)."""
        return ToolPoseCriteria(
            pose_axes_weight_factor=(0.0,) * 6,
            convergence_tolerance=(float(np.inf), float(np.inf)),
        )


def stack_criteria(
    criteria: Sequence[ToolPoseCriteria], device="cpu"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack per-tool criteria -> (tool_weight (T, 6), tool_tolerance (T, 2))."""
    w = np.asarray([c.pose_axes_weight_factor for c in criteria], np.float32)
    tol = np.asarray([c.convergence_tolerance for c in criteria], np.float32)
    return torch.as_tensor(w, device=device), torch.as_tensor(tol, device=device)


def criteria_for_tools(
    tool_names: Sequence[str],
    by_name: Dict[str, ToolPoseCriteria],
    default: Optional[ToolPoseCriteria] = None,
    device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve a name-keyed criteria dict against the robot's tool-frame
    order (unnamed tools get ``default``, or neutral criteria)."""
    default = default or ToolPoseCriteria()
    return stack_criteria([by_name.get(n, default) for n in tool_names], device)
