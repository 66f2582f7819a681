"""Sensor observation types.

Counterpart of `curobo_tpu/perception/types.py`: plain dataclasses of tensors
on this package's `Pose`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from curobo_tpu_torch.types.pose import Pose


@dataclasses.dataclass(frozen=True)
class CameraObservation:
    """Depth (+ optional RGB / feature) observation.

    depth: (H, W) metres, 0 or non-finite = invalid.
    intrinsics: (3, 3) pinhole K matrix.
    pose: camera-to-world Pose.
    """

    depth: torch.Tensor
    intrinsics: torch.Tensor
    pose: Pose
    rgb: Optional[torch.Tensor] = None  # (H, W, 3)
    feature: Optional[torch.Tensor] = None  # (H, W, F)

    @property
    def resolution(self):
        return tuple(self.depth.shape)

    def pointcloud(self) -> torch.Tensor:
        """Back-project valid depth to world-frame points (H*W, 3); invalid
        pixels map to a far sentinel (1e6)."""
        H, W = self.depth.shape
        fx, fy = self.intrinsics[0, 0], self.intrinsics[1, 1]
        cx, cy = self.intrinsics[0, 2], self.intrinsics[1, 2]
        dev = self.depth.device
        v, u = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                              indexing="ij")
        z = self.depth
        x = (u - cx) / fx * z
        y = (v - cy) / fy * z
        pts_cam = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
        valid = (z > 0).reshape(-1)
        pts_w = self.pose.transform_points(pts_cam[None])[0]
        return torch.where(valid[:, None], pts_w, 1.0e6)


@dataclasses.dataclass(frozen=True)
class LidarObservation:
    """Point cloud in the sensor frame + sensor pose."""

    points: torch.Tensor  # (N, 3), invalid = non-finite or 0
    pose: Pose

    def world_points(self) -> torch.Tensor:
        return self.pose.transform_points(self.points[None])[0]
