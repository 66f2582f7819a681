"""Robot segmentation + depth filtering for perception pipelines.

Counterpart of `curobo_tpu/perception/segmenter.py`: `RobotSegmenter` masks
the pixels whose back-projected point lies within a margin of the robot's
collision spheres; `FilterDepth` is the validity-masked separable Gaussian
with edge rejection, taps summed in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from curobo_tpu_torch.perception.types import CameraObservation
from curobo_tpu_torch.robot import kinematics as kin_mod
from curobo_tpu_torch.robot.params import KinematicsParams

# pixels per chunk of the pixel x sphere distance table (65 536 x 61 spheres
# x 3 floats is 48 MB)
_MASK_CHUNK = 65536


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    # extra margin added to sphere radii when masking robot pixels
    distance_threshold: float = 0.05


class RobotSegmenter:
    """Masks robot pixels out of depth images using the sphere model."""

    def __init__(self, params: KinematicsParams, cfg: SegmenterConfig = SegmenterConfig()):
        self.params = params
        self.cfg = cfg

    def get_robot_mask(self, obs: CameraObservation, q: torch.Tensor) -> torch.Tensor:
        """(H, W) bool mask: True where the pixel belongs to the robot."""
        spheres = kin_mod.compute_kinematics(self.params, q).spheres.reshape(-1, 4)
        live = spheres[:, 3] >= 0
        pts = obs.pointcloud()
        parts = []
        for i in range(0, pts.shape[0], _MASK_CHUNK):
            p = pts[i:i + _MASK_CHUNK]
            d = torch.linalg.norm(p[:, None, :] - spheres[None, :, :3], dim=-1) - spheres[None, :, 3]
            parts.append(((d < self.cfg.distance_threshold) & live[None, :]).any(dim=-1))
        return torch.cat(parts).reshape(obs.depth.shape)

    def remove_robot(self, obs: CameraObservation, q: torch.Tensor) -> CameraObservation:
        mask = self.get_robot_mask(obs, q)
        return dataclasses.replace(obs, depth=torch.where(mask, 0.0, obs.depth))


@dataclasses.dataclass(frozen=True)
class FilterDepthConfig:
    kernel_size: int = 5
    sigma: float = 1.5
    # reject smoothed values whose support mixed depths further apart than
    # this (edge preservation)
    max_depth_diff: float = 0.05


class FilterDepth:
    """Validity-masked separable Gaussian depth filter with edge rejection."""

    def __init__(self, cfg: FilterDepthConfig = FilterDepthConfig()):
        self.cfg = cfg
        k = cfg.kernel_size
        xs = np.arange(k) - k // 2
        w = np.exp(-0.5 * (xs / cfg.sigma) ** 2)
        self._w = (w / w.sum()).astype(np.float32)

    def _conv_axis(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Zero-padded 1-D convolution along `axis`, taps added one at a time
        in index order."""
        k = self.cfg.kernel_size
        pad = k // 2
        n = x.shape[axis]
        shape = list(x.shape)
        shape[axis] = n + 2 * pad
        xp = x.new_zeros(shape)
        xp.narrow(axis, pad, n).copy_(x)
        w = torch.as_tensor(self._w, device=x.device)
        out = torch.zeros_like(x)
        for i in range(k):
            out = out + w[i] * xp.narrow(axis, i, n)
        return out

    def filter(self, depth: torch.Tensor) -> torch.Tensor:
        mask = (depth > 0).to(depth.dtype)
        num = self._conv_axis(self._conv_axis(depth * mask, 0), 1)
        den = self._conv_axis(self._conv_axis(mask, 0), 1)
        sm = num / den.clamp_min(1e-6)
        ok = (den > 0.25) & ((sm - depth).abs() < self.cfg.max_depth_diff)
        # keep the original where valid and close to the smoothed estimate;
        # fill small holes with the smoothed value
        return torch.where(mask > 0, torch.where(ok, sm, depth),
                           torch.where(den > 0.5, sm, torch.zeros_like(sm)))

    def __call__(self, obs: CameraObservation) -> CameraObservation:
        return dataclasses.replace(obs, depth=self.filter(obs.depth))
