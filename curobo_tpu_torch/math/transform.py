"""Batched rigid-transform math on (R, p) pairs.

Counterpart of `curobo_tpu/math/transform.py`: R (..., 3, 3), p (..., 3).
"""

from __future__ import annotations

from typing import Tuple

import torch

Transform = Tuple[torch.Tensor, torch.Tensor]


def compose(Ra, pa, Rb, pb) -> Transform:
    """(Ra, pa) @ (Rb, pb)."""
    return Ra @ Rb, (Ra @ pb[..., None])[..., 0] + pa


def inverse(R, p) -> Transform:
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ p[..., None])[..., 0]


def transform_points(R, p, pts):
    """R (..., 3, 3), p (..., 3), pts (..., N, 3)."""
    return pts @ R.transpose(-1, -2) + p[..., None, :]


def inverse_transform_points(R, p, pts):
    return (pts - p[..., None, :]) @ R


def identity_like(batch_shape, dtype=torch.float32, device="cpu") -> Transform:
    R = torch.eye(3, dtype=dtype, device=device).expand(tuple(batch_shape) + (3, 3))
    p = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
    return R, p
