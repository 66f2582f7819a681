"""Quaternion and rotation math (PyTorch, fully batched).

Counterpart of `curobo_tpu/math/quaternion.py`: wxyz ordering, every
function accepts arbitrary leading batch dimensions.
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit norm with w >= 0 (q and -q are the same rotation)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)
    return torch.where(q[..., :1] < 0.0, -q, q)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion, four-candidate
    construction selected by the largest diagonal term."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)
    vals = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    idx = torch.argmax(vals, dim=-1, keepdim=True)
    q = torch.where(
        idx == 0, cw, torch.where(idx == 1, cx, torch.where(idx == 2, cy, cz))
    )
    return quat_normalize(q)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def axis_angle_rotation_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: axis (..., 3) unit, angle (...,) -> (..., 3, 3)."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    ax, ay, az = axis.unbind(-1)
    zeros = torch.zeros_like(ax)
    k = torch.stack(
        [zeros, -az, ay, az, zeros, -ax, -ay, ax, zeros], dim=-1
    ).reshape(axis.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    outer = axis[..., :, None] * axis[..., None, :]
    return c * eye + s * k + (1.0 - c) * outer


def quat_angle(q: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation angle in [0, pi]."""
    w = q[..., 0].abs().clamp(0.0, 1.0 - eps)
    return 2.0 * torch.acos(w)


def quat_error(q_goal: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotation-vector error of goal^-1 * q, shape (..., 3); smooth at 0."""
    dq = quat_normalize(quat_multiply(quat_conjugate(q_goal), q))
    w = dq[..., :1]
    vec = dq[..., 1:]
    s2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    small = s2 < 1e-12
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    angle = 2.0 * torch.atan2(s, w)
    scale = torch.where(small, torch.full_like(s, 2.0), angle / s)
    return vec * scale


def quat_geodesic_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    dot = torch.sum(q1 * q2, dim=-1).abs().clamp(0.0, 1.0)
    return 2.0 * torch.acos(dot)
