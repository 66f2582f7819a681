"""Batched forward kinematics (PyTorch).

Counterpart of `curobo_tpu/robot/kinematics.py`: all per-link local
transforms are computed in one batch, then composed level by level down the
tree. q is (..., n_dof) with arbitrary leading batch dims. `compute_com`
gives the whole robot's centre of mass from the link transforms.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from curobo_tpu_torch.math import quaternion as qm
from curobo_tpu_torch.robot.params import (
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    KinematicsParams,
    ancestor_mask,
    dof_one_hot,
)
from curobo_tpu_torch.types.pose import Pose


@dataclasses.dataclass(frozen=True)
class KinematicsState:
    """FK results."""

    link_rot: torch.Tensor  # (..., n_links, 3, 3)
    link_pos: torch.Tensor  # (..., n_links, 3)
    tool_pose: Pose  # batched (..., n_tools)
    spheres: torch.Tensor  # (..., n_spheres, 4) xyz + radius
    jacobian: Optional[torch.Tensor] = None  # (..., n_tools, 6, n_dof)

    @property
    def tool_position(self) -> torch.Tensor:
        return self.tool_pose.position

    @property
    def tool_quaternion(self) -> torch.Tensor:
        return self.tool_pose.quaternion


@functools.lru_cache(maxsize=32)
def _index_tables(dof_idx: Tuple[int, ...], joint_type: Tuple[int, ...], device: torch.device):
    """(dof gather (L,), revolute mask (L,), prismatic mask (L,)) on `device`,
    built once per robot topology: a host-to-device copy waits for the
    device's queue, and the generic objective runs FK per evaluation."""
    jt = np.asarray(joint_type)
    return (
        torch.as_tensor([max(d, 0) for d in dof_idx], dtype=torch.long, device=device),
        torch.as_tensor((jt == JOINT_REVOLUTE).astype(np.float32), device=device),
        torch.as_tensor((jt == JOINT_PRISMATIC).astype(np.float32), device=device),
    )


def joint_values(params: KinematicsParams, q: torch.Tensor) -> torch.Tensor:
    """Per-link joint values (..., n_links) incl. mimic/locked routing."""
    gather = _index_tables(params.dof_idx, params.joint_type, q.device)[0]
    return params.mimic_mult * q[..., gather] + params.mimic_offset


def _local_transforms(
    params: KinematicsParams, vals: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R_local (..., L, 3, 3), p_local (..., L, 3)) for every link."""
    _, rev, prism = _index_tables(params.dof_idx, params.joint_type, vals.device)
    axis = params.joint_axis  # (L, 3)
    # Rodrigues for every link (fixed/prismatic links masked to identity).
    Rj = qm.axis_angle_rotation_matrix(axis, vals * rev)  # (..., L, 3, 3)
    pj = (prism[:, None] * axis) * vals[..., None]  # (..., L, 3)
    R_local = params.fixed_rot @ Rj
    p_local = (params.fixed_rot @ pj[..., None])[..., 0] + params.fixed_pos
    return R_local, p_local


def link_transforms(
    params: KinematicsParams, q: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global link transforms: (..., L, 3, 3), (..., L, 3)."""
    vals = joint_values(params, q)
    R_local, p_local = _local_transforms(params, vals)

    L = params.n_links
    R_out: list = [None] * L
    p_out: list = [None] * L
    for i in params.levels[0]:
        R_out[i] = R_local[..., i, :, :]
        p_out[i] = p_local[..., i, :]
    for level in params.levels[1:]:
        idx = list(level)
        parents = [params.parent_idx[i] for i in level]
        Rp = torch.stack([R_out[p] for p in parents], dim=-3)  # (..., k, 3, 3)
        pp = torch.stack([p_out[p] for p in parents], dim=-2)  # (..., k, 3)
        Rg = Rp @ R_local[..., idx, :, :]
        pg = (Rp @ p_local[..., idx, :, None])[..., 0] + pp
        for n, i in enumerate(level):
            R_out[i] = Rg[..., n, :, :]
            p_out[i] = pg[..., n, :]
    return torch.stack(R_out, dim=-3), torch.stack(p_out, dim=-2)


def robot_spheres(
    params: KinematicsParams, link_rot: torch.Tensor, link_pos: torch.Tensor
) -> torch.Tensor:
    """World-frame collision spheres (..., n_spheres, 4)."""
    if params.n_spheres == 0:
        return link_pos.new_zeros(tuple(link_pos.shape[:-2]) + (0, 4))
    sl = list(params.sphere_link_idx)
    R = link_rot[..., sl, :, :]  # (..., S, 3, 3)
    p = link_pos[..., sl, :]  # (..., S, 3)
    centers = (R @ params.sphere_centers[..., None])[..., 0] + p
    radii = params.sphere_radii.expand(centers.shape[:-1])
    return torch.cat([centers, radii[..., None]], dim=-1)


def compute_com(
    params: KinematicsParams, link_rot: torch.Tensor, link_pos: torch.Tensor
) -> torch.Tensor:
    """Whole-robot centre of mass in the world frame (..., 3): a mass-weighted
    sum over the link transforms already computed."""
    com_w = torch.einsum("...lij,lj->...li", link_rot, params.link_com) + link_pos
    m = params.link_mass  # (L,)
    total = m.sum().clamp_min(1e-9)
    return torch.einsum("l,...li->...i", m, com_w) / total


@functools.lru_cache(maxsize=32)
def _jacobian_tables(
    tool_idx: Tuple[int, ...], parent_idx: Tuple[int, ...], dof_idx: Tuple[int, ...],
    n_dof: int, device: torch.device,
):
    """(tool ancestor mask (T, L), one-hot dof routing (L, D)) on `device`,
    built once per robot topology (no host copy per call)."""
    return (
        torch.as_tensor(ancestor_mask(tool_idx, parent_idx), device=device),
        torch.as_tensor(dof_one_hot(dof_idx, n_dof), device=device),
    )


def analytic_jacobian(
    params: KinematicsParams,
    link_rot: torch.Tensor,
    link_pos: torch.Tensor,
    tool_pos: torch.Tensor,
) -> torch.Tensor:
    """Geometric Jacobians of all tool frames: (..., n_tools, 6, n_dof), rows
    0:3 linear velocity, rows 3:6 angular velocity. Per-link contributions go
    to dof columns through the routing matrix, which folds in the mimic
    multipliers."""
    _, rev, prism = _index_tables(params.dof_idx, params.joint_type, link_rot.device)
    anc, onehot = _jacobian_tables(
        params.tool_frame_idx, params.parent_idx, params.dof_idx, params.n_dof, link_rot.device
    )
    route = params.mimic_mult[:, None] * onehot  # params.dof_routing_matrix() on the device
    axis_w = torch.einsum("...lij,lj->...li", link_rot, params.joint_axis)  # (..., L, 3)
    # (..., T, L, 3): arm from each joint origin to each tool point
    arm = tool_pos[..., :, None, :] - link_pos[..., None, :, :]
    axis_b = axis_w[..., None, :, :].expand(arm.shape)
    contrib_v = rev[:, None] * torch.linalg.cross(axis_b, arm, dim=-1) + (
        prism[:, None] * axis_w
    )[..., None, :, :]
    contrib_w = (rev[:, None] * axis_w)[..., None, :, :].expand(contrib_v.shape)
    Jv = torch.einsum("...tlk,tl,ld->...tkd", contrib_v, anc, route)
    Jw = torch.einsum("...tlk,tl,ld->...tkd", contrib_w, anc, route)
    return torch.cat([Jv, Jw], dim=-2)


def compute_kinematics(
    params: KinematicsParams,
    q: torch.Tensor,
    compute_jacobian: bool = False,
) -> KinematicsState:
    """Single public FK entry point; `compute_jacobian` adds the analytic
    Jacobians of the tool frames."""
    from curobo_tpu_torch.util.checks import check_joint_config

    q = check_joint_config("q", q, params.n_dof)
    link_rot, link_pos = link_transforms(params, q)
    ti = list(params.tool_frame_idx)
    tool_R = link_rot[..., ti, :, :]
    tool_p = link_pos[..., ti, :]
    tool_pose = Pose(tool_p, qm.matrix_to_quat(tool_R))
    spheres = robot_spheres(params, link_rot, link_pos)
    jac = analytic_jacobian(params, link_rot, link_pos, tool_p) if compute_jacobian else None
    return KinematicsState(
        link_rot=link_rot, link_pos=link_pos, tool_pose=tool_pose, spheres=spheres,
        jacobian=jac,
    )


class Kinematics:
    """Thin OO facade over the functional FK core."""

    def __init__(self, params: KinematicsParams, visuals=None, asset_root=""):
        self.params = params
        # host-side visual-mesh metadata (never opened on this path)
        self.visuals = visuals or {}
        self.asset_root = asset_root

    @staticmethod
    def from_robot_config(cfg, device=None) -> "Kinematics":
        from curobo_tpu_torch.robot.model import build_kinematics_params

        visuals = {
            l.name: l.visual for l in cfg.links if getattr(l, "visual", None)
        }
        return Kinematics(
            build_kinematics_params(cfg, device=device),
            visuals=visuals,
            asset_root=getattr(cfg, "asset_root", ""),
        )

    @staticmethod
    def from_robot_yaml(path: str, device=None) -> "Kinematics":
        from curobo_tpu_torch.robot.model import RobotModelConfig

        return Kinematics.from_robot_config(
            RobotModelConfig.from_yaml(path), device=device
        )

    @property
    def n_dof(self) -> int:
        return self.params.n_dof

    @property
    def joint_names(self):
        return self.params.joint_names

    @property
    def device(self) -> torch.device:
        return self.params.device

    def compute_kinematics(self, q, compute_jacobian: bool = False) -> KinematicsState:
        return compute_kinematics(self.params, q, compute_jacobian)

    def tool_pose(self, q) -> Pose:
        return self.compute_kinematics(q).tool_pose
