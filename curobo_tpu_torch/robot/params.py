"""Tensorized robot model: struct-of-arrays kinematics parameters.

Counterpart of `curobo_tpu/robot/params.py`: per-link tables are tensors on
the chosen device, tree topology is static Python metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# Joint type codes.
JOINT_FIXED = 0
JOINT_REVOLUTE = 1
JOINT_PRISMATIC = 2


def ancestor_mask(tool_idx: Tuple[int, ...], parent_idx: Tuple[int, ...]) -> np.ndarray:
    """(len(tool_idx), n_links): 1 where a link is on the chain from the root
    to the tool link (both ends included)."""
    mask = np.zeros((len(tool_idx), len(parent_idx)), dtype=np.float32)
    for t, l in enumerate(tool_idx):
        while l >= 0:
            mask[t, l] = 1.0
            l = parent_idx[l]
    return mask


def dof_one_hot(dof_idx: Tuple[int, ...], n_dof: int) -> np.ndarray:
    """(n_links, n_dof): 1 at the dof that drives each link's joint."""
    m = np.zeros((len(dof_idx), n_dof), dtype=np.float32)
    for l, d in enumerate(dof_idx):
        if d >= 0:
            m[l, d] = 1.0
    return m


def _to(obj, device):
    """Copy of a dataclass with every tensor field moved to `device`."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _to(v, device)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass(frozen=True)
class JointLimits:
    """Per-dof limits, all shape (n_dof,)."""

    lower: torch.Tensor
    upper: torch.Tensor
    velocity: torch.Tensor
    acceleration: torch.Tensor
    jerk: torch.Tensor
    effort: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SelfCollisionParams:
    """Precomputed collision-sphere pair list. ``pair_margin`` is
    r_a + r_b + per-link buffers (contact when dist < margin); pairs with a
    disabled sphere carry a -inf margin."""

    pair_a: torch.Tensor  # (n_pairs,) int32
    pair_b: torch.Tensor  # (n_pairs,) int32
    pair_margin: torch.Tensor  # (n_pairs,) float32 (includes radii)
    pair_buffer: torch.Tensor  # (n_pairs,) float32 (buffers only)

    def recompute_margins(self, radii: torch.Tensor) -> "SelfCollisionParams":
        ra = radii[self.pair_a.long()]
        rb = radii[self.pair_b.long()]
        margin = ra + rb + self.pair_buffer
        margin = torch.where(
            (ra < 0) | (rb < 0), torch.full_like(margin, -float("inf")), margin
        )
        return dataclasses.replace(self, pair_margin=margin)


@dataclasses.dataclass(frozen=True)
class KinematicsParams:
    """Device-resident robot description. Link index 0 is the base link."""

    # --- per-link tables (n_links, ...) --------------------------------
    fixed_rot: torch.Tensor  # (n_links, 3, 3) joint-origin rotation
    fixed_pos: torch.Tensor  # (n_links, 3) joint-origin translation
    joint_axis: torch.Tensor  # (n_links, 3) unit axis in post-origin frame
    mimic_mult: torch.Tensor  # (n_links,) q_link = mult * q[dof] + offset
    mimic_offset: torch.Tensor  # (n_links,)

    # --- spheres -------------------------------------------------------
    sphere_centers: torch.Tensor  # (n_spheres, 3) in link frame
    sphere_radii: torch.Tensor  # (n_spheres,) (negative radius = disabled)

    # --- dof-level data ------------------------------------------------
    joint_limits: JointLimits
    retract_config: torch.Tensor  # (n_dof,)
    cspace_weight: torch.Tensor  # (n_dof,)
    null_space_weight: torch.Tensor  # (n_dof,)

    # --- self collision ------------------------------------------------
    self_collision: SelfCollisionParams

    # --- inertial ------------------------------------------------------
    link_mass: torch.Tensor  # (n_links,)
    link_com: torch.Tensor  # (n_links, 3)
    link_inertia: torch.Tensor  # (n_links, 3, 3)

    # --- static topology metadata --------------------------------------
    link_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]
    parent_idx: Tuple[int, ...]
    joint_type: Tuple[int, ...]
    # dof driving each link's joint (-1 = none / fixed or locked)
    dof_idx: Tuple[int, ...]
    # links grouped by tree depth, root(s) first
    levels: Tuple[Tuple[int, ...], ...]
    sphere_link_idx: Tuple[int, ...]
    tool_frame_names: Tuple[str, ...]
    tool_frame_idx: Tuple[int, ...]
    base_link: str
    robot_name: str

    # ------------------------------------------------------------------
    @property
    def n_links(self) -> int:
        return len(self.link_names)

    @property
    def n_dof(self) -> int:
        return len(self.joint_names)

    @property
    def n_spheres(self) -> int:
        return len(self.sphere_link_idx)

    @property
    def n_tools(self) -> int:
        return len(self.tool_frame_idx)

    @property
    def device(self) -> torch.device:
        return self.fixed_rot.device

    def to(self, device) -> "KinematicsParams":
        return _to(self, device)

    def link_index(self, name: str) -> int:
        return self.link_names.index(name)

    def dof_joint_types(self) -> np.ndarray:
        """Per-dof joint-type codes, derived from the per-link tables."""
        types = np.full(self.n_dof, JOINT_REVOLUTE, dtype=np.int32)
        for l, d in enumerate(self.dof_idx):
            if d >= 0:
                types[d] = self.joint_type[l]
        return types

    def dof_clip_bounds(self, angular_cap: float = 2.0 * np.pi):
        """Optimizer clipping window per dof: revolute dofs intersect their
        limits with +-angular_cap (continuous joints would otherwise hand
        the optimizer a huge box); prismatic dofs keep their true limits."""
        types = self.dof_joint_types()
        ang = types != JOINT_PRISMATIC
        lo = self.joint_limits.lower.detach().cpu().numpy().astype(np.float64)
        hi = self.joint_limits.upper.detach().cpu().numpy().astype(np.float64)
        lo = np.where(ang, np.maximum(lo, -angular_cap), lo)
        hi = np.where(ang, np.minimum(hi, angular_cap), hi)
        return lo.astype(np.float32), hi.astype(np.float32)

    def tool_ancestor_mask(self) -> np.ndarray:
        """(n_tools, n_links) host mask: 1 where link l is on the chain from
        the base to tool t (both ends included)."""
        return ancestor_mask(self.tool_frame_idx, self.parent_idx)

    def dof_routing_matrix(self) -> np.ndarray:
        """(n_links, n_dof) host matrix, the mimic multiplier of link l's
        joint at column dof(l): per-link Jacobian contributions times it are
        per-dof columns."""
        mult = self.mimic_mult.detach().cpu().numpy()
        return dof_one_hot(self.dof_idx, self.n_dof) * mult[:, None]

    def update_spheres(self, centers: torch.Tensor, radii: torch.Tensor) -> "KinematicsParams":
        return dataclasses.replace(self, sphere_centers=centers, sphere_radii=radii)
