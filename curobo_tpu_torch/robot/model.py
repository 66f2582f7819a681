"""Robot model construction: config dict -> KinematicsParams.

Counterpart of `curobo_tpu/robot/model.py`, same YAML schema
(``format: curobo-tpu-robot/1``) and the same table construction; a URDF loads
through the package's own parser (`robot/urdf.py`). Nothing here opens a
mesh: ``asset_root`` and ``visual`` entries are carried as metadata only.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from curobo_tpu_torch.robot import urdf as urdf_mod
from curobo_tpu_torch.robot.params import (
    JOINT_FIXED,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    JointLimits,
    KinematicsParams,
    SelfCollisionParams,
)
from curobo_tpu_torch.util.config_io import load_yaml

_JOINT_TYPE_CODES = {
    "fixed": JOINT_FIXED,
    "revolute": JOINT_REVOLUTE,
    "continuous": JOINT_REVOLUTE,
    "prismatic": JOINT_PRISMATIC,
}


@dataclasses.dataclass
class LinkSpec:
    """One link + the joint connecting it to its parent (host-side)."""

    name: str
    parent: Optional[str]
    joint_name: str = ""
    joint_type: str = "fixed"
    origin_xyz: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    origin_rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    # lower, upper, velocity, effort
    limits: Tuple[float, float, float, float] = (-np.inf, np.inf, np.inf, np.inf)
    mimic_joint: Optional[str] = None
    mimic_multiplier: float = 1.0
    mimic_offset: float = 0.0
    mass: float = 0.0
    com: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    inertia: Tuple[float, ...] = (0.0,) * 9  # row-major 3x3 about CoM
    # visual-mesh entries: [{"mesh": path, "origin_xyz", "origin_rpy",
    # "scale"}], paths relative to the config's asset_root
    visual: List[dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RobotModelConfig:
    """Host-side robot description, loadable from YAML or URDF."""

    name: str
    base_link: str
    tool_frames: List[str]
    actuated_joints: List[str]
    links: List[LinkSpec]
    lock_joints: Dict[str, float] = dataclasses.field(default_factory=dict)
    retract_config: Optional[List[float]] = None
    # scalar or per-dof list
    max_acceleration: object = 15.0
    max_jerk: object = 500.0
    velocity_scale: float = 1.0
    cspace_weight: Optional[List[float]] = None
    null_space_weight: Optional[List[float]] = None
    collision_spheres: Dict[str, List[dict]] = dataclasses.field(default_factory=dict)
    self_collision_ignore: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    self_collision_buffer: Dict[str, float] = dataclasses.field(default_factory=dict)
    sphere_buffer: float = 0.0
    extra_collision_spheres: Dict[str, int] = dataclasses.field(default_factory=dict)
    # base directory for links[].visual mesh paths (override with the
    # CUROBO_TORCH_ASSET_ROOT env var at load time)
    asset_root: str = ""

    # ------------------------------------------------------------------
    def with_locked_joints(
        self, names: Sequence[str], values: Optional[Sequence[float]] = None
    ) -> "RobotModelConfig":
        """Copy with the given ACTUATED joints locked (reference
        `lock_joints` semantics, `cuda_robot_generator`): removed from the
        dof list, frozen at the given values (default: their retract
        pose). Per-dof arrays (retract, weights, limits scalars-or-lists)
        are sliced to the remaining dofs."""
        idx = {n: i for i, n in enumerate(self.actuated_joints)}
        for n in names:
            if n not in idx:
                raise ValueError(
                    f"joint {n!r} is not actuated; actuated joints: "
                    f"{self.actuated_joints}"
                )
        if values is None:
            if self.retract_config is None:
                raise ValueError("no retract_config to lock joints at")
            values = [float(self.retract_config[idx[n]]) for n in names]
        drop = set(names)
        keep = [i for i, n in enumerate(self.actuated_joints) if n not in drop]

        def sl(v):
            if isinstance(v, (list, tuple)) and len(v) == len(self.actuated_joints):
                return [v[i] for i in keep]
            return v

        return dataclasses.replace(
            self,
            actuated_joints=[self.actuated_joints[i] for i in keep],
            lock_joints={**self.lock_joints,
                         **{n: float(v) for n, v in zip(names, values)}},
            retract_config=sl(self.retract_config),
            cspace_weight=sl(self.cspace_weight),
            null_space_weight=sl(self.null_space_weight),
            max_acceleration=sl(self.max_acceleration),
            max_jerk=sl(self.max_jerk),
        )

    @staticmethod
    def from_dict(d: dict) -> "RobotModelConfig":
        r = d["robot"] if "robot" in d else d
        links = []
        for ld in r["links"]:
            links.append(
                LinkSpec(
                    name=ld["name"],
                    parent=ld.get("parent"),
                    joint_name=ld.get("joint_name", f"{ld['name']}_joint"),
                    joint_type=ld.get("joint_type", "fixed"),
                    origin_xyz=tuple(ld.get("origin_xyz", (0.0, 0.0, 0.0))),
                    origin_rpy=tuple(ld.get("origin_rpy", (0.0, 0.0, 0.0))),
                    axis=tuple(ld.get("axis", (0.0, 0.0, 1.0))),
                    limits=tuple(ld.get("limits", (-np.inf, np.inf, np.inf, np.inf))),
                    mimic_joint=(ld.get("mimic") or {}).get("joint"),
                    mimic_multiplier=(ld.get("mimic") or {}).get("multiplier", 1.0),
                    mimic_offset=(ld.get("mimic") or {}).get("offset", 0.0),
                    mass=ld.get("mass", 0.0),
                    com=tuple(ld.get("com", (0.0, 0.0, 0.0))),
                    inertia=tuple(ld.get("inertia", (0.0,) * 9)),
                    visual=list(ld.get("visual", [])),
                )
            )
        cspace = r.get("cspace", {})
        collision = r.get("collision", {})
        return RobotModelConfig(
            name=r.get("name", "robot"),
            base_link=r["base_link"],
            tool_frames=list(r.get("tool_frames", [])),
            actuated_joints=list(r["actuated_joints"]),
            links=links,
            lock_joints=dict(r.get("lock_joints", {})),
            retract_config=cspace.get("retract_config"),
            max_acceleration=cspace.get("max_acceleration", 15.0),
            max_jerk=cspace.get("max_jerk", 500.0),
            velocity_scale=cspace.get("velocity_scale", 1.0),
            cspace_weight=cspace.get("cspace_weight"),
            null_space_weight=cspace.get("null_space_weight"),
            collision_spheres=collision.get("spheres", {}),
            self_collision_ignore=collision.get("self_collision_ignore", {}),
            self_collision_buffer=collision.get("self_collision_buffer", {}),
            sphere_buffer=collision.get("sphere_buffer", 0.0),
            extra_collision_spheres=r.get("extra_collision_spheres", {}),
            asset_root=os.environ.get(
                "CUROBO_TORCH_ASSET_ROOT", r.get("asset_root", "")
            ),
        )

    @staticmethod
    def from_yaml(path: str) -> "RobotModelConfig":
        return RobotModelConfig.from_dict(load_yaml(path))

    @staticmethod
    def from_urdf(
        urdf_path: str,
        base_link: str,
        tool_frames: Sequence[str],
        actuated_joints: Optional[Sequence[str]] = None,
        collision_spheres: Optional[Dict[str, List[dict]]] = None,
        lock_joints: Optional[Dict[str, float]] = None,
        **kwargs,
    ) -> "RobotModelConfig":
        """The subtree of ``base_link``, depth first, with its joints,
        limits, mimic relations, inertials and visuals (``package://``
        stripped). ``actuated_joints`` defaults to the movable joints that
        are neither mimic nor locked. The asset root is
        ``CUROBO_TORCH_ASSET_ROOT``, else the URDF's directory."""
        robot = urdf_mod.parse_urdf(urdf_path)
        by_child = robot.joint_by_child

        # Keep every link reachable from base_link (subtree), depth-first.
        children: Dict[str, List[str]] = {}
        for j in robot.joints.values():
            children.setdefault(j.parent_link, []).append(j.child_link)
        keep: List[str] = []
        stack = [base_link]
        while stack:
            l = stack.pop()
            keep.append(l)
            stack.extend(sorted(children.get(l, [])))

        links: List[LinkSpec] = []
        for name in keep:
            j = by_child.get(name)
            link = robot.links[name]
            inertial = link.inertial
            spec = LinkSpec(
                name=name,
                parent=None if name == base_link else j.parent_link,
                mass=inertial.mass if inertial else 0.0,
                com=tuple(inertial.com) if inertial else (0, 0, 0),
                inertia=tuple(inertial.inertia.reshape(-1)) if inertial else (0.0,) * 9,
                visual=[
                    {
                        "mesh": (
                            v.mesh.split("://", 1)[1].split("/", 1)[-1]
                            if v.mesh.startswith("package://")
                            else v.mesh
                        ),
                        "origin_xyz": list(v.xyz),
                        "origin_rpy": list(v.rpy),
                        "scale": list(v.scale),
                    }
                    for v in link.visuals
                ],
            )
            if name != base_link and j is not None:
                spec.joint_name = j.name
                spec.joint_type = j.joint_type
                spec.origin_xyz = tuple(j.origin_xyz)
                spec.origin_rpy = tuple(j.origin_rpy)
                spec.axis = tuple(j.axis)
                spec.limits = (j.limit_lower, j.limit_upper, j.limit_velocity, j.limit_effort)
                spec.mimic_joint = j.mimic_joint
                spec.mimic_multiplier = j.mimic_multiplier
                spec.mimic_offset = j.mimic_offset
            links.append(spec)

        if actuated_joints is None:
            actuated_joints = [
                l.joint_name
                for l in links
                if l.joint_type in ("revolute", "continuous", "prismatic")
                and l.mimic_joint is None
                and l.joint_name not in (lock_joints or {})
            ]
        kwargs.setdefault(
            "asset_root",
            os.environ.get(
                "CUROBO_TORCH_ASSET_ROOT",
                os.path.dirname(os.path.abspath(urdf_path)),
            ),
        )
        return RobotModelConfig(
            name=robot.name,
            base_link=base_link,
            tool_frames=list(tool_frames),
            actuated_joints=list(actuated_joints),
            links=links,
            lock_joints=dict(lock_joints or {}),
            collision_spheres=dict(collision_spheres or {}),
            **kwargs,
        )


def build_kinematics_params(
    cfg: RobotModelConfig, device=None, dtype=torch.float32
) -> KinematicsParams:
    """Assemble the device-side struct-of-arrays robot model.

    ``device=None`` is the CUDA device (raises when there is none)."""
    from curobo_tpu_torch.runtime import resolve_device

    device = resolve_device(device)

    def tensor(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    # ---- topological order (parents before children) -------------------
    by_name = {l.name: l for l in cfg.links}
    if len(by_name) != len(cfg.links):
        from collections import Counter

        dupes = [n for n, c in Counter(l.name for l in cfg.links).items() if c > 1]
        raise ValueError(f"duplicate link names in robot config: {dupes}")
    if cfg.base_link not in by_name:
        raise ValueError(f"base_link {cfg.base_link!r} not among links")
    order: List[str] = []
    children: Dict[str, List[str]] = {}
    for l in cfg.links:
        if l.parent is not None:
            children.setdefault(l.parent, []).append(l.name)
    stack = [cfg.base_link]
    while stack:
        n = stack.pop(0)
        order.append(n)
        stack.extend(children.get(n, []))
    missing = set(by_name) - set(order)
    if missing:
        raise ValueError(f"links not reachable from base: {sorted(missing)}")

    n_links = len(order)
    link_idx = {n: i for i, n in enumerate(order)}
    parent_idx = []
    joint_type = []
    dof_idx = []
    fixed_rot = np.zeros((n_links, 3, 3), dtype=np.float32)
    fixed_pos = np.zeros((n_links, 3), dtype=np.float32)
    joint_axis = np.zeros((n_links, 3), dtype=np.float32)
    mimic_mult = np.zeros((n_links,), dtype=np.float32)
    mimic_offset = np.zeros((n_links,), dtype=np.float32)
    link_mass = np.zeros((n_links,), dtype=np.float32)
    link_com = np.zeros((n_links, 3), dtype=np.float32)
    link_inertia = np.zeros((n_links, 3, 3), dtype=np.float32)

    dof_names = list(cfg.actuated_joints)
    n_dof = len(dof_names)
    dof_of_joint = {n: i for i, n in enumerate(dof_names)}
    # Per-dof limits gathered from the driving joints.
    lim_lower = np.full((n_dof,), -np.inf, dtype=np.float32)
    lim_upper = np.full((n_dof,), np.inf, dtype=np.float32)
    lim_vel = np.full((n_dof,), np.inf, dtype=np.float32)
    lim_effort = np.full((n_dof,), np.inf, dtype=np.float32)

    for i, name in enumerate(order):
        l = by_name[name]
        parent_idx.append(link_idx[l.parent] if l.parent is not None else -1)
        jt = _JOINT_TYPE_CODES.get(l.joint_type, JOINT_FIXED)
        fixed_rot[i] = urdf_mod.rpy_to_matrix(np.asarray(l.origin_rpy, dtype=np.float64))
        fixed_pos[i] = np.asarray(l.origin_xyz, dtype=np.float64)
        joint_axis[i] = np.asarray(l.axis, dtype=np.float64)
        link_mass[i] = l.mass
        link_com[i] = np.asarray(l.com, dtype=np.float64)
        link_inertia[i] = np.asarray(l.inertia, dtype=np.float64).reshape(3, 3)

        d = -1
        mult, off = 0.0, 0.0
        if jt != JOINT_FIXED:
            if l.joint_name in cfg.lock_joints:
                mult, off = 0.0, float(cfg.lock_joints[l.joint_name])
            elif l.mimic_joint is not None:
                src = l.mimic_joint
                if src in cfg.lock_joints:
                    mult, off = 0.0, (
                        l.mimic_multiplier * float(cfg.lock_joints[src]) + l.mimic_offset
                    )
                elif src in dof_of_joint:
                    d = dof_of_joint[src]
                    mult, off = l.mimic_multiplier, l.mimic_offset
                else:
                    raise ValueError(
                        f"mimic source joint {src!r} of {l.joint_name!r} is neither "
                        "actuated nor locked"
                    )
            elif l.joint_name in dof_of_joint:
                d = dof_of_joint[l.joint_name]
                mult, off = 1.0, 0.0
                lim_lower[d] = l.limits[0]
                lim_upper[d] = l.limits[1]
                lim_vel[d] = l.limits[2] * cfg.velocity_scale
                lim_effort[d] = l.limits[3]
            else:
                # Unactuated, unlocked movable joint: freeze at zero.
                mult, off = 0.0, 0.0
        joint_type.append(jt)
        dof_idx.append(d)
        mimic_mult[i] = mult
        mimic_offset[i] = off

    unbound = [dof_names[i] for i in range(n_dof) if not np.isfinite(lim_lower[i])]
    for jn in dof_names:
        if jn not in {l.joint_name for l in cfg.links}:
            raise ValueError(f"actuated joint {jn!r} not found in links")

    # ---- tree levels ---------------------------------------------------
    depth = [0] * n_links
    for i in range(1, n_links):
        depth[i] = depth[parent_idx[i]] + 1
    levels: List[List[int]] = [[] for _ in range(max(depth) + 1)]
    for i, d in enumerate(depth):
        levels[d].append(i)

    # ---- spheres -------------------------------------------------------
    sphere_centers: List[np.ndarray] = []
    sphere_radii: List[float] = []
    sphere_link: List[int] = []
    sphere_link_name: List[str] = []
    for lname, spheres in cfg.collision_spheres.items():
        if lname not in link_idx:
            raise ValueError(f"collision sphere link {lname!r} not in model")
        for s in spheres:
            sphere_centers.append(np.asarray(s["center"], dtype=np.float32))
            sphere_radii.append(float(s["radius"]) + cfg.sphere_buffer)
            sphere_link.append(link_idx[lname])
            sphere_link_name.append(lname)
    # Placeholder (disabled) spheres for attachable objects.
    for lname, count in cfg.extra_collision_spheres.items():
        if lname not in link_idx:
            continue
        for _ in range(count):
            sphere_centers.append(np.zeros(3, dtype=np.float32))
            sphere_radii.append(-10.0)  # negative radius = disabled
            sphere_link.append(link_idx[lname])
            sphere_link_name.append(lname)
    n_spheres = len(sphere_link)
    centers = (
        np.stack(sphere_centers) if n_spheres else np.zeros((0, 3), dtype=np.float32)
    )
    radii = np.asarray(sphere_radii, dtype=np.float32)

    # ---- self-collision pair list -------------------------------------
    ignore = {k: set(v) for k, v in cfg.self_collision_ignore.items()}

    def ignored(a: str, b: str) -> bool:
        return b in ignore.get(a, ()) or a in ignore.get(b, ())

    buffers = cfg.self_collision_buffer
    pair_a: List[int] = []
    pair_b: List[int] = []
    pair_margin: List[float] = []
    pair_buffer: List[float] = []
    for i in range(n_spheres):
        for j in range(i + 1, n_spheres):
            la, lb = sphere_link_name[i], sphere_link_name[j]
            if la == lb or ignored(la, lb):
                continue
            # Adjacent links (parent-child) never collide meaningfully.
            ia, ib = sphere_link[i], sphere_link[j]
            if parent_idx[ia] == ib or parent_idx[ib] == ia:
                continue
            buf = buffers.get(la, 0.0) + buffers.get(lb, 0.0)
            margin = radii[i] + radii[j] + buf
            # Disabled spheres get a -inf margin so the pair never activates
            # until the sphere table is updated (attachments).
            if radii[i] < 0 or radii[j] < 0:
                margin = -np.inf
            pair_a.append(i)
            pair_b.append(j)
            pair_margin.append(margin)
            pair_buffer.append(buf)

    self_collision = SelfCollisionParams(
        pair_a=tensor(np.asarray(pair_a, np.int32), torch.int32),
        pair_b=tensor(np.asarray(pair_b, np.int32), torch.int32),
        pair_margin=tensor(np.asarray(pair_margin, np.float32)),
        pair_buffer=tensor(np.asarray(pair_buffer, np.float32)),
    )

    # ---- cspace --------------------------------------------------------
    retract = np.asarray(
        cfg.retract_config
        if cfg.retract_config is not None
        else np.clip(0.0, lim_lower, lim_upper),
        dtype=np.float32,
    )
    cspace_w = np.asarray(
        cfg.cspace_weight if cfg.cspace_weight is not None else np.ones(n_dof),
        dtype=np.float32,
    )
    null_w = np.asarray(
        cfg.null_space_weight if cfg.null_space_weight is not None else np.ones(n_dof),
        dtype=np.float32,
    )

    def per_dof(v):
        arr = np.asarray(v, dtype=np.float32)
        if arr.ndim == 0:
            return tensor(np.full((n_dof,), float(arr), dtype=np.float32))
        if arr.shape != (n_dof,):
            raise ValueError(
                f"per-dof limit list has {arr.shape[0]} entries, expected {n_dof}"
            )
        return tensor(arr)

    limits = JointLimits(
        lower=tensor(lim_lower),
        upper=tensor(lim_upper),
        velocity=tensor(lim_vel),
        acceleration=per_dof(cfg.max_acceleration),
        jerk=per_dof(cfg.max_jerk),
        effort=tensor(lim_effort),
    )

    tool_idx = []
    for t in cfg.tool_frames:
        if t not in link_idx:
            raise ValueError(f"tool frame {t!r} not among links {order}")
        tool_idx.append(link_idx[t])

    return KinematicsParams(
        fixed_rot=tensor(fixed_rot),
        fixed_pos=tensor(fixed_pos),
        joint_axis=tensor(joint_axis),
        mimic_mult=tensor(mimic_mult),
        mimic_offset=tensor(mimic_offset),
        sphere_centers=tensor(centers),
        sphere_radii=tensor(radii),
        joint_limits=limits,
        retract_config=tensor(retract),
        cspace_weight=tensor(cspace_w),
        null_space_weight=tensor(null_w),
        self_collision=self_collision,
        link_mass=tensor(link_mass),
        link_com=tensor(link_com),
        link_inertia=tensor(link_inertia),
        link_names=tuple(order),
        joint_names=tuple(dof_names),
        parent_idx=tuple(parent_idx),
        joint_type=tuple(joint_type),
        dof_idx=tuple(dof_idx),
        levels=tuple(tuple(lv) for lv in levels),
        sphere_link_idx=tuple(sphere_link),
        tool_frame_names=tuple(cfg.tool_frames),
        tool_frame_idx=tuple(tool_idx),
        base_link=cfg.base_link,
        robot_name=cfg.name,
    )
