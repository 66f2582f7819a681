"""Minimal, dependency-free URDF parser (stdlib xml.etree only).

Functional parity target: reference `curobo/_src/robot/parser/parser_urdf.py`
(which uses `yourdfpy`); this is an independent implementation that extracts
exactly what the kinematics loader needs: the joint/link tree, joint types,
axes, origins, limits, mimic relations and inertial parameters.
"""

from __future__ import annotations

import dataclasses
import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np


def _parse_floats(s: Optional[str], default: Tuple[float, ...]) -> np.ndarray:
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.asarray([float(v) for v in s.split()], dtype=np.float64)


def rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF fixed-axis roll/pitch/yaw -> rotation matrix (numpy, host-side)."""
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


@dataclasses.dataclass
class UrdfInertial:
    mass: float = 0.0
    com: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    # Inertia tensor about the CoM, expressed in the link frame (3, 3).
    inertia: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((3, 3)))


@dataclasses.dataclass
class UrdfJoint:
    name: str
    joint_type: str  # revolute | continuous | prismatic | fixed | floating | planar
    parent_link: str
    child_link: str
    origin_xyz: np.ndarray
    origin_rpy: np.ndarray
    axis: np.ndarray
    limit_lower: float = -np.inf
    limit_upper: float = np.inf
    limit_velocity: float = np.inf
    limit_effort: float = np.inf
    mimic_joint: Optional[str] = None
    mimic_multiplier: float = 1.0
    mimic_offset: float = 0.0

    @property
    def origin_matrix(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = rpy_to_matrix(self.origin_rpy)
        T[:3, 3] = self.origin_xyz
        return T


@dataclasses.dataclass
class UrdfVisual:
    """One <visual> mesh entry: file + link-frame placement + scale.

    Parity: reference visual-mesh extraction for its UsdWriter
    (`curobo/_src/util/usd_helper.py` link-mesh emission)."""

    mesh: str
    xyz: tuple = (0.0, 0.0, 0.0)
    rpy: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)


@dataclasses.dataclass
class UrdfLink:
    name: str
    inertial: Optional[UrdfInertial] = None
    visual_meshes: List[str] = dataclasses.field(default_factory=list)
    collision_meshes: List[str] = dataclasses.field(default_factory=list)
    visuals: List[UrdfVisual] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class UrdfRobot:
    name: str
    links: Dict[str, UrdfLink]
    joints: Dict[str, UrdfJoint]

    @property
    def joint_by_child(self) -> Dict[str, UrdfJoint]:
        return {j.child_link: j for j in self.joints.values()}

    def root_link(self) -> str:
        children = {j.child_link for j in self.joints.values()}
        roots = [name for name in self.links if name not in children]
        if len(roots) != 1:
            raise ValueError(f"URDF must have exactly one root link, found {roots}")
        return roots[0]

    def chain(self, base_link: str, tip_link: str) -> List[str]:
        """Ordered list of link names from base to tip (inclusive)."""
        by_child = self.joint_by_child
        path = [tip_link]
        cur = tip_link
        while cur != base_link:
            j = by_child.get(cur)
            if j is None:
                raise ValueError(f"no path from {base_link} to {tip_link}")
            cur = j.parent_link
            path.append(cur)
        return list(reversed(path))


def _parse_inertial(elem: ET.Element) -> UrdfInertial:
    out = UrdfInertial()
    mass_el = elem.find("mass")
    if mass_el is not None:
        out.mass = float(mass_el.get("value", "0"))
    origin_el = elem.find("origin")
    if origin_el is not None:
        out.com = _parse_floats(origin_el.get("xyz"), (0, 0, 0))
        rpy = _parse_floats(origin_el.get("rpy"), (0, 0, 0))
    else:
        rpy = np.zeros(3)
    inertia_el = elem.find("inertia")
    if inertia_el is not None:
        ixx = float(inertia_el.get("ixx", "0"))
        ixy = float(inertia_el.get("ixy", "0"))
        ixz = float(inertia_el.get("ixz", "0"))
        iyy = float(inertia_el.get("iyy", "0"))
        iyz = float(inertia_el.get("iyz", "0"))
        izz = float(inertia_el.get("izz", "0"))
        I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        # Rotate the inertia tensor into the link frame if the inertial
        # origin carries a rotation.
        R = rpy_to_matrix(rpy)
        out.inertia = R @ I @ R.T
    return out


def _parse_geometry_meshes(elem: ET.Element) -> List[str]:
    out = []
    for geom in elem.findall("geometry/mesh"):
        fn = geom.get("filename")
        if fn:
            out.append(fn)
    return out


def _parse_visuals(elem: ET.Element) -> List[UrdfVisual]:
    """<visual> entries with origin + scale (for visual-mesh export)."""
    out = []
    origin_el = elem.find("origin")
    xyz = tuple(
        _parse_floats(origin_el.get("xyz") if origin_el is not None else None,
                      (0, 0, 0))
    )
    rpy = tuple(
        _parse_floats(origin_el.get("rpy") if origin_el is not None else None,
                      (0, 0, 0))
    )
    for geom in elem.findall("geometry/mesh"):
        fn = geom.get("filename")
        if fn:
            scale = tuple(_parse_floats(geom.get("scale"), (1, 1, 1)))
            out.append(UrdfVisual(mesh=fn, xyz=xyz, rpy=rpy, scale=scale))
    return out


def parse_urdf_string(text: str) -> UrdfRobot:
    root = ET.fromstring(text)
    if root.tag != "robot":
        raise ValueError(f"expected <robot> root element, got <{root.tag}>")
    links: Dict[str, UrdfLink] = {}
    joints: Dict[str, UrdfJoint] = {}

    for link_el in root.findall("link"):
        name = link_el.get("name")
        link = UrdfLink(name=name)
        inertial_el = link_el.find("inertial")
        if inertial_el is not None:
            link.inertial = _parse_inertial(inertial_el)
        for vis in link_el.findall("visual"):
            link.visual_meshes.extend(_parse_geometry_meshes(vis))
            link.visuals.extend(_parse_visuals(vis))
        for col in link_el.findall("collision"):
            link.collision_meshes.extend(_parse_geometry_meshes(col))
        links[name] = link

    for joint_el in root.findall("joint"):
        name = joint_el.get("name")
        jtype = joint_el.get("type")
        parent = joint_el.find("parent").get("link")
        child = joint_el.find("child").get("link")
        origin_el = joint_el.find("origin")
        xyz = _parse_floats(origin_el.get("xyz") if origin_el is not None else None, (0, 0, 0))
        rpy = _parse_floats(origin_el.get("rpy") if origin_el is not None else None, (0, 0, 0))
        axis_el = joint_el.find("axis")
        axis = _parse_floats(axis_el.get("xyz") if axis_el is not None else None, (1, 0, 0))
        n = np.linalg.norm(axis)
        if n > 0:
            axis = axis / n

        joint = UrdfJoint(
            name=name, joint_type=jtype, parent_link=parent, child_link=child,
            origin_xyz=xyz, origin_rpy=rpy, axis=axis,
        )
        limit_el = joint_el.find("limit")
        if limit_el is not None:
            joint.limit_lower = float(limit_el.get("lower", "-inf"))
            joint.limit_upper = float(limit_el.get("upper", "inf"))
            joint.limit_velocity = float(limit_el.get("velocity", "inf"))
            joint.limit_effort = float(limit_el.get("effort", "inf"))
        if jtype == "continuous":
            joint.limit_lower, joint.limit_upper = -2.0 * math.pi, 2.0 * math.pi
        mimic_el = joint_el.find("mimic")
        if mimic_el is not None:
            joint.mimic_joint = mimic_el.get("joint")
            joint.mimic_multiplier = float(mimic_el.get("multiplier", "1"))
            joint.mimic_offset = float(mimic_el.get("offset", "0"))
        joints[name] = joint

    return UrdfRobot(name=root.get("name", "robot"), links=links, joints=joints)


def parse_urdf(path: str) -> UrdfRobot:
    with open(path, "r") as f:
        return parse_urdf_string(f.read())
