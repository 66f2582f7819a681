"""Robot builder: URDF -> collision sphere model -> robot config YAML.

Counterpart of `curobo_tpu/robot/builder.py` (URDF -> spheres ->
self-collision ignore matrix -> YAML, and the retract-pose check of the built
model).

Sphere generation strategies:
1. mesh fit (when the URDF's collision meshes resolve to OBJ/STL files):
   Adam over the baked mesh SDF (`geom/sphere_fit.py`, `geom/mesh.py`).
2. skeleton spheres (always available): spheres placed along the segment
   from each link origin to its children's origins, radius from a fraction
   of the segment length.

A mesh file that does not resolve, or is not OBJ/STL, is skipped as in the
JAX package; any other failure of the fit (the native mesh-SDF build, a
launch) raises, where the JAX builder skips the link. The retract checks run
FK on the builder's device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

from curobo_tpu_torch.robot import urdf as urdf_mod
from curobo_tpu_torch.robot.import_urdf import build_config
from curobo_tpu_torch.runtime import resolve_device
from curobo_tpu_torch.util.config_io import write_yaml


@dataclasses.dataclass
class BuilderConfig:
    spheres_per_link: int = 4
    radius_scale: float = 0.35  # radius = scale * segment length / spheres
    min_radius: float = 0.02
    use_mesh_fit: bool = True
    mesh_voxel_size: float = 0.02


class RobotBuilder:
    """``device=None`` is the CUDA device (raises when there is none); the
    mesh fit and the retract checks run there."""

    def __init__(self, urdf_path: str, base_link: str, tool_frames: List[str],
                 cfg: BuilderConfig = BuilderConfig(), device=None):
        self.urdf_path = urdf_path
        self.base_link = base_link
        self.tool_frames = list(tool_frames)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.robot = urdf_mod.parse_urdf(urdf_path)

    # ------------------------------------------------------------------
    def _skeleton_spheres(self) -> Dict[str, List[dict]]:
        """Spheres along link-origin -> child-origin segments."""
        cfg = self.cfg
        children: Dict[str, List[np.ndarray]] = {}
        for j in self.robot.joints.values():
            children.setdefault(j.parent_link, []).append(np.asarray(j.origin_xyz))
        out: Dict[str, List[dict]] = {}
        for name, link in self.robot.links.items():
            segs = children.get(name, [])
            spheres = []
            for seg in segs:
                L = float(np.linalg.norm(seg))
                if L < 1e-6:
                    continue
                n = max(2, cfg.spheres_per_link)
                r = max(cfg.min_radius, cfg.radius_scale * L / n)
                for t in np.linspace(0.0, 1.0, n):
                    c = seg * t
                    spheres.append({"center": [float(v) for v in c], "radius": float(r)})
            if not spheres and link.inertial is not None and link.inertial.mass > 0:
                # terminal link with mass: one sphere at the CoM
                spheres.append(
                    {"center": [float(v) for v in link.inertial.com],
                     "radius": cfg.min_radius * 2}
                )
            if spheres:
                out[name] = spheres
        return out

    def _mesh_spheres(self) -> Dict[str, List[dict]]:
        """Per-link sphere fits from resolvable OBJ/STL collision meshes."""
        from curobo_tpu_torch.geom.sphere_fit import SphereFitConfig, fit_spheres_to_mesh
        from curobo_tpu_torch.geom.types import MeshObstacle

        root = os.path.dirname(os.path.abspath(self.urdf_path))
        out: Dict[str, List[dict]] = {}
        for name, link in self.robot.links.items():
            for mesh_file in link.collision_meshes or link.visual_meshes:
                path = mesh_file.replace("package://", "")
                cands = [path, os.path.join(root, path), os.path.join(root, os.path.basename(path))]
                found = next((c for c in cands if os.path.exists(c)), None)
                if found is None or not found.lower().endswith((".obj", ".stl")):
                    continue
                c, r = fit_spheres_to_mesh(
                    MeshObstacle(name=name, file_path=found,
                                 voxel_size=self.cfg.mesh_voxel_size),
                    SphereFitConfig(n_spheres=self.cfg.spheres_per_link, n_iters=120),
                    device=self.device,
                )
                out[name] = [
                    {"center": [float(v) for v in ci], "radius": float(ri)}
                    for ci, ri in zip(c, r)
                ]
                break
        return out

    def generate_spheres(self) -> Dict[str, List[dict]]:
        spheres = self._mesh_spheres() if self.cfg.use_mesh_fit else {}
        skeleton = self._skeleton_spheres()
        for name, s in skeleton.items():
            spheres.setdefault(name, s)
        return spheres

    # ------------------------------------------------------------------
    def auto_self_collision_ignore(self, spheres: Dict[str, List[dict]]) -> Dict[str, List[str]]:
        """Ignore adjacent link pairs and pairs joined through a fixed joint."""
        by_child = self.robot.joint_by_child
        ignore: Dict[str, List[str]] = {}

        def add(a, b):
            ignore.setdefault(a, [])
            if b not in ignore[a]:
                ignore[a].append(b)

        # adjacency (parent/child and siblings through fixed joints)
        for j in self.robot.joints.values():
            add(j.parent_link, j.child_link)
        # grandparent chains through massless/fixed intermediate links
        for j in self.robot.joints.values():
            jj = by_child.get(j.parent_link)
            if jj is not None and j.joint_type == "fixed":
                add(jj.parent_link, j.child_link)
        return ignore

    # ------------------------------------------------------------------
    def build(
        self,
        out_path: Optional[str] = None,
        name: Optional[str] = None,
        auto_ignore_retract: bool = True,
    ) -> dict:
        """Assemble the full robot config dict (and optionally write YAML).

        auto_ignore_retract: link pairs already in contact at the retract
        pose are added to the ignore matrix (they are geometry artifacts of
        the auto-fit spheres, not real self-collisions), up to four rounds.
        """
        spheres = self.generate_spheres()
        ignore = self.auto_self_collision_ignore(spheres)
        annex = {
            "kinematics": {
                "collision_spheres": spheres,
                "self_collision_ignore": ignore,
            }
        }
        cfg = build_config(self.urdf_path, self.base_link, self.tool_frames, annex=annex)
        if name:
            cfg["robot"]["name"] = name

        if auto_ignore_retract:
            for _ in range(4):  # iterate until retract is clean
                violated = self._violated_link_pairs_at_retract(cfg)
                if not violated:
                    break
                for a, b in violated:
                    ignore.setdefault(a, [])
                    if b not in ignore[a]:
                        ignore[a].append(b)
                annex["kinematics"]["self_collision_ignore"] = ignore
                cfg = build_config(
                    self.urdf_path, self.base_link, self.tool_frames, annex=annex
                )
                if name:
                    cfg["robot"]["name"] = name

        if out_path:
            write_yaml(cfg, out_path)
        return cfg

    def _retract_state(self, cfg_dict: dict):
        from curobo_tpu_torch.robot.kinematics import compute_kinematics
        from curobo_tpu_torch.robot.model import RobotModelConfig, build_kinematics_params

        params = build_kinematics_params(RobotModelConfig.from_dict(cfg_dict), device=self.device)
        return params, compute_kinematics(params, params.retract_config)

    def _violated_link_pairs_at_retract(self, cfg_dict: dict):
        params, st = self._retract_state(cfg_dict)
        sc = params.self_collision
        sph = st.spheres.detach().cpu().numpy()
        pa = sc.pair_a.cpu().numpy()
        pb = sc.pair_b.cpu().numpy()
        d = np.linalg.norm(sph[pa, :3] - sph[pb, :3], axis=-1)
        margin = sc.pair_margin.cpu().numpy()
        bad = np.where(np.isfinite(margin) & (d < margin))[0]
        pairs = set()
        for k in bad:
            la = params.link_names[params.sphere_link_idx[pa[k]]]
            lb = params.link_names[params.sphere_link_idx[pb[k]]]
            pairs.add((la, lb))
        return sorted(pairs)

    # ------------------------------------------------------------------
    def debug_retract_pose(self, cfg_dict: dict) -> dict:
        """Check the built model at its retract pose.

        Returns {"self_collision_violation": float, "n_spheres": int, ...}.
        """
        from curobo_tpu_torch.geom.self_collision import self_collision_distance

        params, st = self._retract_state(cfg_dict)
        viol = float(self_collision_distance(params.self_collision, st.spheres))
        return {
            "n_spheres": params.n_spheres,
            "n_self_collision_pairs": int(params.self_collision.pair_a.shape[0]),
            "self_collision_violation": viol,
            "retract_ok": viol <= 0.0,
        }
