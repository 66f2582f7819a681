"""Robot model debugger: validates a built robot before it ships.

Counterpart of `curobo_tpu/robot/debugger.py`: retract-pose collision checks,
sphere-model sanity, limit sanity, and a random-configuration sweep that
estimates how much of the c-space the self-collision model forbids (a
collision-sphere model that disallows half the workspace is mis-fit even if
retract is clean). The checks run on the device of the robot's tables: on a
CUDA device the self-collision distances of the retract pose and of the sweep
are `sc_pair_viol` launches (`geom/self_collision.py`). The findings are host
values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from curobo_tpu_torch.geom.self_collision import self_collision_distance
from curobo_tpu_torch.robot.kinematics import compute_kinematics
from curobo_tpu_torch.robot.params import KinematicsParams


def _np(t: torch.Tensor, dtype=None) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a if dtype is None else a.astype(dtype)


@dataclasses.dataclass
class RobotReport:
    """Findings from `RobotDebugger.report()`; `ok` is the rollup."""

    ok: bool
    issues: List[str]
    n_dof: int
    n_spheres: int
    n_self_collision_pairs: int
    retract_self_collision_violation: float
    retract_violating_pairs: List[Tuple[str, str]]
    free_fraction: float  # self-collision-free share of sampled configs
    sphere_radius_range: Tuple[float, float]
    per_link_spheres: Dict[str, int]
    workspace_aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]]

    def summary(self) -> str:
        lines = [
            f"robot: {self.n_dof} dof, {self.n_spheres} spheres, "
            f"{self.n_self_collision_pairs} self-collision pairs",
            f"retract self-collision violation: "
            f"{self.retract_self_collision_violation:.4f} "
            f"({'ok' if self.retract_self_collision_violation <= 0 else 'VIOLATED'})",
            f"self-collision-free fraction of random configs: {self.free_fraction:.2f}",
            f"sphere radii: [{self.sphere_radius_range[0]:.4f}, "
            f"{self.sphere_radius_range[1]:.4f}]",
            f"tool workspace AABB: {np.round(self.workspace_aabb, 3).tolist()}",
        ]
        lines += [f"ISSUE: {s}" for s in self.issues]
        return "\n".join(lines)


class RobotDebugger:
    def __init__(self, params: KinematicsParams):
        self.params = params

    # ------------------------------------------------------------------
    def report(self, n_samples: int = 256, seed: int = 0,
               min_free_fraction: float = 0.3) -> RobotReport:
        p = self.params
        issues: List[str] = []

        # --- joint limits ------------------------------------------------
        lo = _np(p.joint_limits.lower, np.float64)
        hi = _np(p.joint_limits.upper, np.float64)
        retract = _np(p.retract_config, np.float64)
        if np.any(hi < lo):
            bad = [p.joint_names[i] for i in np.where(hi < lo)[0]]
            issues.append(f"upper < lower limits for joints {bad}")
        inside = (retract >= np.minimum(lo, hi) - 1e-6) & (
            retract <= np.maximum(lo, hi) + 1e-6
        )
        if not np.all(inside):
            bad = [p.joint_names[i] for i in np.where(~inside)[0]]
            issues.append(f"retract config outside joint limits for {bad}")

        # --- sphere model ------------------------------------------------
        radii = _np(p.sphere_radii, np.float64).reshape(-1)
        valid = radii > 0.0  # negative radius marks a disabled slot
        if p.n_spheres == 0:
            issues.append("robot has no collision spheres")
        r_range = (
            (float(radii[valid].min()), float(radii[valid].max()))
            if valid.any()
            else (0.0, 0.0)
        )
        if valid.any() and r_range[0] < 1e-4:
            issues.append(f"degenerate sphere radius {r_range[0]:.2e}")
        per_link: Dict[str, int] = {}
        for li in p.sphere_link_idx:
            name = p.link_names[int(li)]
            per_link[name] = per_link.get(name, 0) + 1

        # --- retract pose ------------------------------------------------
        st = compute_kinematics(p, p.retract_config)
        viol = float(self_collision_distance(p.self_collision, st.spheres))
        pairs = self._violating_pairs(_np(st.spheres))
        if viol > 0.0:
            issues.append(
                f"self-collision at retract (violation {viol:.4f}): {pairs[:5]}"
            )

        # --- random-config sweep ------------------------------------------
        lo_s = np.maximum(lo, -np.pi)
        hi_s = np.minimum(hi, np.pi)
        rng = np.random.RandomState(seed)
        q = torch.as_tensor(
            rng.uniform(lo_s, hi_s, (n_samples, p.n_dof)), dtype=torch.float32,
            device=p.device,
        )
        st_b = compute_kinematics(p, q)
        d = self_collision_distance(p.self_collision, st_b.spheres)
        free = float((d <= 0.0).float().mean())
        if free < min_free_fraction:
            issues.append(
                f"only {free:.0%} of sampled configs are self-collision-free — "
                "the sphere model or ignore list is likely over-tight"
            )

        # --- workspace AABB ----------------------------------------------
        tp = _np(st_b.tool_pose.position).reshape(-1, 3)
        aabb = (tuple(tp.min(axis=0).tolist()), tuple(tp.max(axis=0).tolist()))

        return RobotReport(
            ok=not issues,
            issues=issues,
            n_dof=p.n_dof,
            n_spheres=p.n_spheres,
            n_self_collision_pairs=int(p.self_collision.pair_a.shape[0]),
            retract_self_collision_violation=viol,
            retract_violating_pairs=pairs,
            free_fraction=free,
            sphere_radius_range=r_range,
            per_link_spheres=per_link,
            workspace_aabb=aabb,
        )

    # ------------------------------------------------------------------
    def _violating_pairs(self, spheres: np.ndarray) -> List[Tuple[str, str]]:
        p = self.params
        sc = p.self_collision
        pa = _np(sc.pair_a)
        if len(pa) == 0:
            return []
        pb = _np(sc.pair_b)
        d = np.linalg.norm(spheres[pa, :3] - spheres[pb, :3], axis=-1)
        margin = _np(sc.pair_margin)
        bad = np.where(np.isfinite(margin) & (d < margin))[0]
        pairs = set()
        for k in bad:
            la = p.link_names[int(p.sphere_link_idx[pa[k]])]
            lb = p.link_names[int(p.sphere_link_idx[pb[k]])]
            pairs.add(tuple(sorted((la, lb))))
        return sorted(pairs)
