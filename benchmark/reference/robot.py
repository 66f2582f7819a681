"""Plain reference of a robot described by a curobo-tpu robot YAML.

Reads the YAML itself and works everything out again in float64 PyTorch:
forward kinematics of the link tree, the tool frames' poses, the collision
spheres' centres, the self-collision pairs and their margins, and the joint
limits. It shares no code and no table with the program under test.

Semantics (those of the robot format):
- links are visited breadth first from `base_link`; a link's pose is its
  parent's pose times the fixed origin (`origin_xyz`, URDF fixed-axis
  `origin_rpy`) times the joint motion: a rotation of the joint value about
  `axis` (revolute) or a translation of it along `axis` (prismatic);
- the joint value is q[d] for the d-th of `actuated_joints`, the locked value
  for a joint in `lock_joints`, and 0 for any other movable joint;
- a sphere's radius is its own plus `sphere_buffer`; the placeholder spheres
  of `extra_collision_spheres` are disabled and take part in nothing;
- a self-collision pair joins two enabled spheres of different links that are
  neither parent and child nor listed in `self_collision_ignore` (either
  direction); its margin is the two radii plus both links'
  `self_collision_buffer`, and it collides where the centres lie closer than
  the margin;
- velocity limits are the joint's (`limits[2]` times `velocity_scale`),
  acceleration and jerk limits `max_acceleration` and `max_jerk` of `cspace`.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import yaml

F64 = torch.float64


def rpy_matrix(rpy) -> torch.Tensor:
    """URDF fixed-axis roll, pitch, yaw -> Rz(yaw) Ry(pitch) Rx(roll)."""
    r, p, y = (float(v) for v in rpy)
    cr, sr, cp, sp, cy, sy = math.cos(r), math.sin(r), math.cos(p), math.sin(p), math.cos(y), math.sin(y)
    rz = torch.tensor([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]], dtype=F64)
    ry = torch.tensor([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]], dtype=F64)
    rx = torch.tensor([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]], dtype=F64)
    return rz @ ry @ rx


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 4) unit quaternions (w, x, y, z)
    with w >= 0, by the largest of the four diagonal forms."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = torch.stack([
        torch.stack([1 + tr, m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1]], -1),
        torch.stack([m[..., 2, 1] - m[..., 1, 2], 1 + 2 * m[..., 0, 0] - tr,
                     m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]], -1),
        torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                     1 + 2 * m[..., 1, 1] - tr, m[..., 1, 2] + m[..., 2, 1]], -1),
        torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1], 1 + 2 * m[..., 2, 2] - tr], -1),
    ], -2)  # (..., 4 forms, 4)
    diag = torch.stack([1 + tr, 1 + 2 * m[..., 0, 0] - tr, 1 + 2 * m[..., 1, 1] - tr,
                        1 + 2 * m[..., 2, 2] - tr], -1)
    best = diag.argmax(-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (w, x, y, z) -> (..., 3, 3), normalised first."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def pose_errors(pos, quat, goal_pos, goal_quat):
    """Position error (m) and rotation error (rad) of tool poses against
    goals: the distance of the origins and the angle of conj(goal) * tool."""
    pe = torch.linalg.vector_norm(pos - goal_pos, dim=-1)
    gw, gx, gy, gz = goal_quat.unbind(-1)
    tw, tx, ty, tz = quat.unbind(-1)
    rw = gw * tw + gx * tx + gy * ty + gz * tz
    rx = gw * tx - gx * tw - gy * tz + gz * ty
    ry = gw * ty + gx * tz - gy * tw - gz * tx
    rz = gw * tz - gx * ty + gy * tx - gz * tw
    s = torch.sqrt(rx * rx + ry * ry + rz * rz)
    re = 2.0 * torch.atan2(s, rw.abs())
    return pe, re


class Robot:
    """The robot of one YAML file, in float64 on `device`."""

    def __init__(self, path: str, device="cpu"):
        with open(path) as fh:
            doc = yaml.safe_load(fh)["robot"]
        self.device = torch.device(device)
        links = {l["name"]: l for l in doc["links"]}
        children: Dict[str, List[str]] = {}
        for l in doc["links"]:
            if l.get("parent") is not None:
                children.setdefault(l["parent"], []).append(l["name"])
        order, queue = [], [doc["base_link"]]
        while queue:
            n = queue.pop(0)
            order.append(n)
            queue.extend(children.get(n, []))
        self.link_names = order
        idx = {n: i for i, n in enumerate(order)}
        self.actuated = list(doc["actuated_joints"])
        dof_of = {j: d for d, j in enumerate(self.actuated)}
        locks = {k: float(v) for k, v in (doc.get("lock_joints") or {}).items()}
        self.parent, self.kind, self.dof, self.const = [], [], [], []
        rots, poss, axes = [], [], []
        D = len(self.actuated)
        lower, upper, vel = [0.0] * D, [0.0] * D, [0.0] * D
        cspace = doc.get("cspace") or {}
        vscale = float(cspace.get("velocity_scale", 1.0))
        for n in order:
            l = links[n]
            if l.get("mimic"):
                raise NotImplementedError(f"link {n}: mimic joints are not in this reference")
            self.parent.append(idx[l["parent"]] if l.get("parent") is not None else -1)
            jt = l.get("joint_type", "fixed")
            kind = {"revolute": 1, "continuous": 1, "prismatic": 2}.get(jt, 0)
            jn = l.get("joint_name")
            d = dof_of.get(jn, -1) if kind else -1
            self.kind.append(kind)
            self.dof.append(d)
            self.const.append(locks.get(jn, 0.0) if kind and d < 0 else 0.0)
            rots.append(rpy_matrix(l.get("origin_rpy", [0.0, 0.0, 0.0])))
            poss.append(torch.tensor(l.get("origin_xyz", [0.0, 0.0, 0.0]), dtype=F64))
            axes.append(torch.tensor(l.get("axis", [0.0, 0.0, 1.0]), dtype=F64))
            if d >= 0:
                lo, hi, v = l["limits"][:3]
                lower[d], upper[d], vel[d] = float(lo), float(hi), float(v) * vscale
        dev = self.device
        self.fixed_rot = torch.stack(rots).to(dev)
        self.fixed_pos = torch.stack(poss).to(dev)
        self.axis = torch.stack(axes).to(dev)
        self.n_dof = D
        self.tools = [idx[t] for t in doc["tool_frames"]]

        def per_dof(v):
            t = torch.as_tensor(v, dtype=F64)
            return (t.expand(D) if t.ndim == 0 else t).clone().to(dev)

        self.lower = torch.tensor(lower, dtype=F64, device=dev)
        self.upper = torch.tensor(upper, dtype=F64, device=dev)
        self.velocity = torch.tensor(vel, dtype=F64, device=dev)
        self.acceleration = per_dof(cspace.get("max_acceleration", 15.0))
        self.jerk = per_dof(cspace.get("max_jerk", 500.0))
        self.retract = torch.tensor(cspace["retract_config"], dtype=F64, device=dev)

        col = doc.get("collision") or {}
        buf = float(col.get("sphere_buffer", 0.0))
        centres, radii, sph_link = [], [], []
        for lname, spheres in (col.get("spheres") or {}).items():
            for s in spheres:
                centres.append([float(c) for c in s["center"]])
                radii.append(float(s["radius"]) + buf)
                sph_link.append(idx[lname])
        self.sphere_centre = torch.tensor(centres, dtype=F64, device=dev)
        self.sphere_radius = torch.tensor(radii, dtype=F64, device=dev)
        self.sphere_link = torch.tensor(sph_link, dtype=torch.long, device=dev)
        self.n_sphere_slots = len(radii) + sum(
            int(c) for c in (doc.get("extra_collision_spheres") or {}).values())
        ignore = {k: set(v) for k, v in (col.get("self_collision_ignore") or {}).items()}
        sbuf = {k: float(v) for k, v in (col.get("self_collision_buffer") or {}).items()}
        pa, pb, pm = [], [], []
        for i in range(len(radii)):
            for j in range(i + 1, len(radii)):
                li, lj = sph_link[i], sph_link[j]
                a, b = order[li], order[lj]
                if li == lj or b in ignore.get(a, ()) or a in ignore.get(b, ()):
                    continue
                if self.parent[li] == lj or self.parent[lj] == li:
                    continue
                pa.append(i)
                pb.append(j)
                pm.append(radii[i] + radii[j] + sbuf.get(a, 0.0) + sbuf.get(b, 0.0))
        self.pair_a = torch.tensor(pa, dtype=torch.long, device=dev)
        self.pair_b = torch.tensor(pb, dtype=torch.long, device=dev)
        self.pair_margin = torch.tensor(pm, dtype=F64, device=dev)

    # ------------------------------------------------------------------
    def fk(self, q: torch.Tensor, dtype=F64):
        """(N, D) joint values -> rotations (N, L, 3, 3) and origins (N, L, 3)
        of every link, computed in `dtype`."""
        q = q.to(device=self.device, dtype=dtype)
        N = q.shape[0]
        eye = torch.eye(3, dtype=dtype, device=self.device)
        frot, fpos, axes = (t.to(dtype) for t in (self.fixed_rot, self.fixed_pos, self.axis))
        Rs, ps = [], []
        for i, par in enumerate(self.parent):
            kind, d = self.kind[i], self.dof[i]
            val = q[:, d] if d >= 0 else torch.full((N,), self.const[i], dtype=dtype, device=self.device)
            F, fp, a = frot[i], fpos[i], axes[i]
            if kind == 1:
                c, s = torch.cos(val)[:, None, None], torch.sin(val)[:, None, None]
                K = torch.zeros((3, 3), dtype=dtype, device=self.device)
                K[0, 1], K[0, 2], K[1, 0], K[1, 2], K[2, 0], K[2, 1] = -a[2], a[1], a[2], -a[0], -a[1], a[0]
                Rl = F @ (c * eye + s * K + (1 - c) * torch.outer(a, a))
                pl = fp.expand(N, 3)
            elif kind == 2:
                Rl = F.expand(N, 3, 3)
                pl = fp + val[:, None] * (F @ a)
            else:
                Rl, pl = F.expand(N, 3, 3), fp.expand(N, 3)
            if par < 0:
                Rs.append(Rl)
                ps.append(pl)
            else:
                Rs.append(Rs[par] @ Rl)
                ps.append(ps[par] + (Rs[par] @ pl[..., None])[..., 0])
        return torch.stack(Rs, 1), torch.stack(ps, 1)

    def tool_pose(self, q: torch.Tensor, tool: int = 0, dtype=F64):
        """(N, D) -> tool position (N, 3) and quaternion (N, 4), w >= 0."""
        R, p = self.fk(q, dtype)
        link = self.tools[tool]
        return p[:, link], matrix_to_quat(R[:, link])

    def spheres(self, q: torch.Tensor, dtype=F64):
        """(N, D) -> centres (N, S, 3) of the enabled spheres."""
        R, p = self.fk(q, dtype)
        sl = self.sphere_link
        c = self.sphere_centre.to(dtype)
        return (R[:, sl] @ c[:, :, None])[..., 0] + p[:, sl]

    def self_slack(self, centres: torch.Tensor) -> torch.Tensor:
        """Least (distance - margin) over the self-collision pairs, (N,):
        negative where two spheres collide."""
        d = torch.linalg.vector_norm(centres[:, self.pair_a] - centres[:, self.pair_b], dim=-1)
        return (d - self.pair_margin.to(centres.dtype)).amin(-1)

    def limit_excess(self, q: torch.Tensor, tol: float = 1e-4) -> torch.Tensor:
        """How far (N, D) joint values lie outside the position limits widened
        by `tol` (the program's feasibility tolerance), largest per row; <= 0
        inside."""
        q = q.to(self.lower.dtype)
        return torch.maximum(self.lower - tol - q, q - self.upper - tol).amax(-1)
