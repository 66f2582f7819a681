"""USD (usda ASCII) scene/trajectory exporter, dependency-free.

Counterpart of `curobo_tpu/util/usd_export.py`, the same text: numpy and
string work over FK from this package (run on the tables' device, read back
once). Writes plain-text .usda files (no usd-core needed):

- every obstacle type as a geometry prim (Cube/Sphere/Cylinder/Capsule/
  Mesh/Points; voxel grids as occupied-voxel Points) with displayColor;
- the robot as an Xform-per-link stage hierarchy, animated with per-link
  translate/orient time samples from FK (one rigid transform per link per
  frame — the reference's animated robot stage), link collision spheres
  as static children in the link frame;
- flat animated-sphere export kept for debugging.

A mesh obstacle given by a file is read with `geom/mesh.load_mesh` (OBJ, STL,
DAE) and a file that does not load raises; the JAX writer reads it with
`trimesh` where that is installed and skips the obstacle otherwise.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from curobo_tpu_torch.geom import types as gt
from curobo_tpu_torch.geom.mesh import load_mesh
from curobo_tpu_torch.robot import kinematics as kin_mod
from curobo_tpu_torch.robot.urdf import rpy_to_matrix
from curobo_tpu_torch.util.logging import log_warn

# muted default colors (usdview-friendly)
_OBSTACLE_COLOR = (0.55, 0.55, 0.6)
_ROBOT_COLOR = (0.85, 0.55, 0.15)


def _fmt(v) -> str:
    return "(" + ", ".join(f"{float(x):.6g}" for x in v) + ")"


def _color(rgb) -> str:
    return f"color3f[] primvars:displayColor = [{_fmt(rgb)}]"


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) rotation -> (w,x,y,z), numerically safe (Shepperd)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _np(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _fk(params, q):
    """FK of configurations q (..., D) on the tables' device."""
    q = torch.as_tensor(_np(q), dtype=torch.float32, device=params.device)
    return kin_mod.compute_kinematics(params, q)


def _sanitize(name: str) -> str:
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return out if (out and not out[0].isdigit()) else "_" + out


class UsdWriter:
    def __init__(self, fps: float = 30.0):
        self.fps = fps
        self._prims: list = []
        self._end_time = 0.0

    # ---- scene geometry ----------------------------------------------
    def add_scene(self, scene: gt.Scene) -> None:
        for o in scene.obstacles:
            self.add_obstacle(o)

    def add_obstacle(self, o: gt.Obstacle) -> None:
        name = _sanitize(o.name)
        x, y, z, qw, qx, qy, qz = [float(v) for v in o.pose]
        xf = f'''double3 xformOp:translate = {_fmt((x, y, z))}
        quatf xformOp:orient = {_fmt((qw, qx, qy, qz))}'''
        order_to = '["xformOp:translate", "xformOp:orient"]'
        if isinstance(o, gt.Cuboid):
            self._prims.append(
                f'''
    def Cube "{name}" {{
        double size = 1
        {_color(_OBSTACLE_COLOR)}
        float3 xformOp:scale = {_fmt(o.dims)}
        {xf}
        uniform token[] xformOpOrder = ["xformOp:translate", "xformOp:orient", "xformOp:scale"]
    }}'''
            )
        elif isinstance(o, gt.SphereObstacle):
            self._prims.append(
                f'''
    def Sphere "{name}" {{
        double radius = {o.radius}
        {_color(_OBSTACLE_COLOR)}
        {xf}
        uniform token[] xformOpOrder = {order_to}
    }}'''
            )
        elif isinstance(o, gt.Capsule):
            # capsule prim: axis Z, segment base->tip folded into the
            # prim transform (midpoint translate + Z-to-axis rotation,
            # composed with the obstacle pose)
            base = np.asarray(o.base, np.float64)
            tip = np.asarray(o.tip, np.float64)
            seg = tip - base
            h = float(np.linalg.norm(seg))
            a = seg / max(h, 1e-9)
            # quaternion rotating +Z onto a
            zax = np.array([0.0, 0.0, 1.0])
            c = float(np.dot(zax, a))
            if c > 1.0 - 1e-9:
                q_align = np.array([1.0, 0, 0, 0])
            elif c < -1.0 + 1e-9:
                q_align = np.array([0.0, 1.0, 0, 0])  # 180 deg about X
            else:
                ax = np.cross(zax, a)
                s = np.sqrt((1.0 + c) * 2.0)
                q_align = np.concatenate([[s / 2.0], ax / s])
            qo = np.array([qw, qx, qy, qz])
            w1, v1 = qo[0], qo[1:]
            w2, v2 = q_align[0], q_align[1:]
            q_tot = np.concatenate(
                [[w1 * w2 - v1 @ v2], w1 * v2 + w2 * v1 + np.cross(v1, v2)]
            )
            # midpoint in world = pose * ((base+tip)/2)
            mid = (base + tip) / 2.0
            R = np.array([
                [1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx**2 + qz**2), 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx**2 + qy**2)],
            ])
            t = np.array([x, y, z]) + R @ mid
            self._prims.append(
                f'''
    def Capsule "{name}" {{
        double radius = {o.radius}
        double height = {h:.6g}
        uniform token axis = "Z"
        {_color(_OBSTACLE_COLOR)}
        double3 xformOp:translate = {_fmt(t)}
        quatf xformOp:orient = {_fmt(q_tot)}
        uniform token[] xformOpOrder = {order_to}
    }}'''
            )
        elif isinstance(o, gt.Cylinder):
            self._prims.append(
                f'''
    def Cylinder "{name}" {{
        double radius = {o.radius}
        double height = {o.height}
        {_color(_OBSTACLE_COLOR)}
        {xf}
        uniform token[] xformOpOrder = {order_to}
    }}'''
            )
        elif isinstance(o, gt.MeshObstacle):
            v, f = o.vertices, o.faces
            if v is None and getattr(o, "file_path", None):
                v, f = load_mesh(o.file_path, scale=tuple(o.scale))
            if v is None or f is None:
                return
            self.add_mesh(name, np.asarray(v), np.asarray(f), pose=o.pose)
        elif isinstance(o, gt.PointCloudObstacle):
            pts = _np(o.points)
            self._prims.append(
                f'''
    def Points "{name}" {{
        point3f[] points = [{", ".join(_fmt(p) for p in pts)}]
        float[] widths = [{", ".join("0.01" for _ in pts)}]
        {_color(_OBSTACLE_COLOR)}
        {xf}
        uniform token[] xformOpOrder = {order_to}
    }}'''
            )
        elif isinstance(o, gt.VoxelGridObstacle):
            # occupied voxels (sdf <= 0) as Points sized to the voxel
            data = _np(o.data)
            occ = np.argwhere(data <= 0.0)
            if len(occ) == 0:
                return
            dims = np.asarray(o.dims, np.float64)
            centers = (occ + 0.5) * o.voxel_size - dims / 2.0
            self._prims.append(
                f'''
    def Points "{name}" {{
        point3f[] points = [{", ".join(_fmt(p) for p in centers)}]
        float[] widths = [{", ".join(f"{o.voxel_size:.6g}" for _ in centers)}]
        {_color(_OBSTACLE_COLOR)}
        {xf}
        uniform token[] xformOpOrder = {order_to}
    }}'''
            )

    def add_mesh(
        self, name: str, vertices: np.ndarray, faces: np.ndarray, pose=None
    ) -> None:
        pts = ", ".join(_fmt(v) for v in np.asarray(vertices))
        counts = ", ".join("3" for _ in range(len(faces)))
        idx = ", ".join(str(int(i)) for i in np.asarray(faces).reshape(-1))
        xf = ""
        if pose is not None:
            x, y, z, qw, qx, qy, qz = [float(v) for v in pose]
            xf = f'''
        double3 xformOp:translate = {_fmt((x, y, z))}
        quatf xformOp:orient = {_fmt((qw, qx, qy, qz))}
        uniform token[] xformOpOrder = ["xformOp:translate", "xformOp:orient"]'''
        self._prims.append(
            f'''
    def Mesh "{_sanitize(name)}" {{
        point3f[] points = [{pts}]
        int[] faceVertexCounts = [{counts}]
        int[] faceVertexIndices = [{idx}]
        {_color(_OBSTACLE_COLOR)}{xf}
    }}'''
        )

    # ---- animated robot stage ------------------------------------------
    def add_robot_trajectory(
        self,
        params,
        q_traj: np.ndarray,
        name: str = "robot",
        visuals=None,
        asset_root: str = "",
        spheres: bool = True,
    ) -> None:
        """Animated per-link stage hierarchy (reference UsdWriter's robot
        stage, `usd_writer.py` link-mesh emission): q_traj (T, D) -> FK
        link transforms per frame; each link is an Xform with
        translate/orient timeSamples. Children: the link's VISUAL meshes
        (from `visuals` = {link_name: [{"mesh", "origin_xyz",
        "origin_rpy", "scale"}]}, paths resolved against `asset_root` —
        pass `Kinematics.visuals` / `Kinematics.asset_root`) and/or its
        collision spheres (`spheres=True`), all static in the link frame."""
        q = _np(q_traj)
        T = q.shape[0]
        st = _fk(params, q)
        rot = _np(st.link_rot)  # (T, L, 3, 3)
        pos = _np(st.link_pos)  # (T, L, 3)
        self._end_time = max(self._end_time, T / self.fps)
        centers = _np(params.sphere_centers)
        radii = _np(params.sphere_radii)
        visuals = visuals or {}
        link_spheres = {}
        if spheres:
            for s, l in enumerate(params.sphere_link_idx):
                if radii[s] >= 0:
                    link_spheres.setdefault(int(l), []).append(s)
        name_to_idx = {n: i for i, n in enumerate(params.link_names)}
        links = set(link_spheres) | {
            name_to_idx[n] for n in visuals if n in name_to_idx
        }
        for l in sorted(links):
            link_name = params.link_names[l]
            sph = link_spheres.get(l, [])
            tr = ",\n            ".join(
                f"{t / self.fps * 24.0:.4f}: {_fmt(pos[t, l])}" for t in range(T)
            )
            orient = ",\n            ".join(
                f"{t / self.fps * 24.0:.4f}: {_fmt(_rot_to_quat(rot[t, l]))}"
                for t in range(T)
            )
            children = "\n".join(
                f'''
        def Sphere "sphere_{s}" {{
            double radius = {float(radii[s]):.6g}
            {_color(_ROBOT_COLOR)}
            double3 xformOp:translate = {_fmt(centers[s])}
            uniform token[] xformOpOrder = ["xformOp:translate"]
        }}'''
                for s in sph
            )
            children += self._link_visual_prims(
                visuals.get(link_name, ()), asset_root
            )
            self._prims.append(
                f'''
    def Xform "{name}_{_sanitize(link_name)}" {{
        double3 xformOp:translate.timeSamples = {{
            {tr}
        }}
        quatf xformOp:orient.timeSamples = {{
            {orient}
        }}
        uniform token[] xformOpOrder = ["xformOp:translate", "xformOp:orient"]{children}
    }}'''
            )

    def _link_visual_prims(self, vis_list, asset_root: str) -> str:
        """Static Mesh prims for one link's visual entries, origins baked
        into the points (link-frame)."""
        out = []
        for k, v in enumerate(vis_list):
            path = v["mesh"]
            if asset_root and not os.path.isabs(path):
                path = os.path.join(asset_root, path)
            if not os.path.exists(path):
                log_warn(f"visual mesh not found, skipping: {path}")
                continue
            verts, faces = load_mesh(
                path, scale=tuple(v.get("scale", (1.0, 1.0, 1.0)))
            )
            if len(verts) == 0:
                continue
            R = rpy_to_matrix(tuple(v.get("origin_rpy", (0, 0, 0))))
            t = np.asarray(v.get("origin_xyz", (0, 0, 0)), dtype=np.float64)
            verts = verts @ R.T + t
            pts = ", ".join(_fmt(p) for p in verts)
            counts = ", ".join("3" for _ in range(len(faces)))
            idx = ", ".join(str(int(i)) for i in np.asarray(faces).reshape(-1))
            out.append(
                f'''
        def Mesh "visual_{k}" {{
            point3f[] points = [{pts}]
            int[] faceVertexCounts = [{counts}]
            int[] faceVertexIndices = [{idx}]
            {_color(_ROBOT_COLOR)}
        }}'''
            )
        return "".join(out)

    # ---- animated robot spheres (flat debug view) ----------------------
    def add_sphere_trajectory(
        self, spheres_over_time: np.ndarray, name: str = "robot"
    ) -> None:
        """spheres_over_time (T, S, 4): animated xyzr robot spheres."""
        arr = _np(spheres_over_time)
        T, S, _ = arr.shape
        self._end_time = max(self._end_time, T / self.fps)
        for s in range(S):
            if arr[0, s, 3] < 0:
                continue  # disabled placeholder
            samples = ",\n            ".join(
                f"{t / self.fps * 24.0:.4f}: {_fmt(arr[t, s, :3])}" for t in range(T)
            )
            self._prims.append(
                f'''
    def Sphere "{name}_sphere_{s}" {{
        double radius = {float(arr[0, s, 3]):.6g}
        {_color(_ROBOT_COLOR)}
        double3 xformOp:translate.timeSamples = {{
            {samples}
        }}
        uniform token[] xformOpOrder = ["xformOp:translate"]
    }}'''
            )

    # ---- io -----------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        body = "\n".join(self._prims)
        end_code = max(int(self._end_time * 24.0), 1)
        with open(path, "w") as f:
            f.write(
                f'''#usda 1.0
(
    upAxis = "Z"
    metersPerUnit = 1
    startTimeCode = 0
    endTimeCode = {end_code}
    timeCodesPerSecond = 24
)

def Xform "world" {{{body}
}}
'''
            )


def export_plan_usd(
    path: str,
    scene: gt.Scene,
    params,
    trajectory,  # JointState (H, D) or (B, H, D) -> first problem
    fps: float = 30.0,
    flat_spheres: bool = False,
    kin=None,  # Kinematics facade: its .visuals/.asset_root add link meshes
) -> None:
    """One-call trajectory export: scene + animated per-link robot stage
    (or the flat animated-sphere debug view). Pass `kin` (a `Kinematics`
    built from a config with `visual` entries) to render real link
    geometry instead of collision spheres."""
    q = trajectory.position
    if q.ndim == 3:
        q = q[0]
    w = UsdWriter(fps=fps)
    w.add_scene(scene)
    if flat_spheres:
        w.add_sphere_trajectory(_fk(params, q).spheres)
    else:
        visuals = getattr(kin, "visuals", None) or {}
        w.add_robot_trajectory(
            params,
            q,
            visuals=visuals,
            asset_root=getattr(kin, "asset_root", ""),
            spheres=not visuals,
        )
    w.save(path)
