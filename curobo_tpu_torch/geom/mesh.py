"""Mesh handling on the host: OBJ / STL / DAE loading and SDF voxelization.

Own copy of `curobo_tpu/geom/mesh.py` (numpy). Meshes and point clouds are
baked into dense SDF voxel grids when a scene is compiled and sampled
trilinearly on the device, as in the JAX package. `mesh_to_sdf_grid` bakes
through the native library (`ops/mesh_sdf.py`), which raises when it cannot be
built or loaded; the numpy bake (`point_triangle_distance` + `_inside_mask`)
is its plain version, taken only with ``plain=True``.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from curobo_tpu_torch.geom import types as gt


def load_mesh(path: str, scale=(1.0, 1.0, 1.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Load vertices/faces from .obj (ascii) or .stl (binary or ascii)."""
    lower = path.lower()
    if lower.endswith(".obj"):
        verts, faces = [], []
        with open(path, "r") as f:
            for line in f:
                if line.startswith("v "):
                    verts.append([float(v) for v in line.split()[1:4]])
                elif line.startswith("f "):
                    idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                    for k in range(1, len(idx) - 1):  # fan-triangulate
                        faces.append([idx[0], idx[k], idx[k + 1]])
        v = np.asarray(verts, dtype=np.float64)
        f_ = np.asarray(faces, dtype=np.int64)
    elif lower.endswith(".stl"):
        with open(path, "rb") as f:
            header = f.read(80)
            if header[:5] == b"solid":
                # Could still be binary; check size consistency.
                f.seek(80)
                (n_tri,) = struct.unpack("<I", f.read(4))
                import os

                if os.path.getsize(path) == 84 + n_tri * 50:
                    v, f_ = _read_binary_stl(f, n_tri)
                else:
                    v, f_ = _read_ascii_stl(path)
            else:
                (n_tri,) = struct.unpack("<I", f.read(4))
                v, f_ = _read_binary_stl(f, n_tri)
    elif lower.endswith(".dae"):
        v, f_ = _read_dae(path)
    else:
        raise ValueError(f"unsupported mesh format: {path}")
    return v * np.asarray(scale, dtype=np.float64), f_


def _read_dae(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal COLLADA geometry reader: every <geometry>/<mesh>'s
    <triangles>/<polylist> with the VERTEX input, concatenated into one
    (V, 3)/(F, 3) pair. Honors <unit meter=...> and <up_axis>. Enough for
    robot visual meshes (the reference ships .dae link visuals)."""
    import xml.etree.ElementTree as ET

    tree = ET.parse(path)
    root = tree.getroot()
    ns = {"c": root.tag.split("}")[0].strip("{")} if "}" in root.tag else {}
    pre = "c:" if ns else ""

    def findall(el, p):
        return el.findall(p.replace("X:", pre), ns)

    def find(el, p):
        return el.find(p.replace("X:", pre), ns)

    unit = find(root, "X:asset/X:unit")
    meter = float(unit.get("meter", "1")) if unit is not None else 1.0
    up_el = find(root, "X:asset/X:up_axis")
    up = (up_el.text or "Y_UP").strip() if up_el is not None else "Y_UP"

    all_v, all_f = [], []
    for geom in findall(root, ".//X:library_geometries/X:geometry"):
        mesh = find(geom, "X:mesh")
        if mesh is None:
            continue
        # source id -> float array
        sources = {}
        for src in findall(mesh, "X:source"):
            arr = find(src, "X:float_array")
            if arr is not None and arr.text:
                sources[src.get("id")] = np.asarray(
                    arr.text.split(), dtype=np.float64
                )
        # vertices id -> POSITION source
        vert_src = {}
        for ve in findall(mesh, "X:vertices"):
            for inp in findall(ve, "X:input"):
                if inp.get("semantic") == "POSITION":
                    vert_src[ve.get("id")] = inp.get("source", "").lstrip("#")
        for prim in findall(mesh, "X:triangles") + findall(mesh, "X:polylist"):
            inputs = findall(prim, "X:input")
            stride = 1 + max(int(i.get("offset", "0")) for i in inputs)
            v_off, v_src = 0, None
            for i in inputs:
                if i.get("semantic") == "VERTEX":
                    v_off = int(i.get("offset", "0"))
                    v_src = vert_src.get(i.get("source", "").lstrip("#"))
            if v_src is None or v_src not in sources:
                continue
            verts = sources[v_src].reshape(-1, 3)
            p_el = find(prim, "X:p")
            if p_el is None or not p_el.text:
                continue
            idx = np.asarray(p_el.text.split(), dtype=np.int64)
            vidx = idx.reshape(-1, stride)[:, v_off]
            if prim.tag.endswith("polylist"):
                vc_el = find(prim, "X:vcount")
                counts = np.asarray(
                    (vc_el.text or "").split(), dtype=np.int64
                )
                faces, pos = [], 0
                for c in counts:
                    for k in range(1, c - 1):  # fan-triangulate
                        faces.append(
                            [vidx[pos], vidx[pos + k], vidx[pos + k + 1]]
                        )
                    pos += c
                faces = np.asarray(faces, dtype=np.int64)
            else:
                faces = vidx.reshape(-1, 3)
            base = sum(len(v) for v in all_v)
            all_v.append(verts)
            all_f.append(faces + base)
    if not all_v:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    v = np.concatenate(all_v) * meter
    f_ = np.concatenate(all_f)
    if up == "Z_UP":
        pass  # URDF link frames are Z-up already
    elif up == "X_UP":
        v = v[:, [1, 0, 2]] * np.asarray([1.0, -1.0, 1.0])
    else:  # Y_UP (COLLADA default): rotate +90deg about X -> Z-up
        v = np.stack([v[:, 0], -v[:, 2], v[:, 1]], axis=-1)
    return v, f_


def _read_binary_stl(f, n_tri):
    data = np.frombuffer(f.read(n_tri * 50), dtype=np.uint8).reshape(n_tri, 50)
    tri = data[:, 12:48].copy().view(np.float32).reshape(n_tri, 3, 3)
    verts = tri.reshape(-1, 3).astype(np.float64)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    return verts, faces


def _read_ascii_stl(path):
    verts = []
    with open(path, "r") as f:
        for line in f:
            t = line.split()
            if t and t[0] == "vertex":
                verts.append([float(x) for x in t[1:4]])
    v = np.asarray(verts, dtype=np.float64)
    faces = np.arange(len(v), dtype=np.int64).reshape(-1, 3)
    return v, faces


def point_triangle_distance(points: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Unsigned distance from P points to T triangles -> (P, T). numpy, host.

    Standard closest-point-on-triangle via barycentric clamping (Ericson,
    Real-Time Collision Detection §5.1.5), vectorized over points x tris.
    """
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]  # (T, 3)
    ab = b - a
    ac = c - a
    p = points[:, None, :]  # (P, 1, 3)
    ap = p - a

    d1 = np.sum(ab * ap, axis=-1)
    d2 = np.sum(ac * ap, axis=-1)
    bp = p - b
    d3 = np.sum(ab * bp, axis=-1)
    d4 = np.sum(ac * bp, axis=-1)
    cp = p - c
    d5 = np.sum(ab * cp, axis=-1)
    d6 = np.sum(ac * cp, axis=-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    v_ab = np.clip(np.divide(d1, d1 - d3, out=np.zeros_like(d1), where=(d1 - d3) != 0), 0, 1)
    w_ac = np.clip(np.divide(d2, d2 - d6, out=np.zeros_like(d2), where=(d2 - d6) != 0), 0, 1)
    w_bc_num = d4 - d3
    w_bc = np.clip(
        np.divide(w_bc_num, w_bc_num + (d5 - d6), out=np.zeros_like(d4), where=(w_bc_num + d5 - d6) != 0),
        0, 1,
    )

    denom = va + vb + vc
    v = np.divide(vb, denom, out=np.zeros_like(vb), where=denom != 0)
    w = np.divide(vc, denom, out=np.zeros_like(vc), where=denom != 0)

    # Region selection (mutually exclusive masks).
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (~in_a) & (~in_b) & (~in_c) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (~in_a) & (~in_b) & (~in_c) & (~on_ab) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (
        (~in_a) & (~in_b) & (~in_c) & (~on_ab) & (~on_ac)
        & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    )
    interior = (~in_a) & (~in_b) & (~in_c) & (~on_ab) & (~on_ac) & (~on_bc)

    closest = np.where(in_a[..., None], a, 0.0)
    closest = np.where(in_b[..., None], b, closest)
    closest = np.where(in_c[..., None], c, closest)
    closest = np.where(on_ab[..., None], a + v_ab[..., None] * ab, closest)
    closest = np.where(on_ac[..., None], a + w_ac[..., None] * ac, closest)
    closest = np.where(on_bc[..., None], b + w_bc[..., None] * (c - b), closest)
    closest = np.where(
        interior[..., None], a + v[..., None] * ab + w[..., None] * ac, closest
    )
    return np.linalg.norm(p - closest, axis=-1)


def _inside_mask(points: np.ndarray, verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Even-odd ray cast along +x: True where point is inside the mesh."""
    tri = verts[faces]  # (T, 3, 3)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    counts = np.zeros(len(points), dtype=np.int64)
    # Möller–Trumbore with fixed direction (1, 0, 0), batched over points.
    d = np.array([1.0, 0.0, 0.0])
    e1 = b - a  # (T, 3)
    e2 = c - a
    h = np.cross(d, e2)  # (T, 3)
    det = np.sum(e1 * h, axis=-1)  # (T,)
    ok = np.abs(det) > 1e-12
    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    for i0 in range(0, len(points), 2048):  # chunk points to bound memory
        p = points[i0 : i0 + 2048]
        s = p[:, None, :] - a  # (P, T, 3)
        u = np.sum(s * h, axis=-1) * inv_det
        q = np.cross(s, e1)
        v = q[..., 0] * inv_det  # dot(d, q) with d=(1,0,0)
        t = np.sum(q * e2, axis=-1) * inv_det
        hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-9)
        counts[i0 : i0 + 2048] = np.sum(hit, axis=-1)
    return counts % 2 == 1


def mesh_to_sdf_grid(
    o: gt.MeshObstacle, padding: float = 0.05, plain: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Bake a mesh obstacle into (sdf_grid (X,Y,Z), origin (3,), cell_size).

    Grid covers the mesh AABB plus ``padding`` on every side, in the
    obstacle's local frame. The native library computes it; ``plain=True``
    takes the numpy version instead.
    """
    if o.vertices is not None and o.faces is not None:
        verts = np.asarray(o.vertices, dtype=np.float64) * np.asarray(o.scale)
        faces = np.asarray(o.faces, dtype=np.int64)
    else:
        verts, faces = load_mesh(o.file_path, o.scale)
    cell = float(o.voxel_size)
    lo = verts.min(axis=0) - padding
    hi = verts.max(axis=0) + padding
    shape = np.maximum(np.ceil((hi - lo) / cell).astype(int), 2)
    xs = lo[0] + (np.arange(shape[0]) + 0.5) * cell
    ys = lo[1] + (np.arange(shape[1]) + 0.5) * cell
    zs = lo[2] + (np.arange(shape[2]) + 0.5) * cell
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)

    if not plain:
        from curobo_tpu_torch.ops.mesh_sdf import mesh_sdf

        sdf = mesh_sdf(verts, faces, pts).reshape(tuple(shape))
    else:
        tri = verts[faces]
        # Chunk over points; min over triangles.
        dist = np.empty(len(pts), dtype=np.float64)
        for i0 in range(0, len(pts), 1024):
            dist[i0 : i0 + 1024] = point_triangle_distance(
                pts[i0 : i0 + 1024], tri
            ).min(axis=-1)
        inside = _inside_mask(pts, verts, faces)
        sdf = np.where(inside, -dist, dist).reshape(tuple(shape)).astype(np.float32)
    origin = (lo + cell / 2.0).astype(np.float32)
    return sdf, origin, cell


def points_to_sdf_grid(
    o: "gt.PointCloudObstacle", padding: float = 0.05
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Bake a point cloud into (sdf_grid (X,Y,Z), origin (3,), cell_size).

    Parity: the reference voxelizes point clouds into the collision world
    (`curobo/_src/geom/types.py:736`). Points are treated as surface
    samples of radius ``point_radius``: sdf = EDT(occupied voxels) -
    point_radius, so anything within the radius of a point is inside.
    """
    from scipy.ndimage import distance_transform_edt

    pts = np.asarray(o.points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[-1] != 3 or len(pts) == 0:
        raise ValueError(f"point cloud {o.name!r} needs (N, 3) points")
    cell = float(o.voxel_size)
    pad = padding + o.point_radius
    lo = pts.min(axis=0) - pad
    hi = pts.max(axis=0) + pad
    shape = np.maximum(np.ceil((hi - lo) / cell).astype(int) + 1, 2)
    idx = np.clip(
        np.round((pts - lo) / cell).astype(int), 0, shape - 1
    )
    occ = np.zeros(tuple(shape), dtype=bool)
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    dist = distance_transform_edt(~occ, sampling=cell)
    sdf = (dist - o.point_radius).astype(np.float32)
    origin = (lo + cell / 2.0).astype(np.float32)
    return sdf, origin, cell
