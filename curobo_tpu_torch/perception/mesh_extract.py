"""Mesh extraction from TSDF/SDF grids (naive surface nets).

Own copy of `curobo_tpu/perception/mesh_extract.py` (numpy on the host): one
vertex per sign-change cell, placed at the average of its edge crossings,
and faces between adjacent surface cells; no case tables.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def extract_mesh(
    sdf: np.ndarray, origin, cell_size: float, level: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """sdf (X, Y, Z) -> (vertices (V, 3) world coords, faces (F, 3) int).

    Returns empty arrays when no surface crosses ``level``.
    """
    sdf = np.asarray(sdf, dtype=np.float64) - level
    origin = np.asarray(origin, dtype=np.float64)
    X, Y, Z = sdf.shape

    # cells with a sign change among their 8 corners
    c = sdf
    corners = [
        c[:-1, :-1, :-1], c[1:, :-1, :-1], c[:-1, 1:, :-1], c[1:, 1:, :-1],
        c[:-1, :-1, 1:], c[1:, :-1, 1:], c[:-1, 1:, 1:], c[1:, 1:, 1:],
    ]
    stack = np.stack(corners)
    has_pos = (stack > 0).any(axis=0)
    has_neg = (stack <= 0).any(axis=0)
    surf = has_pos & has_neg  # (X-1, Y-1, Z-1)
    idxs = np.argwhere(surf)
    if len(idxs) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    # vertex per surface cell: average of edge zero-crossings
    cell_id = -np.ones(surf.shape, dtype=np.int64)
    cell_id[tuple(idxs.T)] = np.arange(len(idxs))

    edges = [  # (corner a offset, corner b offset)
        ((0, 0, 0), (1, 0, 0)), ((0, 1, 0), (1, 1, 0)), ((0, 0, 1), (1, 0, 1)), ((0, 1, 1), (1, 1, 1)),
        ((0, 0, 0), (0, 1, 0)), ((1, 0, 0), (1, 1, 0)), ((0, 0, 1), (0, 1, 1)), ((1, 0, 1), (1, 1, 1)),
        ((0, 0, 0), (0, 0, 1)), ((1, 0, 0), (1, 0, 1)), ((0, 1, 0), (0, 1, 1)), ((1, 1, 0), (1, 1, 1)),
    ]
    verts = np.zeros((len(idxs), 3))
    counts = np.zeros(len(idxs))
    base = idxs.astype(np.float64)
    for (a, b) in edges:
        va = sdf[idxs[:, 0] + a[0], idxs[:, 1] + a[1], idxs[:, 2] + a[2]]
        vb = sdf[idxs[:, 0] + b[0], idxs[:, 1] + b[1], idxs[:, 2] + b[2]]
        crossing = (va > 0) != (vb > 0)
        t = np.where(crossing, va / np.where(np.abs(va - vb) > 1e-12, va - vb, 1.0), 0.0)
        pt = base + np.asarray(a) + t[:, None] * (np.asarray(b) - np.asarray(a))
        verts += np.where(crossing[:, None], pt, 0.0)
        counts += crossing
    verts = verts / np.maximum(counts[:, None], 1.0)
    verts_world = origin + verts * cell_size

    # faces: two triangles per 2x2 block of mutually adjacent surface cells
    faces = []

    def cid(i, j, k):
        if 0 <= i < surf.shape[0] and 0 <= j < surf.shape[1] and 0 <= k < surf.shape[2]:
            return cell_id[i, j, k]
        return -1

    for (i, j, k) in idxs:
        v0 = cell_id[i, j, k]
        for (d1, d2) in (((1, 0, 0), (0, 1, 0)), ((1, 0, 0), (0, 0, 1)), ((0, 1, 0), (0, 0, 1))):
            v1 = cid(i + d1[0], j + d1[1], k + d1[2])
            v2 = cid(i + d2[0], j + d2[1], k + d2[2])
            v3 = cid(i + d1[0] + d2[0], j + d1[1] + d2[1], k + d1[2] + d2[2])
            if v1 >= 0 and v2 >= 0 and v3 >= 0:
                faces.append((v0, v1, v3))
                faces.append((v0, v3, v2))
    faces = np.asarray(faces, dtype=np.int64) if faces else np.zeros((0, 3), dtype=np.int64)
    return verts_world, faces
