"""Visualization facade (lazy imports).

Counterpart of `curobo_tpu/viewer.py`. The always-available backend is the
dependency-free USD(A) exporter (`util/usd_export.py`: every obstacle type as
a prim and an animated per-link robot stage); `viser` is used live when
installed (every obstacle type, robot spheres or link meshes, and a
trajectory playback slider) and imported only by `show_viser`, which raises
`ImportError` where it is not installed.
"""

from __future__ import annotations


def export_usd(
    path, scene, params, trajectory, fps: float = 30.0,
    flat_spheres: bool = False, kin=None,
) -> None:
    """Write a .usda file: scene prims + animated per-link robot stage.
    Pass `kin` (a `Kinematics` whose config carries `visual` entries) to
    render real link geometry instead of collision spheres."""
    from curobo_tpu_torch.util.usd_export import export_plan_usd

    export_plan_usd(
        path, scene, params, trajectory, fps=fps, flat_spheres=flat_spheres,
        kin=kin,
    )


def _add_obstacle_viser(server, o):
    import numpy as np

    from curobo_tpu_torch.geom import types as gt
    from curobo_tpu_torch.util.usd_export import _np

    pos = tuple(float(v) for v in o.pose[:3])
    qw, qx, qy, qz = (float(v) for v in o.pose[3:])
    wxyz = (qw, qx, qy, qz)
    path = f"/world/{o.name}"
    if isinstance(o, gt.Cuboid):
        server.scene.add_box(
            path, dimensions=tuple(o.dims), position=pos, wxyz=wxyz
        )
    elif isinstance(o, gt.SphereObstacle):
        server.scene.add_icosphere(path, radius=o.radius, position=pos)
    elif isinstance(o, gt.Capsule):
        # endpoints as spheres + a segment point cloud (viser has no capsule)
        base = np.asarray(o.base)
        tip = np.asarray(o.tip)
        for tag, p in (("base", base), ("tip", tip)):
            server.scene.add_icosphere(
                f"{path}/{tag}", radius=o.radius,
                position=tuple(np.asarray(pos) + p),
            )
    elif isinstance(o, gt.Cylinder):
        server.scene.add_icosphere(path, radius=o.radius, position=pos)
    elif isinstance(o, gt.MeshObstacle) and o.vertices is not None:
        server.scene.add_mesh_simple(
            path, vertices=np.asarray(o.vertices, np.float32),
            faces=np.asarray(o.faces, np.uint32), position=pos, wxyz=wxyz,
        )
    elif isinstance(o, gt.PointCloudObstacle) and o.points is not None:
        pts = np.asarray(o.points, np.float32)
        server.scene.add_point_cloud(
            path, points=pts + np.asarray(pos, np.float32),
            colors=np.full_like(pts, 0.5), point_size=o.point_radius,
        )
    elif isinstance(o, gt.VoxelGridObstacle) and o.data is not None:
        data = _np(o.data)
        occ = np.argwhere(data <= 0.0)
        if len(occ):
            centers = (
                (occ + 0.5) * o.voxel_size
                - np.asarray(o.dims, np.float32) / 2.0
                + np.asarray(pos, np.float32)
            ).astype(np.float32)
            server.scene.add_point_cloud(
                path, points=centers, colors=np.full_like(centers, 0.4),
                point_size=o.voxel_size,
            )


def show_viser(scene, params, trajectory=None, port: int = 8080, kin=None):
    """Interactive viser viewer (requires the optional `viser` package):
    all obstacle types + the robot (real link visual meshes when `kin`
    carries `visual` entries, collision spheres otherwise), with a
    playback slider when a trajectory is given (reference
    `ViserVisualizer`)."""
    try:
        import viser  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "viser is not installed; use viewer.export_usd for offline "
            "visualization"
        ) from e
    import os

    import numpy as np

    from curobo_tpu_torch.util.usd_export import _fk

    server = viser.ViserServer(port=port)
    for o in scene.obstacles:
        _add_obstacle_viser(server, o)
    if trajectory is not None:
        q = trajectory.position
        st = _fk(params, q[0] if q.ndim == 3 else q)
        visuals = getattr(kin, "visuals", None) or {}
        asset_root = getattr(kin, "asset_root", "")
        mesh_handles = []  # (handle, link_idx, R_vis, t_vis)
        if visuals:
            from curobo_tpu_torch.geom.mesh import load_mesh
            from curobo_tpu_torch.robot.urdf import rpy_to_matrix

            rot = _np(st.link_rot)  # (T, L, 3, 3)
            pos = _np(st.link_pos)  # (T, L, 3)
            name_to_idx = {n: i for i, n in enumerate(params.link_names)}
            for lname, vis_list in visuals.items():
                l = name_to_idx.get(lname)
                if l is None:
                    continue
                for k, v in enumerate(vis_list):
                    path = v["mesh"]
                    if asset_root and not os.path.isabs(path):
                        path = os.path.join(asset_root, path)
                    if not os.path.exists(path):
                        continue
                    verts, faces = load_mesh(
                        path, scale=tuple(v.get("scale", (1.0, 1.0, 1.0)))
                    )
                    if len(verts) == 0:
                        continue
                    Rv = rpy_to_matrix(tuple(v.get("origin_rpy", (0, 0, 0))))
                    tv = np.asarray(v.get("origin_xyz", (0, 0, 0)))
                    verts = verts @ Rv.T + tv  # bake into link frame
                    from scipy.spatial.transform import Rotation

                    wxyz = np.roll(
                        Rotation.from_matrix(rot[0, l]).as_quat(), 1
                    )
                    h = server.scene.add_mesh_simple(
                        f"/robot/{lname}_v{k}",
                        vertices=verts.astype(np.float32),
                        faces=faces.astype(np.int64),
                        position=tuple(pos[0, l]),
                        wxyz=tuple(wxyz),
                    )
                    mesh_handles.append((h, l))
            if pos.ndim == 3 and pos.shape[0] > 1:
                from scipy.spatial.transform import Rotation

                slider = server.gui.add_slider(
                    "frame", min=0, max=pos.shape[0] - 1, step=1,
                    initial_value=0,
                )

                @slider.on_update
                def _(_evt):
                    t = int(slider.value)
                    for h, l in mesh_handles:
                        h.position = tuple(pos[t, l])
                        h.wxyz = tuple(
                            np.roll(
                                Rotation.from_matrix(rot[t, l]).as_quat(), 1
                            )
                        )

            return server
        sph = _np(st.spheres)  # (T, S, 4)
        handles = {}
        for s in range(sph.shape[-2]):
            if sph[0, s, 3] < 0:
                continue
            handles[s] = server.scene.add_icosphere(
                f"/robot/s{s}", radius=float(sph[0, s, 3]),
                position=tuple(sph[0, s, :3]),
            )
        if sph.ndim == 3 and sph.shape[0] > 1:
            slider = server.gui.add_slider(
                "frame", min=0, max=sph.shape[0] - 1, step=1, initial_value=0
            )

            @slider.on_update
            def _(_evt, sph=sph, handles=handles, slider=slider):
                t = int(slider.value)
                for s, h in handles.items():
                    h.position = tuple(sph[t, s, :3])

    return server
