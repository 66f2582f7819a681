"""Meshes and point clouds of the PyTorch package against the JAX package on
the CPU: `load_mesh` on OBJ, binary and ASCII STL and DAE text written here,
`point_triangle_distance`, `mesh_to_sdf_grid` through the native library and
through its numpy plain version, `points_to_sdf_grid`, `extract_mesh`,
`compile_scene` with mesh and point-cloud obstacles, `SDFPoseDetector`,
`fit_spheres_to_mesh`; the copy of the native source is byte-identical to
the JAX package's, and a native build that cannot happen raises.

Every mesh is built here (a box, an icosphere); nothing is read from outside
the repository. Tolerances: loaded meshes equal; distances and baked grids
within 1e-5 m; refined poses within 1e-4 m and 1e-3 rad of the JAX result;
after one Adam step, fitted sphere centres and radii within 1e-3 m and the
fitting loss within 1e-3 relative (after 200 steps, losses within 10 %: see
`test_fit_spheres_to_mesh_matches_jax`).
"""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.geom import mesh as jmesh
from curobo_tpu.geom import sphere_fit as jfit
from curobo_tpu.geom import types as jgt
from curobo_tpu.geom import world as jwm
from curobo_tpu.perception import mesh_extract as jex
from curobo_tpu.perception.pose_estimation import PoseEstimationConfig as JPECfg
from curobo_tpu.perception.pose_estimation import SDFPoseDetector as JDetector
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu_torch.geom import mesh as tmesh
from curobo_tpu_torch.geom import sphere_fit as tfit
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.geom import world as twm
from curobo_tpu_torch.math import quaternion as tqm
from curobo_tpu_torch.ops import mesh_sdf as native
from curobo_tpu_torch.perception import mesh_extract as tex
from curobo_tpu_torch.perception.pose_estimation import PoseEstimationConfig, SDFPoseDetector
from curobo_tpu_torch.types.pose import Pose as TPose

from _perception_scenes import box_mesh, icosphere

ROOT = os.path.join(os.path.dirname(__file__), "..")
DEV = "cpu"
ATOL = 1e-5


def _write_obj(path, v, f):
    with open(path, "w") as fh:
        fh.write("# box\n")
        fh.writelines(f"v {x} {y} {z}\n" for x, y, z in v)
        fh.write("vn 0 0 1\n")
        # quads with texture/normal indices, fan-triangulated by the loader
        for a, b, c in f[::2]:
            fh.write(f"f {a + 1}/1/1 {b + 1}/1/1 {c + 1}/1/1\n")
        for a, b, c in f[1::2]:
            fh.write(f"f {a + 1} {b + 1} {c + 1}\n")


def _write_stl(path, v, f, binary):
    tri = v[f]
    if binary:
        with open(path, "wb") as fh:
            fh.write(b"solid but binary".ljust(80, b" "))  # a binary file whose header says solid
            fh.write(struct.pack("<I", len(tri)))
            for t in tri:
                fh.write(struct.pack("<12fH", 0, 0, 0, *t.reshape(-1), 0))
    else:
        with open(path, "w") as fh:
            fh.write("solid box\n")
            for t in tri:
                fh.write(" facet normal 0 0 0\n  outer loop\n")
                fh.writelines(f"   vertex {x} {y} {z}\n" for x, y, z in t)
                fh.write("  endloop\n endfacet\n")
            fh.write("endsolid box\n")


def _write_dae(path, v, f):
    """COLLADA with a namespace, centimetre units, Y up, one <triangles> and
    one <polylist> of quads."""
    pos = " ".join(f"{x}" for x in v.reshape(-1))
    tris = " ".join(f"{i} 0" for i in f[:6].reshape(-1))
    quads = f[6:]
    poly = " ".join(f"{i} 0" for i in quads.reshape(-1))
    with open(path, "w") as fh:
        fh.write(f"""<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
 <asset><unit meter="0.01"/><up_axis>Y_UP</up_axis></asset>
 <library_geometries><geometry id="g"><mesh>
  <source id="p"><float_array id="pa" count="{v.size}">{pos}</float_array></source>
  <source id="n"><float_array id="na" count="3">0 0 1</float_array></source>
  <vertices id="vx"><input semantic="POSITION" source="#p"/></vertices>
  <triangles count="6"><input semantic="VERTEX" source="#vx" offset="0"/>
   <input semantic="NORMAL" source="#n" offset="1"/><p>{tris}</p></triangles>
  <polylist count="{len(quads)}"><input semantic="VERTEX" source="#vx" offset="0"/>
   <input semantic="NORMAL" source="#n" offset="1"/>
   <vcount>{" ".join("3" for _ in quads)}</vcount><p>{poly}</p></polylist>
 </mesh></geometry></library_geometries>
</COLLADA>
""")


@pytest.mark.parametrize("fmt", ["obj", "stl_binary", "stl_ascii", "dae"])
def test_load_mesh_matches_jax(fmt, tmp_path):
    v, f = box_mesh((0.1, 0.2, 0.3))
    path = str(tmp_path / ("m." + fmt.split("_")[0]))
    if fmt == "obj":
        _write_obj(path, v, f)
    elif fmt == "dae":
        _write_dae(path, v, f)
    else:
        _write_stl(path, v, f, binary=fmt == "stl_binary")
    vt, ft = tmesh.load_mesh(path, scale=(1.0, 2.0, 1.0))
    vj, fj = jmesh.load_mesh(path, scale=(1.0, 2.0, 1.0))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert len(ft) == 12
    with pytest.raises(ValueError, match="unsupported"):
        tmesh.load_mesh(str(tmp_path / "m.ply"))


def test_point_triangle_distance_and_inside_mask_match_jax():
    v, f = icosphere(0.3, 1)
    pts = np.random.RandomState(0).uniform(-0.5, 0.5, (300, 3))
    np.testing.assert_array_equal(tmesh.point_triangle_distance(pts, v[f]),
                                  jmesh.point_triangle_distance(pts, v[f]))
    np.testing.assert_array_equal(tmesh._inside_mask(pts, v, f), jmesh._inside_mask(pts, v, f))


@pytest.mark.parametrize("shape", ["box", "icosphere"])
def test_mesh_to_sdf_grid_native_plain_and_jax(shape):
    v, f = box_mesh((0.06, 0.09, 0.12)) if shape == "box" else icosphere(0.1, 2)
    kw = dict(name="m", vertices=v, faces=f, voxel_size=0.02, scale=(1.0, 1.0, 1.5))
    g_n, o_n, c_n = tmesh.mesh_to_sdf_grid(tgt.MeshObstacle(**kw))
    g_p, o_p, c_p = tmesh.mesh_to_sdf_grid(tgt.MeshObstacle(**kw), plain=True)
    g_j, o_j, c_j = jmesh.mesh_to_sdf_grid(jgt.MeshObstacle(**kw))
    np.testing.assert_allclose(g_n, g_p, atol=ATOL)
    np.testing.assert_allclose(g_n, g_j, atol=ATOL)
    np.testing.assert_array_equal(o_n, o_j)
    assert c_n == c_p == c_j and (g_n < 0).sum() > 10 and (g_n > 0).sum() > 10


def test_points_to_sdf_grid_matches_jax():
    pts = np.random.RandomState(1).normal(0, 0.1, (500, 3))
    kw = dict(name="pc", points=pts, point_radius=0.015, voxel_size=0.02)
    g_t, o_t, c_t = tmesh.points_to_sdf_grid(tgt.PointCloudObstacle(**kw))
    g_j, o_j, c_j = jmesh.points_to_sdf_grid(jgt.PointCloudObstacle(**kw))
    np.testing.assert_allclose(g_t, g_j, atol=ATOL)
    np.testing.assert_array_equal(o_t, o_j)
    with pytest.raises(ValueError, match="needs"):
        tmesh.points_to_sdf_grid(tgt.PointCloudObstacle(name="empty", points=np.zeros((0, 3))))


def test_extract_mesh_matches_jax():
    ax = np.arange(20) * 0.05 - 0.5
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.3
    vt, ft = tex.extract_mesh(sdf, (-0.5, -0.5, -0.5), 0.05)
    vj, fj = jex.extract_mesh(sdf, (-0.5, -0.5, -0.5), 0.05)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert len(ft) > 100
    assert np.abs(np.linalg.norm(vt, axis=-1) - 0.3).max() < 0.05


def test_compile_scene_with_mesh_and_point_cloud_matches_jax():
    """A box mesh and a point cloud, posed, beside a cuboid: the baked grids
    equal the JAX package's within 1e-5 m, and the world's signed distances
    agree at random points."""
    v, f = box_mesh((0.05, 0.08, 0.1))
    pts = np.random.RandomState(2).normal(0, 0.05, (300, 3))

    def scene(mod):
        return mod.Scene().add(
            mod.Cuboid(name="table", pose=[0.4, 0.0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
            mod.MeshObstacle(name="crate", pose=[0.5, 0.2, 0.3, 0.9238795, 0, 0, 0.3826834],
                             vertices=v, faces=f, voxel_size=0.02),
            mod.PointCloudObstacle(name="cloud", pose=[0.3, -0.3, 0.4, 1, 0, 0, 0], points=pts,
                                   point_radius=0.01, voxel_size=0.02))

    wt = ct.compile_scene(scene(tgt), device=DEV)
    wj = jwm.compile_scene(scene(jgt))
    assert [g.name for g in wt.voxel_grids] == [g.name for g in wj.voxel_grids] == ["crate", "cloud"]
    for gt_, gj in zip(wt.voxel_grids, wj.voxel_grids):
        for k in ("rot", "pos", "origin", "cell_size", "data", "enabled"):
            np.testing.assert_allclose(getattr(gt_, k).numpy(), np.asarray(getattr(gj, k)),
                                       atol=ATOL, err_msg=k)
    q = np.random.RandomState(3).uniform([0.1, -0.5, 0.0], [0.7, 0.4, 0.6], (400, 3)).astype(np.float32)
    dt = twm.sphere_sdf(wt, torch.tensor(q)).numpy()
    dj = np.asarray(jwm.sphere_sdf(wj, jnp.asarray(q)))
    np.testing.assert_allclose(dt, dj, atol=ATOL)
    assert (dt < 0).sum() > 0


def _surface_points(h, n=256, seed=0):
    """Points on the surface of a box of half extents h (object frame), as in
    `tests/test_pose_estimation.py`."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, 3)) * h
    face = np.argmax(np.abs(pts) / h, axis=-1)
    pts[np.arange(n), face] = np.sign(pts[np.arange(n), face]) * h[face]
    return pts


def test_sdf_pose_detector_matches_jax():
    """`tests/test_pose_estimation.py`'s small offset: 3 cm and a quaternion
    nudge off a 0.3 rad yaw; both packages recover the pose and agree."""
    h = np.array([0.06, 0.09, 0.12])
    v, f = box_mesh(h)
    kw = dict(name="box", vertices=v, faces=f, voxel_size=0.01)
    det_t = SDFPoseDetector(tgt.MeshObstacle(**kw), PoseEstimationConfig(n_iters=40), device=DEV)
    det_j = JDetector(jgt.MeshObstacle(**kw), JPECfg(n_iters=40))
    true_pos = np.array([0.4, 0.1, 0.3])
    true_quat = np.array([np.cos(0.15), 0.0, 0.0, np.sin(0.15)])
    R = np.array([[np.cos(0.3), -np.sin(0.3), 0], [np.sin(0.3), np.cos(0.3), 0], [0, 0, 1]])
    pts = (_surface_points(h) @ R.T + true_pos).astype(np.float32)
    p0 = (true_pos + np.array([0.03, -0.02, 0.01])).astype(np.float32)
    q0 = true_quat + np.array([0.05, 0, 0, 0])
    q0 = (q0 / np.linalg.norm(q0)).astype(np.float32)
    pt, rms_t = det_t.refine(TPose(torch.tensor(p0), torch.tensor(q0)), torch.tensor(pts))
    pj, rms_j = det_j.refine(JPose(jnp.asarray(p0), jnp.asarray(q0)), jnp.asarray(pts))
    np.testing.assert_allclose(pt.position.numpy(), np.asarray(pj.position), atol=1e-4)
    ang = float(tqm.quat_geodesic_distance(pt.quaternion, torch.tensor(np.asarray(pj.quaternion))))
    assert ang < 1e-3, ang
    assert float(np.linalg.norm(pt.position.numpy() - true_pos)) < 0.01
    assert float(rms_t) < 0.01 and abs(float(rms_t) - float(rms_j)) < 1e-4


def test_fit_spheres_to_mesh_matches_jax():
    """One Adam step (the bake, the voxel seeds, the surface samples, the
    loss, its gradient and the update) equals the JAX package's within 1e-3 m
    and the loss within 1e-3 relative. Over the default 200 float32 steps the
    two part by millimetres, float32 rounding that Adam's scale-invariant
    step amplifies (`test_fit_spheres_to_mesh_float64_matches_jax` shows it);
    there both fits lower the loss below the seeds' and end within 10 % of
    each other."""
    v, f = box_mesh((0.05, 0.08, 0.12))
    mesh_t, mesh_j = (m.MeshObstacle(name="box", vertices=v, faces=f, voxel_size=0.01) for m in (tgt, jgt))
    c0, r0, loss = tfit._fit_problem(mesh_t, tfit.SphereFitConfig(n_spheres=8), torch.device(DEV))

    def fit_loss(c, r):
        return float(loss(torch.as_tensor(c), torch.as_tensor(r)))

    results = {}
    for n_iters in (1, 200):
        cfg_t = tfit.SphereFitConfig(n_spheres=8, n_iters=n_iters)
        ct_, rt = tfit.fit_spheres_to_mesh(mesh_t, cfg_t, device=DEV)
        cj, rj = jfit.fit_spheres_to_mesh(mesh_j, jfit.SphereFitConfig(n_spheres=8, n_iters=n_iters))
        results[n_iters] = (ct_, rt, cj, rj, fit_loss(ct_, rt), fit_loss(cj, rj))
    ct_, rt, cj, rj, lt, lj = results[1]
    np.testing.assert_allclose(ct_, cj, atol=1e-3)
    np.testing.assert_allclose(rt, rj, atol=1e-3)
    assert abs(lt - lj) <= 1e-3 * abs(lj), (lt, lj)
    l0 = fit_loss(c0, r0)
    _, _, _, _, lt, lj = results[200]
    assert lt < l0 and lj < l0 and abs(lt - lj) <= 0.1 * lj, (l0, lt, lj)
    assert tfit.estimate_sphere_count(mesh_t) == jfit.estimate_sphere_count(mesh_j)


def test_fit_spheres_to_mesh_float64_matches_jax(monkeypatch):
    """The 200-step gap of the float32 fits is float32 rounding, not a fault
    of the port: run in float64 (JAX under its scoped x64 switch, with
    float64 seeds; both keep the surface samples float32-valued), the two fits
    agree within 1e-9 m after 200 steps, while each float32 fit ends
    millimetres from the float64 one (the JAX fit's own float32 run
    included)."""
    import jax

    v, f = box_mesh((0.05, 0.08, 0.12))
    mesh_t, mesh_j = (m.MeshObstacle(name="box", vertices=v, faces=f, voxel_size=0.01) for m in (tgt, jgt))
    cfg_t, cfg_j = tfit.SphereFitConfig(n_spheres=8), jfit.SphereFitConfig(n_spheres=8)
    seeds32 = jfit.voxel_init
    monkeypatch.setattr(jfit, "voxel_init", lambda *a: tuple(x.astype(np.float64) for x in seeds32(*a)))
    with jax.enable_x64(True):
        cj, rj = jfit.fit_spheres_to_mesh(mesh_j, cfg_j)
    monkeypatch.setattr(jfit, "voxel_init", seeds32)
    ct64, rt64 = tfit.fit_spheres_to_mesh(mesh_t, cfg_t, device=DEV, dtype=torch.float64)
    assert cj.dtype == ct64.dtype == np.float64
    np.testing.assert_allclose(ct64, cj, atol=1e-9)
    np.testing.assert_allclose(rt64, rj, atol=1e-9)
    cj32, _ = jfit.fit_spheres_to_mesh(mesh_j, cfg_j)
    ct32, _ = tfit.fit_spheres_to_mesh(mesh_t, cfg_t, device=DEV)
    assert np.abs(cj32 - cj).max() > 1e-3 and np.abs(ct32 - cj).max() > 1e-3


def test_native_source_copy_is_byte_identical():
    with open(os.path.join(ROOT, "csrc", "mesh_sdf.cpp"), "rb") as a, open(native.SOURCE, "rb") as b:
        assert a.read() == b.read()


def test_native_build_fails_loudly(monkeypatch, tmp_path):
    """A missing source raises, a source that does not compile raises with
    the compiler's output, and the bake does not fall back to numpy."""
    with pytest.raises(FileNotFoundError, match="not found"):
        native.build_library(str(tmp_path / "missing.cpp"))
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("CUROBO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="failed"):
        native.build_library(str(bad))
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cpp"))
    v, f = box_mesh((0.05, 0.05, 0.05))
    with pytest.raises(FileNotFoundError):
        tmesh.mesh_to_sdf_grid(tgt.MeshObstacle(name="m", vertices=v, faces=f))
