"""Perception of the PyTorch package against the JAX package on the CPU:
observation types, `FilterDepth`, `RobotSegmenter` on the Franka, the dense
TSDF mapper (camera integration with RGB and features, LiDAR carving and
points, decay, stamping), the exact and JFA ESDFs, `render_depth`,
`refine_camera_pose`, `Mapper` checkpoints read across the two packages, and
the mapped ESDF through `compile_scene` into a small generic-route IK solve.

Inputs are made by numpy from seeds (`tests/_perception_scenes.py`) and given
to both packages. Tolerances (float32):
- dense integration: at least 99.9 % of voxels equal within 1e-5 in TSDF,
  weight, RGB and features; the rest may differ only where a voxel centre
  projects within 1e-3 px of a rounding tie (pixel edge), where the two
  packages' arithmetic orders may pick neighbouring pixels;
- ESDF (exact and JFA, same occupancy): within 1e-5 m;
- point clouds, filtered depth: within 1e-5; segmentation masks equal;
- rendered depth: 99 % of pixels within 1e-4 m;
- refined camera pose: within 1e-4 m and 1e-3 rad of the JAX result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.geom import types as jgt
from curobo_tpu.geom import world as jwm
from curobo_tpu.perception import mapper as jm
from curobo_tpu.perception import segmenter as jseg
from curobo_tpu.perception import types as jty
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu_torch.convert import tsdf_grid_from_numpy
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.math import quaternion as tqm
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig
from curobo_tpu_torch.perception import mapper as tm
from curobo_tpu_torch.perception import segmenter as tseg
from curobo_tpu_torch.perception import types as tty
from curobo_tpu_torch.types.pose import Pose as TPose

from _perception_scenes import example_frame, lidar_scan, sphere_depth, intrinsics, rot_to_quat

DEV = "cpu"
ATOL = 1e-5
GRID_KW = dict(dims=(48, 48, 40), voxel_size=0.025, origin=(-0.6, -0.6, -0.1))


def _obs(depth, K, pos, quat, rgb=None, feat=None):
    """The same observation in both packages."""
    j = jty.CameraObservation(
        jnp.asarray(depth), jnp.asarray(K), JPose(jnp.asarray(pos), jnp.asarray(quat)),
        rgb=None if rgb is None else jnp.asarray(rgb),
        feature=None if feat is None else jnp.asarray(feat))
    t = tty.CameraObservation(
        torch.tensor(depth), torch.tensor(K), TPose(torch.tensor(pos), torch.tensor(quat)),
        rgb=None if rgb is None else torch.tensor(rgb),
        feature=None if feat is None else torch.tensor(feat))
    return j, t


def _frames(F=4):
    """Two frames of the example's box: the example's camera, then a camera
    moved 5 cm and turned 0.1 rad about z; RGB and features from seeds."""
    depth, K, pos, quat = example_frame(80, 60)
    rng = np.random.RandomState(0)
    out = [_obs(depth, K, pos, quat, rng.uniform(size=(60, 80, 3)).astype(np.float32),
                rng.uniform(size=(60, 80, F)).astype(np.float32))]
    Rz = np.array([[np.cos(0.1), -np.sin(0.1), 0], [np.sin(0.1), np.cos(0.1), 0], [0, 0, 1]])
    from _perception_scenes import EXAMPLE_R, box_depth
    R2 = Rz @ EXAMPLE_R
    o2 = np.array([-1.0, -0.05, 0.55])
    d2 = box_depth(80, 60, K, R2, o2)
    out.append(_obs(d2, K, o2.astype(np.float32), rot_to_quat(R2),
                    rng.uniform(size=(60, 80, 3)).astype(np.float32),
                    rng.uniform(size=(60, 80, F)).astype(np.float32)))
    return out


def _assert_grid_close(jg, tg, share=0.999):
    """TSDF, weight, RGB and features equal within ATOL on >= `share` of the
    voxels."""
    bad = np.zeros(tuple(tg.tsdf.shape), bool)
    for k in ("tsdf", "weight", "rgb", "feature"):
        a, b = getattr(jg, k), getattr(tg, k)
        assert (a is None) == (b is None), k
        if a is None:
            continue
        d = np.abs(np.asarray(a) - b.numpy()).reshape(bad.shape + (-1,))
        bad |= (d > ATOL).any(-1)
    assert bad.mean() <= 1 - share, f"{int(bad.sum())} of {bad.size} voxels differ"
    return bad


def test_observation_types_match_jax():
    depth, K, pos, quat = example_frame(40, 30)
    depth[3, 4] = 0.0
    jo, to = _obs(depth, K, pos, quat)
    np.testing.assert_allclose(to.pointcloud().numpy(), np.asarray(jo.pointcloud()), atol=ATOL)
    assert float(to.pointcloud()[3 * 40 + 4, 0]) == 1e6
    pts = lidar_scan(32, 4)
    jl = jty.LidarObservation(jnp.asarray(pts), jo.pose)
    tl = tty.LidarObservation(torch.tensor(pts), to.pose)
    np.testing.assert_allclose(tl.world_points().numpy(), np.asarray(jl.world_points()),
                               atol=ATOL, equal_nan=True)


def test_filter_depth_matches_jax():
    depth, K, pos, quat = example_frame(80, 60)
    rng = np.random.RandomState(1)
    depth = depth + np.where(depth > 0, rng.normal(0, 0.01, depth.shape), 0).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
    jo, to = _obs(depth, K, pos, quat)
    a = np.asarray(jseg.FilterDepth()(jo).depth)
    b = tseg.FilterDepth()(to).depth.numpy()
    np.testing.assert_allclose(b, a, atol=ATOL)
    assert (b > 0).sum() > (depth > 0).sum()  # holes were filled


def test_robot_segmenter_matches_jax():
    """The Franka's spheres raycast into a 60 x 80 frame from 1.5 m, before a
    wall: the pixels on the robot are masked, the wall's are not."""
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device=DEV)
    kj = JKin.from_robot_yaml(ct.robot_config_path("franka"))
    q = kt.params.retract_config
    spheres = kt.compute_kinematics(q).spheres.numpy()
    R = np.array([[0, 0, -1], [1, 0, 0], [0, -1, 0]], dtype=np.float64)  # looking along -x
    origin = np.array([1.6, 0.0, 0.5])
    K = intrinsics(80, 60, 70.0)
    depth = sphere_depth(80, 60, K, R, origin, spheres, plane_t=2.4)
    jo, to = _obs(depth, K, origin.astype(np.float32), rot_to_quat(R))
    a = np.asarray(jseg.RobotSegmenter(kj.params).get_robot_mask(jo, jnp.asarray(q.numpy())))
    b = tseg.RobotSegmenter(kt.params).get_robot_mask(to, q).numpy()
    np.testing.assert_array_equal(b, a)
    assert 50 < b.sum() < b.size - 500
    removed = tseg.RobotSegmenter(kt.params).remove_robot(to, q).depth.numpy()
    assert (removed[b] == 0).all() and (removed[~b] == depth[~b]).all()


@pytest.fixture(scope="module")
def integrated():
    """Both packages' grids after the two frames (RGB, 4 features, an
    appearance budget small enough to cut the band)."""
    kw = dict(GRID_KW, rgb_channels=True, feature_channels=4, appearance_budget=400)
    jc, tc = jm.MapperConfig(**kw), tm.MapperConfig(**kw)
    jg, tg = jm.make_grid(jc), tm.make_grid(tc, DEV)
    step = jax.jit(lambda g, o: jm.integrate_camera(jc, g, o))
    for jo, to in _frames():
        jg, tg = step(jg, jo), tm.integrate_camera(tc, tg, to)
    return jc, tc, jg, tg


def _projection_ties(cfg, frames, tol=1e-3):
    """Voxels whose centre projects, in float64, within `tol` px of a rounding
    tie (a half-integer pixel coordinate) or of the image border, in any
    frame: where the two packages' float32 arithmetic may pick neighbouring
    pixels."""
    axes = [cfg.origin[k] + cfg.voxel_size * np.arange(cfg.dims[k]) for k in range(3)]
    x = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    ties = np.zeros(len(x), bool)
    for _, to in frames:
        R = tqm.quat_to_matrix(to.pose.quaternion.double()).numpy()
        pc = (x - to.pose.position.double().numpy()) @ R
        K = to.intrinsics.double().numpy()
        H, W = to.depth.shape
        z = np.maximum(pc[:, 2], 1e-6)
        for uv, n in ((pc[:, 0] / z * K[0, 0] + K[0, 2], W), (pc[:, 1] / z * K[1, 1] + K[1, 2], H)):
            ties |= (np.abs(uv - np.round(uv - 0.5) - 0.5) < tol) | (np.abs(uv) < tol) | (np.abs(uv - (n - 1)) < tol)
    return ties.reshape(tuple(cfg.dims))


def test_integrate_camera_matches_jax(integrated):
    jc, tc, jg, tg = integrated
    bad = _assert_grid_close(jg, tg)
    assert not (bad & ~_projection_ties(tc, _frames())).any()
    assert int((tg.weight > 0).sum()) > 1000
    # the budget cut the band: some band voxels got no appearance
    assert int(((tg.weight > 0) & (tg.rgb.abs().sum(-1) == 0)).sum()) > 0


def test_integrate_lidar_carving_and_points_match_jax():
    pts = lidar_scan(128, 16)
    pos, quat = np.array([0.1, 0.0, 0.4], np.float32), np.array([0.9950042, 0, 0, 0.0998334], np.float32)
    jl = jty.LidarObservation(jnp.asarray(pts), JPose(jnp.asarray(pos), jnp.asarray(quat)))
    tl = tty.LidarObservation(torch.tensor(pts), TPose(torch.tensor(pos), torch.tensor(quat)))
    kw = dict(GRID_KW, lidar_bins=(128, 16))
    jc, tc = jm.MapperConfig(**kw), tm.MapperConfig(**kw)
    np.testing.assert_array_equal(tm._lidar_range_image(tc, tl.points).numpy(),
                                  np.asarray(jm._lidar_range_image(jc, jl.points)))
    jg = jax.jit(lambda g, o: jm.integrate_lidar(jc, g, o))(jm.make_grid(jc), jl)
    tg = tm.integrate_lidar(tc, tm.make_grid(tc, DEV), tl)
    _assert_grid_close(jg, tg)
    assert int(((tg.weight > 0) & (tg.tsdf >= tc.truncation)).sum()) > 1000  # carved free
    jg = jax.jit(lambda g, o: jm.integrate_lidar_points(jc, g, o))(jg, jl)
    tg = tm.integrate_lidar_points(tc, tg, tl)
    _assert_grid_close(jg, tg, share=1.0)


def test_decay_and_stamp_match_jax(integrated):
    jc, tc, jg, tg = integrated
    jg2, tg2 = jm.decay(jc, jg, 0.5), tm.decay(tc, tg, 0.5)
    _assert_grid_close(jm.decay(jc, jg2, 0.001), tm.decay(tc, tg2, 0.001))
    scene = dict(cub=dict(name="crate", pose=[0.0, 0.2, 0.2, 1, 0, 0, 0], dims=[0.2, 0.3, 0.2]),
                 sph=dict(name="ball", pose=[-0.2, -0.2, 0.4, 1, 0, 0, 0], radius=0.1))
    jw = jwm.compile_scene(jgt.Scene().add(jgt.Cuboid(**scene["cub"]), jgt.SphereObstacle(**scene["sph"])))
    tw = ct.compile_scene(tgt.Scene().add(tgt.Cuboid(**scene["cub"]), tgt.SphereObstacle(**scene["sph"])),
                          device=DEV)
    js, ts = jm.stamp_obstacles(jc, jg, jw), tm.stamp_obstacles(tc, tg, tw)
    _assert_grid_close(js, ts)
    assert int((ts.weight == tc.max_weight).sum()) > 500


@pytest.mark.parametrize("name", ["exact_edt", "jfa_edt"])
def test_exact_and_jfa_edt_match_jax(name):
    """Scattered sites on a grid of uneven sides (the mapped occupancy runs
    through both in `test_compute_esdf_matches_jax`)."""
    occ = np.random.RandomState(3).uniform(size=(24, 30, 20)) < 0.01
    a = np.asarray(getattr(jm, name)(jnp.asarray(occ), 0.05))
    b = getattr(tm, name)(torch.tensor(occ), 0.05).numpy()
    np.testing.assert_allclose(b, a, atol=ATOL)
    assert b.max() > 0.1


@pytest.mark.parametrize("mode", ["exact", "jfa"])
def test_compute_esdf_matches_jax(integrated, mode):
    jc, tc, jg, tg = integrated
    jc, tc = dataclasses.replace(jc, esdf_mode=mode), dataclasses.replace(tc, esdf_mode=mode)
    a = np.asarray(jm.compute_esdf(jc, jg))
    b = tm.compute_esdf(tc, tg).numpy()
    np.testing.assert_allclose(b, a, atol=ATOL)
    assert (b < 0).sum() > 0 and (b > 0).sum() > 0


def test_render_depth_and_refine_camera_pose_match_jax(integrated):
    jc, tc, jg, tg = integrated
    (jo, to), _ = _frames()
    a = np.asarray(jax.jit(lambda g, o: jm.render_depth(jc, g, o.intrinsics, o.pose, (60, 80),
                                                        n_steps=96))(jg, jo))
    b = tm.render_depth(tc, tg, to.intrinsics, to.pose, (60, 80), n_steps=96).numpy()
    close = np.abs(a - b) <= 1e-4
    assert close.mean() >= 0.99, f"{int((~close).sum())} pixels differ"
    assert (b > 0).sum() > 100
    # the same frame seen from a camera 2 cm and 0.03 rad off
    dq = np.array([np.cos(0.015), 0, 0, np.sin(0.015)], np.float32)
    q_off = tqm.quat_multiply(torch.tensor(dq), to.pose.quaternion)
    p_off = to.pose.position + torch.tensor([0.02, -0.01, 0.0])
    to_off = dataclasses.replace(to, pose=TPose(p_off, q_off))
    jo_off = dataclasses.replace(jo, pose=JPose(jnp.asarray(p_off.numpy()), jnp.asarray(q_off.numpy())))
    jr = jax.jit(lambda g, o: jm.refine_camera_pose(jc, g, o, n_iters=10))(jg, jo_off)
    tr = tm.refine_camera_pose(tc, tg, to_off, n_iters=10)
    np.testing.assert_allclose(tr.position.numpy(), np.asarray(jr.position), atol=1e-4)
    ang = float(tqm.quat_geodesic_distance(tr.quaternion, torch.tensor(np.asarray(jr.quaternion))))
    assert ang < 1e-3, ang
    assert float((tr.position - to.pose.position).norm()) < float((p_off - to.pose.position).norm())


def test_mapper_checkpoints_cross_both_ways(integrated, tmp_path):
    jc, tc, jg, tg = integrated
    j = jm.Mapper(jc)
    j.grid = jg
    t = ct.Mapper(tc, device=DEV)
    j.save(str(tmp_path / "jax.npz"))
    t.load(str(tmp_path / "jax.npz"))
    _assert_grid_close(jg, t.grid, share=1.0)
    t.grid = tg
    t.save(str(tmp_path / "torch.npz"))
    j2 = jm.Mapper(jc)
    j2.load(str(tmp_path / "torch.npz"))
    _assert_grid_close(j2.grid, tg, share=1.0)
    # the converter carries the JAX state across without files
    conv = tsdf_grid_from_numpy({k: None if v is None else np.asarray(v)
                                 for k, v in dataclasses.asdict(jg).items()}, device=DEV)
    _assert_grid_close(jg, conv, share=1.0)
    with pytest.raises(ValueError, match="dims"):
        ct.Mapper(dataclasses.replace(tc, dims=(8, 8, 8)), device=DEV).load(str(tmp_path / "jax.npz"))


def test_mapper_facade_lidar_and_query_rgb(integrated):
    jc, tc, jg, tg = integrated
    t = ct.Mapper(tc, device=DEV)
    t.grid = tg
    pts = torch.tensor(np.random.RandomState(5).uniform([0.3, -0.2, 0.25], [0.6, 0.2, 0.65], (64, 3)),
                       dtype=torch.float32)
    j = jm.Mapper(jc)
    j.grid = jg
    np.testing.assert_allclose(t.query_rgb(pts).numpy(), np.asarray(j.query_rgb(jnp.asarray(pts.numpy()))),
                               atol=ATOL)
    assert t.stats()["bytes"] == j.stats()["bytes"]
    with pytest.raises(TypeError):
        t.integrate(object())


def test_mapped_esdf_into_compile_scene_and_generic_ik(monkeypatch):
    """The example's pipeline on the CPU: FilterDepth -> Mapper.integrate ->
    get_voxel_grid (equal to the JAX mapper's) -> compile_scene ->
    IKSolver.solve_pose (4 goals x 4 seeds, the generic route)."""
    depth, K, pos, quat = example_frame(80, 60)
    jo, to = _obs(depth, K, pos, quat)
    jmap, tmap = jm.Mapper(jm.MapperConfig(**GRID_KW)), ct.Mapper(tm.MapperConfig(**GRID_KW), device=DEV)
    jmap.integrate(jseg.FilterDepth()(jo))
    tmap.integrate(ct.FilterDepth()(to))
    jv, tv = jmap.get_voxel_grid("esdf_world"), tmap.get_voxel_grid("esdf_world")
    # the TSDFs agree within ATOL; occupancy (tsdf < 0) may differ only at
    # ties, voxels whose centre lies on a face of the box (|tsdf| <= ATOL),
    # and on the same grid the ESDFs agree
    jg, tg = jmap.grid, tmap.grid
    _assert_grid_close(jg, tg, share=1.0)
    occ_j = np.asarray((jg.weight > 0) & (jg.tsdf < 0))
    occ_t = ((tg.weight > 0) & (tg.tsdf < 0)).numpy()
    assert (np.abs(np.asarray(jg.tsdf))[occ_j != occ_t] <= ATOL).all()
    np.testing.assert_allclose(tm.compute_esdf(tmap.cfg, tsdf_grid_from_numpy(
        {"tsdf": np.asarray(jg.tsdf), "weight": np.asarray(jg.weight)}, device=DEV)).numpy(),
        np.asarray(jv.data), atol=ATOL)
    assert tv.pose == jv.pose and tuple(tv.dims) == tuple(jv.dims)
    assert (tv.data < 0).sum() > 0
    world = ct.compile_scene(tgt.Scene().add(tv), device=DEV)
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device=DEV)
    rng = np.random.RandomState(9)
    q = kt.params.retract_config + torch.as_tensor(rng.normal(0, 0.3, (16, 7)).astype(np.float32))
    q = q[ct.RobotSceneCollision(kt.params).validate(world, q)][:4]
    assert q.shape[0] == 4
    st = kt.compute_kinematics(q)
    goal = ct.Pose(st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0])
    solver = ct.IKSolver(kt.params, ct.IKConfig(n_seeds=4, lbfgs=LBFGSConfig(history=8, n_iters=30)),
                         device=DEV)

    def refuse(*a, **k):
        raise AssertionError("the kernel route ran")

    monkeypatch.setattr(solver, "_solve_impl_kernel", refuse)
    res = solver.solve_pose(world, goal)
    assert bool(res.success.all()), res.position_error
    assert bool(ct.RobotSceneCollision(kt.params).validate(world, res.solution).all())
