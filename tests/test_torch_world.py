"""Collision world of the PyTorch package against the JAX package on the CPU:
compiled obstacle tables, the four packed kernel tables, the min signed
distance and its gradient at random points (against `scene_msdf_fori` called
with jnp arrays), sphere queries, and the joint-space collision API.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.geom import types as jgt
from curobo_tpu.geom import world as jwm
from curobo_tpu.ops import pallas_ik as jpik
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.geom import world as twm
from curobo_tpu_torch.ops import ik_kernels as ikk

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")


def _scene(mod):
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 0.9239, 0, 0, 0.3827], dims=[1.2, 1.0, 0.2]),
        mod.SphereObstacle(name="ball", pose=[0.3, 0.3, 0.5, 1, 0, 0, 0], radius=0.1),
        mod.Capsule(name="bar", pose=[0.5, -0.3, 0.4, 0.9239, 0.3827, 0, 0], radius=0.05,
                    base=[0, 0, -0.2], tip=[0, 0, 0.2]),
        mod.Cylinder(name="post", pose=[-0.3, 0.4, 0.3, 0.9659, 0, 0.2588, 0], radius=0.08, height=0.6),
    )


@pytest.fixture(scope="module")
def worlds():
    caps = {"cuboid": 2}
    return jwm.compile_scene(_scene(jgt), capacities=caps), ct.compile_scene(
        _scene(tgt), capacities=caps, device="cpu"
    )


@pytest.mark.parametrize("table", [0, 1, 2, 3], ids=["cuboid", "sphere", "capsule", "cylinder"])
def test_packed_world_tables_match_jax(worlds, table):
    wj, wt = worlds
    a = np.asarray(jpik.pack_world_arrays(wj)[table])
    b = ikk.pack_world_arrays(wt)[table].numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=1e-6)


def test_empty_world_tables_are_one_disabled_row():
    tabs = ikk.pack_world_arrays(ct.empty_world(device="cpu"))
    ref = jpik.pack_world_arrays(jwm.empty_world())
    for a, b in zip(ref, tabs):
        assert b.shape == a.shape and float(b.abs().sum()) == 0.0
    assert ikk.world_capacities(ct.empty_world(device="cpu")) == (1, 1, 1, 1)


def test_names_and_capacity_padding(worlds):
    wj, wt = worlds
    assert wt.cuboids.names == wj.cuboids.names == ("table", "_cuboid_slot_1")
    assert wt.cuboids.enabled.tolist() == [1.0, 0.0]
    with pytest.raises(ValueError, match="capacity"):
        ct.compile_scene(_scene(tgt), capacities={"cuboid": 0}, device="cpu")


def _points(n=512):
    rng = np.random.RandomState(3)
    return rng.uniform([-0.6, -0.8, -0.4], [1.1, 0.8, 0.9], (n, 3)).astype(np.float32)


def test_min_sdf_and_gradient_match_scene_msdf_fori(worlds):
    wj, wt = worlds
    pts = _points()
    refs = jpik.pack_world_arrays(wj)
    caps = jpik.world_capacities(wj)
    x, y, z = (jnp.asarray(pts[:, i]) for i in range(3))
    md, (gx, gy, gz) = jax.jit(
        lambda x, y, z: jpik.scene_msdf_fori(refs, caps, x, y, z, True)
    )(x, y, z)
    p = torch.as_tensor(pts).requires_grad_(True)
    d = ikk._scene_msdf_plain(ikk.pack_world_arrays(wt), p)
    (g,) = torch.autograd.grad(d.sum(), p)
    # same float32 formulas on the same inputs
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(md), atol=1e-5)
    ref_g = np.stack([np.asarray(gx), np.asarray(gy), np.asarray(gz)], axis=-1)
    # the gradient jumps where two obstacles (or two faces of a box) are
    # equally near: a rounding difference may pick the other one there
    close = np.abs(g.numpy() - ref_g).max(axis=-1) < 1e-5
    assert close.mean() >= 0.99


def test_sphere_sdf_and_clearance_match_jax(worlds):
    wj, wt = worlds
    pts = _points(256).reshape(4, 64, 3)
    np.testing.assert_allclose(
        twm.sphere_sdf(wt, torch.as_tensor(pts)).numpy(),
        np.asarray(jwm.sphere_sdf(wj, jnp.asarray(pts))), atol=1e-5,
    )
    rng = np.random.RandomState(4)
    radii = rng.uniform(-0.02, 0.1, (4, 64, 1)).astype(np.float32)
    sph = np.concatenate([pts, radii], axis=-1)
    np.testing.assert_allclose(
        twm.sphere_clearance(wt, torch.as_tensor(sph)).numpy(),
        np.asarray(jwm.sphere_clearance(wj, jnp.asarray(sph))), atol=1e-5,
    )


def test_world_updates_reach_the_tables(worlds):
    _, wt = worlds
    moved = wt.update_obstacle_pose("ball", [0.0, 0.1, 0.2], [1.0, 0.0, 0.0, 0.0])
    assert ikk.pack_world_arrays(moved)[1][0, :3].tolist() == pytest.approx([0.0, 0.1, 0.2])
    assert ikk.pack_world_arrays(wt)[1][0, :3].tolist() == pytest.approx([0.3, 0.3, 0.5])
    off = wt.enable_obstacle("table", False)
    assert ikk.pack_world_arrays(off)[0][0, 15].item() == 0.0
    with pytest.raises(ValueError, match="not in world"):
        wt.enable_obstacle("nope", True)


@pytest.mark.parametrize("cls", ["MeshObstacle", "VoxelGridObstacle", "PointCloudObstacle"])
def test_grid_obstacles_are_refused(cls):
    """A voxel grid compiles to one grid of free space (10.0) by default.
    Mesh and point-cloud obstacles bake into SDF grids
    (`tests/test_torch_mesh.py`); one without geometry is refused, naming
    what is missing."""
    scene = tgt.Scene().add(getattr(tgt, cls)(name="g"))
    if cls == "VoxelGridObstacle":
        (vg,) = ct.compile_scene(scene, device="cpu").voxel_grids
        assert vg.name == "g" and vg.data.shape == (20, 20, 20) and bool((vg.data == 10.0).all())
        return
    match = "unsupported mesh format" if cls == "MeshObstacle" else "needs \\(N, 3\\) points"
    with pytest.raises(ValueError, match=match):
        ct.compile_scene(scene, device="cpu")


def test_scene_round_trips_through_dict():
    s = _scene(tgt)
    again = tgt.Scene.from_dict(s.to_dict())
    assert [type(o).__name__ for o in again.obstacles] == [type(o).__name__ for o in s.obstacles]
    with pytest.raises(ValueError, match="already in scene"):
        s.add(tgt.Cuboid(name="table"))


@pytest.fixture(scope="module")
def collision_pair():
    from curobo_tpu.collision.robot_scene import RobotSceneCollision as JRSC
    from curobo_tpu.robot.kinematics import Kinematics as JKin

    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "ur10e.yml"))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    table = lambda mod: mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2])
    )
    return (JRSC(kj.params), jwm.compile_scene(table(jgt)),
            ct.RobotSceneCollision(kt.params), ct.compile_scene(table(tgt), device="cpu"))


def test_collision_query_matches_jax(collision_pair):
    rj, wj, rt, wt = collision_pair
    rng = np.random.RandomState(5)
    q = rng.uniform(-2.5, 2.5, (128, 6)).astype(np.float32)
    a, b = rj.query(wj, jnp.asarray(q)), rt.query(wt, torch.as_tensor(q))
    np.testing.assert_allclose(b.scene_clearance.numpy(), np.asarray(a.scene_clearance), atol=1e-5)
    np.testing.assert_allclose(b.self_violation.numpy(), np.asarray(a.self_violation), atol=1e-5)
    # validity may differ only where a clearance is within rounding of 0
    assert (b.valid.numpy() == np.asarray(a.valid)).mean() >= 0.99


def test_collision_sample_matches_jax(collision_pair):
    rj, wj, rt, wt = collision_pair
    qa, oka = rj.sample(wj, 24)
    qb, okb = rt.sample(wt, 24)
    assert bool(np.asarray(oka).all()) and bool(okb.all())
    np.testing.assert_allclose(qb.numpy(), np.asarray(qa), atol=1e-6)
    assert bool(rt.validate(wt, qb).all())
