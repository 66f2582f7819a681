"""Voxel-grid (ESDF) worlds of the PyTorch package against the JAX package on
the CPU.

`sample_voxel_grid` inside a grid, across its boundary blend and outside it,
with its gradient; `compile_scene` with `VoxelGridObstacle`s against the JAX
`WorldData` carried across by `convert.world_from_numpy`; `update_voxel_data`
(with its shape check), pose and enable updates; `stack_worlds` / `world_at`
with grids; `sphere_sdf` and the collision cost on a world of every obstacle
type plus a grid (`tests/test_blast.py`'s mixed world); the generic
objective's cost and gradient on a voxel world against the JAX `RobotRollout`;
an `IKSolver` solve and `MPCSolver` steps under perception updates on a voxel
world, which take the generic route; and mesh and point-cloud obstacles
without geometry, which raise.

Tolerances (float32): distances within 1e-5 m and their gradients within
1e-4; the objective's cost and gradient to a relative error median < 1e-4
and 99th percentile < 1e-2 (`tests/test_pallas_ik.py:70-76`).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.geom import sdf as jsdf
from curobo_tpu.geom import types as jgt
from curobo_tpu.geom import world as jwm
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.rollout.robot_rollout import Goal as JGoal
from curobo_tpu.rollout.robot_rollout import RobotRollout as JRollout
from curobo_tpu.rollout.robot_rollout import RobotRolloutConfig as JRolloutConfig
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu_torch.convert import world_from_numpy
from curobo_tpu_torch.geom import sdf as tsdf
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.geom import world as twm
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig
from curobo_tpu_torch.rollout.robot_rollout import Goal, RobotRollout, RobotRolloutConfig

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")
D_ATOL, G_ATOL = 1e-5, 1e-4
MED, P99 = 1e-4, 1e-2


def box_sdf_grid(shape, cell, center, boxes):
    """Exact SDF (min over axis-aligned boxes (lo, hi)) at the voxel centres
    of a grid of `shape` x `cell` centred at `center`, in numpy."""
    dims = np.asarray(shape) * cell
    axes = [center[k] - dims[k] / 2 + cell / 2 + cell * np.arange(shape[k]) for k in range(3)]
    x = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    d = np.full(shape, np.inf)
    for lo, hi in boxes:
        c, h = (np.asarray(lo) + hi) / 2, (np.asarray(hi) - lo) / 2
        q = np.abs(x - c) - h
        d = np.minimum(d, np.linalg.norm(np.maximum(q, 0), axis=-1) + np.minimum(q.max(-1), 0))
    return d.astype(np.float32)


TABLE = ((-0.2, -0.6, -0.2), (1.0, 0.6, 0.0))
BOX = ((0.35, -0.15, 0.3), (0.55, 0.15, 0.6))


def _esdf(mod, cell=0.05, shape=(36, 32, 24), center=(0.4, 0.0, 0.4), name="esdf"):
    data = box_sdf_grid(shape, cell, center, (TABLE, BOX))
    return mod.VoxelGridObstacle(name=name, pose=list(center) + [1, 0, 0, 0],
                                 dims=[s * cell for s in shape], voxel_size=cell, data=data)


def _mixed(mod):
    """Every primitive type plus a grid (the mixed world of tests/test_blast.py)."""
    cell = 0.05
    ax = np.arange(16) * cell - 0.4 + cell / 2
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    data = (np.sqrt(X**2 + Y**2 + Z**2) - 0.15).astype(np.float32)
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0.0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        mod.Cuboid(name="tilted", pose=[0.3, 0.4, 0.4, 0.92387953, 0.0, 0.0, 0.38268343],
                   dims=[0.2, 0.3, 0.4]),
        mod.SphereObstacle(name="ball", pose=[-0.4, 0.2, 0.6, 1, 0, 0, 0], radius=0.12),
        mod.Capsule(name="pole", pose=[0.0, -0.5, 0.0, 1, 0, 0, 0], radius=0.06,
                    base=[0, 0, 0], tip=[0, 0, 1.2]),
        mod.Cylinder(name="can", pose=[-0.3, -0.3, 0.3, 1, 0, 0, 0], radius=0.07, height=0.25),
        mod.VoxelGridObstacle(name="esdf", pose=[0.6, -0.4, 0.5, 0.9659, 0, 0, 0.2588],
                              dims=[0.8, 0.8, 0.8], voxel_size=cell, data=data),
    )


def _np_tree(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _np_tree(v)
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            out[f.name] = [_np_tree(x) for x in v]
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def _assert_same(a, b, path=""):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(va):
            _assert_same(va, vb, path + f.name + ".")
        elif isinstance(va, tuple) and va and dataclasses.is_dataclass(va[0]):
            assert len(va) == len(vb), path + f.name
            for i, (x, y) in enumerate(zip(va, vb)):
                _assert_same(x, y, f"{path}{f.name}[{i}].")
        elif isinstance(va, torch.Tensor):
            assert va.shape == vb.shape and va.dtype == vb.dtype, path + f.name
            assert torch.equal(va, vb), path + f.name
        else:
            assert va == vb, path + f.name


def _points(rng, n, lo, hi):
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


# a (6, 7, 5) grid of cell 0.1 with its first voxel centre at origin: it
# spans [origin - 0.05, origin + (shape - 0.5) * 0.1] on each axis
@pytest.mark.parametrize("region", ["inside", "boundary", "outside"])
def test_sample_voxel_grid_matches_jax(region):
    rng = np.random.RandomState(["inside", "boundary", "outside"].index(region))
    grid = rng.normal(0.0, 0.3, (6, 7, 5)).astype(np.float32)
    origin = np.asarray([-0.2, 0.1, 0.05], np.float32)
    top = origin + (np.asarray(grid.shape) - 1) * 0.1
    lo, hi = {"inside": (origin, top), "boundary": (origin - 0.1, top + 0.1),
              "outside": (origin - 2.0, origin - 0.11)}[region]
    x = _points(rng, 256, lo, hi)
    ref = jsdf.sample_voxel_grid(jnp.asarray(grid), jnp.asarray(x), jnp.asarray(origin), 0.1, 10.0)
    g_ref = jax.grad(lambda p: jnp.sum(jsdf.sample_voxel_grid(
        jnp.asarray(grid), p, jnp.asarray(origin), 0.1, 10.0) ** 2))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    d = tsdf.sample_voxel_grid(torch.as_tensor(grid), xt, torch.as_tensor(origin), 0.1, 10.0)
    (g,) = torch.autograd.grad((d ** 2).sum(), xt)
    np.testing.assert_allclose(d.detach().numpy(), ref, atol=D_ATOL)
    np.testing.assert_allclose(g.numpy(), g_ref, atol=G_ATOL * max(1.0, float(np.abs(g_ref).max())))
    if region == "outside":
        assert bool((d == 10.0).all())
    if region == "boundary":  # the blend into the outside value is reached
        assert 0 < int((d.detach() > 1.0).sum()) < 256


@pytest.fixture(scope="module")
def mixed():
    wj = jwm.compile_scene(_mixed(jgt), capacities={"cuboid": 3})
    wt = ct.compile_scene(_mixed(tgt), capacities={"cuboid": 3}, device="cpu")
    return wj, wt


def test_compile_scene_with_grids_matches_jax(mixed):
    wj, wt = mixed
    _assert_same(world_from_numpy(_np_tree(wj), device="cpu"), wt)
    (vg,) = wt.voxel_grids
    assert vg.name == "esdf" and vg.data.shape == (16, 16, 16)
    # a grid given no data is free space (10.0); the grid is centred on its pose
    two = ct.compile_scene(tgt.Scene().add(_esdf(tgt), tgt.VoxelGridObstacle(
        name="empty", pose=[0, 0, 1, 1, 0, 0, 0], dims=[0.3, 0.2, 0.1], voxel_size=0.1)),
        device="cpu")
    _assert_same(world_from_numpy(_np_tree(jwm.compile_scene(jgt.Scene().add(
        _esdf(jgt), jgt.VoxelGridObstacle(name="empty", pose=[0, 0, 1, 1, 0, 0, 0],
                                          dims=[0.3, 0.2, 0.1], voxel_size=0.1)))),
        device="cpu"), two)
    empty = two.voxel_grids[1]
    assert empty.data.shape == (3, 2, 1) and bool((empty.data == 10.0).all())
    np.testing.assert_allclose(empty.origin.numpy(), [-0.1, -0.05, 0.0], atol=1e-7)


def _sdf_pair(wj, wt, x):
    return (np.asarray(jwm.sphere_sdf(wj, jnp.asarray(x))),
            twm.sphere_sdf(wt, torch.as_tensor(x)).numpy())


def test_sphere_sdf_and_collision_cost_match_jax(mixed):
    wj, wt = mixed
    rng = np.random.RandomState(5)
    x = _points(rng, 2048, (-0.8, -1.0, -0.3), (1.2, 0.6, 1.2))
    ref, got = _sdf_pair(wj, wt, x)
    np.testing.assert_allclose(got, ref, atol=D_ATOL)
    # the grid is the nearest obstacle for some points
    vg_only = dataclasses.replace(wt, cuboids=dataclasses.replace(
        wt.cuboids, enabled=torch.zeros(3)))
    assert np.isclose(twm.sphere_sdf(vg_only, torch.as_tensor(x)).numpy(), got).any()
    spheres = np.concatenate([x.reshape(8, 256, 3), rng.uniform(
        -0.02, 0.08, (8, 256, 1)).astype(np.float32)], axis=-1)
    c_ref = jwm.collision_cost(wj, jnp.asarray(spheres), 0.025)
    st = torch.as_tensor(spheres).requires_grad_(True)
    c = twm.collision_cost(wt, st, 0.025)
    np.testing.assert_allclose(c.detach().numpy(), c_ref, atol=D_ATOL)
    g_ref = jax.grad(lambda s: jnp.sum(jwm.collision_cost(wj, s, 0.025)))(jnp.asarray(spheres))
    (g,) = torch.autograd.grad(c.sum(), st)
    np.testing.assert_allclose(g.numpy(), g_ref, atol=G_ATOL)
    assert 0 < int((c > 0).sum()) < c.numel()


def test_voxel_updates_match_jax(mixed):
    wj, wt = mixed
    rng = np.random.RandomState(6)
    x = _points(rng, 512, (0.1, -0.9, 0.0), (1.1, 0.1, 1.0))
    new = rng.normal(0.0, 0.2, (16, 16, 16)).astype(np.float32)
    steps = [
        lambda w, lib: w.update_voxel_data("esdf", (jnp if lib == "jax" else torch).asarray(new)),
        lambda w, lib: w.update_obstacle_pose("esdf", [0.5, -0.3, 0.4], [0.9239, 0.0, 0.3827, 0.0]),
        lambda w, lib: w.enable_obstacle("esdf", False),
        lambda w, lib: w.enable_obstacle("esdf", True),
    ]
    for step in steps:
        wj, wt = step(wj, "jax"), step(wt, "torch")
        ref, got = _sdf_pair(wj, wt, x)
        np.testing.assert_allclose(got, ref, atol=D_ATOL)
    assert torch.equal(wt.voxel_grids[0].data, torch.as_tensor(new))
    # the given world is left as it was
    assert not torch.equal(mixed[1].voxel_grids[0].data, torch.as_tensor(new))
    with pytest.raises(ValueError, match="shape"):
        wt.update_voxel_data("esdf", torch.zeros(16, 16, 15))
    with pytest.raises(ValueError, match="not a voxel grid"):
        wt.update_voxel_data("table", torch.zeros(16, 16, 16))


def test_stack_worlds_and_world_at_with_grids():
    w0 = ct.compile_scene(tgt.Scene().add(_esdf(tgt)), device="cpu")
    w1 = w0.update_voxel_data("esdf", w0.voxel_grids[0].data - 0.1).update_obstacle_pose(
        "esdf", [0.3, 0.1, 0.4], [1, 0, 0, 0])
    stack = ct.stack_worlds([w0, w1])
    assert stack.voxel_grids[0].data.shape == (2, 36, 32, 24)
    for i, w in enumerate((w0, w1)):
        _assert_same(twm.world_at(stack, i), w)
    other = ct.compile_scene(tgt.Scene().add(_esdf(tgt, shape=(36, 32, 20))), device="cpu")
    with pytest.raises(ValueError, match="capacities"):
        ct.stack_worlds([w0, other])
    with pytest.raises(ValueError, match="voxel grids"):
        ct.stack_worlds([w0, ct.empty_world(device="cpu")])


def _rel(a, b, floor):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / (np.abs(b) + floor)


def _assert_close(a, b, floor, what):
    r = _rel(a, b, floor)
    assert np.median(r) < MED and np.percentile(r, 99) < P99, (what, np.median(r), np.percentile(r, 99))


def test_rollout_on_a_voxel_world_matches_jax():
    """The generic objective's cost, metrics and gradient (UR10e) in a world
    whose only obstacle is an ESDF of a table and a box."""
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "ur10e.yml"))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    wj = jwm.compile_scene(jgt.Scene().add(_esdf(jgt)))
    wt = ct.compile_scene(tgt.Scene().add(_esdf(tgt)), device="cpu")
    rng = np.random.RandomState(8)
    N, D = 64, kt.n_dof
    q = rng.uniform(-2.0, 2.0, (N, D)).astype(np.float32)
    st = kt.compute_kinematics(torch.as_tensor(rng.uniform(-1, 1, (N, D)).astype(np.float32)))
    pos, quat = st.tool_pose.position[:, 0].numpy(), st.tool_pose.quaternion[:, 0].numpy()
    gt_ = Goal.from_pose(ct.Pose(torch.as_tensor(pos), torch.as_tensor(quat)))
    gj = JGoal.from_pose(JPose(jnp.asarray(pos), jnp.asarray(quat)))
    rj = JRollout(kj.params, JRolloutConfig())
    rt = RobotRollout(kt.params, RobotRolloutConfig())

    def cost_j(qq):
        r = rj.evaluate_config(wj, gj, qq)
        return jnp.sum(r.cost), r

    (_, res_j), g_j = jax.jit(jax.value_and_grad(cost_j, has_aux=True))(jnp.asarray(q))
    qt = torch.as_tensor(q).requires_grad_(True)
    res = rt.evaluate_config(wt, gt_, qt)
    (g,) = torch.autograd.grad(res.cost.sum(), qt)
    _assert_close(res.cost.detach().numpy(), res_j.cost, 1e-2, "cost")
    _assert_close(g.numpy(), g_j, 1.0, "gradient")
    np.testing.assert_array_equal(res.in_collision.numpy(), np.asarray(res_j.in_collision))
    assert 0 < int(res.in_collision.sum()) < N


def test_ik_on_a_voxel_world_takes_the_generic_route(monkeypatch):
    """4 goals x 4 seeds on the Franka: FK of collision-free configurations
    near the retract pose, in the ESDF world; the kernel route never runs."""
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    world = ct.compile_scene(tgt.Scene().add(_esdf(tgt)), device="cpu")
    rng = np.random.RandomState(9)
    q = kt.params.retract_config + torch.as_tensor(rng.normal(0, 0.3, (16, 7)).astype(np.float32))
    ok = ct.RobotSceneCollision(kt.params).validate(world, q)
    q = q[ok][:4]
    assert q.shape[0] == 4
    st = kt.compute_kinematics(q)
    goal = ct.Pose(st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0])
    solver = ct.IKSolver(kt.params, ct.IKConfig(n_seeds=4, lbfgs=LBFGSConfig(history=8, n_iters=30)),
                         device="cpu")

    def refuse(*a, **k):
        raise AssertionError("the kernel route ran")

    monkeypatch.setattr(solver, "_solve_impl_kernel", refuse)
    res = solver.solve_pose(world, goal)
    assert bool(res.success.all()), res.position_error
    assert bool(ct.RobotSceneCollision(kt.params).validate(world, res.solution).all())


@pytest.mark.parametrize("cls", ["MeshObstacle", "PointCloudObstacle"])
def test_mesh_and_point_cloud_obstacles_still_raise(cls):
    """Mesh and point-cloud obstacles are baked into grids now
    (`tests/test_torch_mesh.py`); one without geometry still raises, naming
    what is missing."""
    match = "unsupported mesh format" if cls == "MeshObstacle" else "needs \\(N, 3\\) points"
    with pytest.raises(ValueError, match=match):
        ct.compile_scene(tgt.Scene().add(getattr(tgt, cls)(name="g")), device="cpu")


def test_mpc_on_a_voxel_world_takes_the_generic_route(monkeypatch):
    """One `MPCSolver.step` per perception update (`update_voxel_data`) at a
    small budget; the kernel route never runs."""
    from curobo_tpu_torch.opt.mppi import MPPIConfig

    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    world = ct.compile_scene(tgt.Scene().add(_esdf(tgt)), device="cpu")
    mpc = ct.MPCSolver(kt.params, ct.MPCConfig(mppi=MPPIConfig(n_particles=4, n_iters=1, init_std=0.05),
                                               lbfgs=LBFGSConfig(history=4, n_iters=2)), device="cpu")

    def refuse(*a, **k):
        raise AssertionError("the kernel route ran")

    monkeypatch.setattr(mpc, "_step_impl_kernel", refuse)
    q0 = kt.params.retract_config[None]
    st = kt.compute_kinematics(q0 + 0.3)
    goal = mpc.make_goal(ct.Pose(st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0]))
    state, js = mpc.setup(q0), ct.JointState.from_position(q0)
    for t in range(2):
        data = box_sdf_grid((36, 32, 24), 0.05, (0.4, 0.0, 0.4),
                            (TABLE, ((0.35, -0.15 + 0.01 * t, 0.3), (0.55, 0.15 + 0.01 * t, 0.6))))
        world = world.update_voxel_data("esdf", torch.as_tensor(data))
        res, state = mpc.step(world, goal, state, js)
        js = ct.JointState(position=res.command.position, velocity=res.command.velocity)
    assert state.tick == 2 and torch.isfinite(res.command.position).all()
    assert bool(res.feasible.all())
