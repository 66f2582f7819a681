"""Grasped objects, `RobotState` and per-problem worlds of the PyTorch package
against the JAX package on the CPU.

`AttachmentManager.attach_spheres` / `attach_box` / `detach` (the sphere
tables and the recomputed self-collision margins bit-equal to the JAX
package's), the kernels' tables built from the new params (the attached
spheres reach both kernel routes, no table of the old params is reused),
`RobotSceneCollision` with the payload, `RobotState`, and
`RobotRollout.evaluate_config_env` / `evaluate_trajectory_env` over 2 worlds x
4 problems against the JAX package's gather-and-vmap (the pattern of
`tests/test_multi_env.py`), and against the single-world calls bit for bit.

Tolerances (float32): the rollouts' cost to a relative error median < 1e-4 and
99th percentile < 1e-2 (`tests/test_pallas_ik.py:70-76`); flags equal.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.collision.robot_scene import AttachmentManager as JAttach
from curobo_tpu.collision.robot_scene import RobotSceneCollision as JRSC
from curobo_tpu.geom import types as jgt
from curobo_tpu.geom import world as jwm
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.rollout.robot_rollout import Goal as JGoal
from curobo_tpu.rollout.robot_rollout import RobotRollout as JRollout
from curobo_tpu.rollout.robot_rollout import RobotRolloutConfig as JRolloutConfig
from curobo_tpu.types import state as jstate
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu.types.state import JointState as JJointState
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.ops import ik_kernels as ikk
from curobo_tpu_torch.ops import self_collision_kernels as sck
from curobo_tpu_torch.ops import traj_kernels as tk
from curobo_tpu_torch.rollout.robot_rollout import Goal, RobotRollout, RobotRolloutConfig
from curobo_tpu_torch.transition.bspline import BSplineConfig, BSplineTransition

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")
MED, P99 = 1e-4, 1e-2
# the grasped box of examples/attached_object.py: 6 x 6 x 12 cm, 10 cm past the hand
BOX_HALF, BOX_OFFSET = (0.03, 0.03, 0.06), (0.0, 0.0, 0.10)


@pytest.fixture(scope="module")
def franka():
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "franka.yml"))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    return kj, kt, JAttach(kj.params), ct.AttachmentManager(kt.params)


def _same_spheres(pj, pt):
    for a, b in ((pj.sphere_centers, pt.sphere_centers), (pj.sphere_radii, pt.sphere_radii),
                 (pj.self_collision.pair_margin, pt.self_collision.pair_margin)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("op", ["attach_spheres", "attach_box", "detach"])
def test_attachment_matches_jax(franka, op):
    kj, kt, aj, at = franka
    assert at.n_slots == aj.n_slots == 4
    c = np.asarray([[0.0, 0.0, 0.05], [0.0, 0.02, 0.1], [0.01, 0.0, 0.15]], np.float32)
    r = np.asarray([0.03, 0.035, 0.04], np.float32)
    pj = aj.attach_spheres(kj.params, jnp.asarray(c), jnp.asarray(r))
    pt = at.attach_spheres(kt.params, torch.as_tensor(c), torch.as_tensor(r))
    if op == "attach_box":
        pj, pt = aj.attach_box(kj.params, BOX_HALF, BOX_OFFSET), at.attach_box(kt.params, BOX_HALF, BOX_OFFSET)
    elif op == "detach":
        pj, pt = aj.detach(pj), at.detach(pt)
        _same_spheres(kj.params, pt)  # detaching restores the robot's own tables
    _same_spheres(pj, pt)
    # the given params are left as they were
    assert torch.equal(kt.params.sphere_radii, ct.Kinematics.from_robot_yaml(
        ct.robot_config_path("franka"), device="cpu").params.sphere_radii)
    with pytest.raises(ValueError, match="reserved slots"):
        at.attach_spheres(kt.params, torch.zeros(5, 3), torch.ones(5))


def test_attached_spheres_reach_the_kernels_tables(franka):
    """Tables are built from the params a solver is given: the IK and
    trajectory kernels' tables and the pair kernels' tables (keyed by the
    margin tensor) of the attached params hold the payload's spheres and
    pairs, and those of the robot's own params are not reused."""
    _, kt, _, at = franka
    base, held = kt.params, at.attach_box(kt.params, BOX_HALF, BOX_OFFSET)
    cfg = ct.TrajOptConfig()
    t0 = tk.build_traj_tables(base, cfg.rollout, cfg.bspline, True, "cpu")
    t1 = tk.build_traj_tables(held, cfg.rollout, cfg.bspline, True, "cpu")
    i0 = ikk.IKCost(base, ct.IKConfig().rollout, "cpu").tables
    i1 = ikk.IKCost(held, ct.IKConfig().rollout, "cpu").tables
    live0 = int((base.sphere_radii >= 0).sum())
    for a, b in ((i0, i1), (t0.ik, t1.ik)):
        assert b.link_sph.shape[0] == a.link_sph.shape[0] + 4 == live0 + 4
        assert b.P > a.P
    s0 = sck.pair_tables(base.self_collision, base.n_spheres, "cpu")
    s1 = sck.pair_tables(held.self_collision, held.n_spheres, "cpu")
    assert s1 is not s0 and s1.pair_a.shape[0] == i1.P > s0.pair_a.shape[0]
    assert sck.pair_tables(held.self_collision, held.n_spheres, "cpu") is s1


def test_robot_scene_collision_with_payload_matches_jax(franka):
    kj, kt, aj, at = franka
    pj = aj.attach_box(kj.params, BOX_HALF, BOX_OFFSET)
    pt = at.attach_box(kt.params, BOX_HALF, BOX_OFFSET)
    scene = lambda mod: mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        mod.Cuboid(name="shelf", pose=[0.5, 0.0, 0.55, 1, 0, 0, 0], dims=[0.4, 0.8, 0.04]))
    wj, wt = jwm.compile_scene(scene(jgt)), ct.compile_scene(scene(tgt), device="cpu")
    rng = np.random.RandomState(4)
    q = (kt.params.retract_config.numpy() + rng.normal(0, 0.6, (256, 7))).astype(np.float32)
    rj = JRSC(pj).query(wj, jnp.asarray(q))
    rt = ct.RobotSceneCollision(pt).query(wt, torch.as_tensor(q))
    np.testing.assert_allclose(rt.scene_clearance.numpy(), rj.scene_clearance, atol=1e-5)
    np.testing.assert_allclose(rt.self_violation.numpy(), rj.self_violation, atol=1e-5)
    for f in ("in_collision", "out_of_bounds", "valid"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)))
    # the payload changes the answer for some configurations
    free = ct.RobotSceneCollision(kt.params).validate(wt, torch.as_tensor(q))
    assert bool((free & ~rt.valid).any())


def test_robot_state_matches_jax(franka):
    _, kt, _, _ = franka
    assert [f.name for f in dataclasses.fields(ct.RobotState)] == [
        f.name for f in dataclasses.fields(jstate.RobotState)]
    q = kt.params.retract_config[None]
    st = kt.compute_kinematics(q)
    js = ct.JointState.from_position(q, kt.joint_names)
    tau = ct.Dynamics(kt.params, device="cpu").gravity_compensation(q)
    rs = ct.RobotState(js, tool_poses=st.tool_pose, robot_spheres=st.spheres, torque=tau)
    assert rs.link_poses is None and rs.torque.shape == (1, 7)
    assert ct.RobotState(js).tool_poses is None
    with pytest.raises(dataclasses.FrozenInstanceError):
        rs.torque = tau


def _worlds(mod, stack):
    caps = {"cuboid": 2}
    table = mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2])
    w0 = mod.Scene().add(table)
    w1 = mod.Scene().add(table, mod.Cuboid(name="wall", pose=[0.1, 0.0, 0.5, 1, 0, 0, 0],
                                           dims=[0.12, 1.0, 1.0]))
    if mod is jgt:
        return jwm.stack_worlds([jwm.compile_scene(w, capacities=caps) for w in (w0, w1)])
    ws = [ct.compile_scene(w, capacities=caps, device="cpu") for w in (w0, w1)]
    return ct.stack_worlds(ws) if stack else ws


@pytest.fixture(scope="module")
def env_problems(franka):
    kj, kt, _, _ = franka
    rng = np.random.RandomState(12)
    B = 8  # 2 worlds x 4 problems, interleaved
    env = np.asarray([0, 1, 1, 0, 1, 0, 0, 1], np.int32)
    q = (kt.params.retract_config.numpy() + rng.normal(0, 0.5, (B, 7))).astype(np.float32)
    st = kt.compute_kinematics(torch.as_tensor(q + rng.normal(0, 0.3, (B, 7)).astype(np.float32)))
    pos, quat = st.tool_pose.position[:, 0].numpy(), st.tool_pose.quaternion[:, 0].numpy()
    return dict(env=env, q=q, B=B,
                gt=Goal.from_pose(ct.Pose(torch.as_tensor(pos), torch.as_tensor(quat))),
                gj=JGoal.from_pose(JPose(jnp.asarray(pos), jnp.asarray(quat))),
                rt=RobotRollout(kt.params, RobotRolloutConfig()),
                rj=JRollout(kj.params, JRolloutConfig()))


def _check_env(res, res_j, singles, env):
    r = lambda a, b: np.abs(np.asarray(a, np.float64) - b) / (np.abs(b) + 1e-2)
    rel = r(res.cost.numpy(), np.asarray(res_j.cost, np.float64))
    assert np.median(rel) < MED and np.percentile(rel, 99) < P99, rel
    for f in ("feasible", "in_collision", "self_colliding", "out_of_bounds"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(res_j, f)))
    # equal, bit for bit, to one single-world call per world on its problems
    for e, single in enumerate(singles):
        rows = np.nonzero(env == e)[0]
        for f in ("cost", "pos_err", "rot_err", "feasible", "in_collision"):
            assert torch.equal(getattr(res, f)[rows], getattr(single, f)), f
    # the same configurations collide in one world and not the other
    assert res.in_collision.any() and not res.in_collision.all()


def test_evaluate_config_env_matches_jax(env_problems):
    p = env_problems
    res = p["rt"].evaluate_config_env(_worlds(tgt, True), torch.as_tensor(p["env"]), p["gt"],
                                      torch.as_tensor(p["q"]))
    res_j = p["rj"].evaluate_config_env(_worlds(jgt, True), jnp.asarray(p["env"]), p["gj"],
                                        jnp.asarray(p["q"]))
    singles = []
    for e, w in enumerate(_worlds(tgt, False)):
        rows = torch.as_tensor(np.nonzero(p["env"] == e)[0])
        g = dataclasses.replace(p["gt"], goal_pos=p["gt"].goal_pos[rows],
                                goal_quat=p["gt"].goal_quat[rows])
        singles.append(p["rt"].evaluate_config(w, g, torch.as_tensor(p["q"])[rows]))
    _check_env(res, res_j, singles, p["env"])
    with pytest.raises(IndexError, match="stacked worlds"):
        p["rt"].evaluate_config_env(_worlds(tgt, True), torch.full((p["B"],), 2), p["gt"],
                                    torch.as_tensor(p["q"]))


def test_evaluate_trajectory_env_matches_jax(env_problems):
    p = env_problems
    B, H = p["B"], 8
    tr = BSplineTransition(BSplineConfig(degree=3, n_control=6, horizon=H))
    rng = np.random.RandomState(13)
    qs = torch.as_tensor(p["q"])
    knots = qs[:, None] + torch.as_tensor(rng.normal(0, 0.2, (B, tr.cfg.n_free, 7)).astype(np.float32))
    traj = tr.rollout(knots, qs, torch.full((B,), 0.05))
    res = p["rt"].evaluate_trajectory_env(_worlds(tgt, True), p["env"], p["gt"], traj)
    jt = JJointState(*(jnp.asarray(getattr(traj, f).numpy())
                       for f in ("position", "velocity", "acceleration", "jerk")))
    res_j = p["rj"].evaluate_trajectory_env(_worlds(jgt, True), jnp.asarray(p["env"]), p["gj"], jt)
    singles = []
    for e, w in enumerate(_worlds(tgt, False)):
        rows = torch.as_tensor(np.nonzero(p["env"] == e)[0])
        g = dataclasses.replace(p["gt"], goal_pos=p["gt"].goal_pos[rows],
                                goal_quat=p["gt"].goal_quat[rows])
        singles.append(p["rt"].evaluate_trajectory(w, g, traj[rows]))
    _check_env(res, res_j, singles, p["env"])
