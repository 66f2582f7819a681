"""The motion planner of the PyTorch package on the CPU: its PRM graph seeding
and seed glue against the JAX package, then the slice end to end.

PRM nodes are Halton points in float64 numpy in both packages and must be
equal bit for bit; the node and swept-edge checks are boolean and must agree
exactly on numpy inputs. `_select_seeds` and `_merge_best` are held to JAX
on synthetic solver results. Then `MotionPlanner.plan_pose` on the Franka over problems of the
port's copy of `franka_motion.json` with a shallow budget (the plain versions
of the kernels on the CPU): a plan starts at q_start, a successful plan ends
within 5 mm / 0.05 rad of its goal by FK, the control-rate horizon is 234, and
an unreachable goal runs the retry attempt with PRM and fails without NaN.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.geom import types as jgt
from curobo_tpu.geom import world as jwm
from curobo_tpu.graph.prm import PRMConfig as JPRMConfig
from curobo_tpu.graph.prm import PRMGraphPlanner as JPRMGraphPlanner
from curobo_tpu.motion.planner import MotionPlanner as JMotionPlanner
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.solver.ik import IKResult as JIKResult
from curobo_tpu.solver.trajopt import TrajOptResult as JTrajOptResult
from curobo_tpu.types.state import JointState as JJointState
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.graph.prm import PRMConfig, PRMGraphPlanner
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig
from curobo_tpu_torch.solver.ik import IKResult

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")


@pytest.fixture(scope="module")
def suite():
    with open(ct.content_path("problems", "franka_motion.json")) as fh:
        return json.load(fh)


def _world(mod, spec, cap, **kw):
    return mod.compile_scene(
        (jgt if mod is jwm else tgt).Scene().add(
            *[(jgt if mod is jwm else tgt).Cuboid(**o) for o in spec["cuboids"]]
        ),
        capacities={"cuboid": cap}, **kw,
    )


@pytest.fixture(scope="module")
def franka(suite):
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "franka.yml"))
    spec, cap = suite["problems"][40]["world"], suite["cuboid_capacity"]
    return dict(kt=kt, kj=kj, wt=_world(ct, spec, cap, device="cpu"), wj=_world(jwm, spec, cap))


def test_prm_nodes_are_bit_equal_to_jax(franka):
    pj = JPRMGraphPlanner(franka["kj"].params, JPRMConfig(n_nodes=256))
    pt = PRMGraphPlanner(franka["kt"].params, PRMConfig(n_nodes=256))
    assert pt._nodes.dtype == np.float32
    assert np.array_equal(pt._nodes, np.asarray(pj._nodes))


def test_prm_node_and_edge_checks_match_jax(franka):
    pj = JPRMGraphPlanner(franka["kj"].params, JPRMConfig(n_nodes=8))
    pt = PRMGraphPlanner(franka["kt"].params, PRMConfig(n_nodes=8))
    rng = np.random.RandomState(0)
    lo, hi = pt._lo, pt._hi
    q = (lo + (hi - lo) * rng.uniform(size=(96, 7))).astype(np.float32)
    qa, qb = q[:48], q[48:]
    qb[:16] = qa[:16] + rng.normal(0, 0.1, (16, 7)).astype(np.float32)  # short edges
    nodes_j = np.asarray(pj._check_q(franka["wj"], jnp.asarray(q)))
    edges_j = np.asarray(pj._check_edges(franka["wj"], jnp.asarray(qa), jnp.asarray(qb)))
    nodes_t = pt._configs_free(franka["wt"], q)
    edges_t = pt._edges_free(franka["wt"], qa, qb)
    assert 0 < nodes_t.sum() < len(q) and 0 < edges_t.sum() < len(qa)  # both outcomes occur
    assert np.array_equal(nodes_t, nodes_j)
    assert np.array_equal(edges_t, edges_j)


def test_select_seeds_matches_jax():
    rng = np.random.RandomState(1)
    B, S, D = 4, 6, 7
    sols = rng.normal(size=(B, S, D)).astype(np.float32)
    succ = rng.uniform(size=(B, S)) < 0.5
    succ[0] = False  # a problem with no successful seed: every slot repaired
    succ[1] = True
    best = rng.normal(size=(B, D)).astype(np.float32)
    common = dict(success=np.zeros(B, bool), position_error=np.zeros(B, np.float32),
                  rotation_error=np.zeros(B, np.float32), cost=np.zeros(B, np.float32))
    rj = JIKResult(solution=jnp.asarray(best), seed_solutions=jnp.asarray(sols),
                   seed_success=jnp.asarray(succ), **{k: jnp.asarray(v) for k, v in common.items()})
    rt = IKResult(solution=torch.as_tensor(best), seed_solutions=torch.as_tensor(sols),
                  seed_success=torch.as_tensor(succ),
                  **{k: torch.as_tensor(v) for k, v in common.items()})
    for n in (2, 4):
        a = np.asarray(JMotionPlanner._select_seeds(None, rj, n))
        b = ct.MotionPlanner._select_seeds(rt, n).numpy()
        assert np.array_equal(a, b)


def test_merge_best_matches_jax():
    rng = np.random.RandomState(2)
    B, H, D = 6, 5, 7

    def result(mod_js, conv, seed):
        r = np.random.RandomState(seed)
        f = lambda *shape: conv(r.normal(size=shape).astype(np.float32))
        traj = mod_js(position=f(B, H, D), velocity=f(B, H, D), acceleration=f(B, H, D),
                      jerk=f(B, H, D), dt=f(B))
        succ = conv(np.asarray([True, False, True, True, False, True]) ^ (seed % 2 == 1))
        return dict(trajectory=traj, success=succ, dt=f(B), motion_time=f(B), position_error=f(B),
                    rotation_error=f(B), cost=f(B), free_knots=f(B, 4, D), q_end=f(B, D))

    a = JMotionPlanner._merge_best(JTrajOptResult(**result(JJointState, jnp.asarray, 3)),
                                   JTrajOptResult(**result(JJointState, jnp.asarray, 4)))
    b = ct.MotionPlanner._merge_best(ct.TrajOptResult(**result(ct.JointState, torch.as_tensor, 3)),
                                     ct.TrajOptResult(**result(ct.JointState, torch.as_tensor, 4)))
    for name in ("success", "dt", "motion_time", "position_error", "cost", "free_knots", "q_end"):
        assert np.array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name))), name
    for name in ("position", "velocity", "jerk", "dt"):
        assert np.array_equal(getattr(b.trajectory, name).numpy(),
                              np.asarray(getattr(a.trajectory, name))), name


# ---------------------------------------------------------------------------
# The slice end to end on the CPU, shallow budget
# ---------------------------------------------------------------------------
def _shallow_cfg(ik_iters=6, to_iters=6):
    ik = ct.IKConfig(n_seeds=8, warmup_iters=24, use_particle_stage=False,
                     lbfgs=LBFGSConfig(history=10, n_iters=ik_iters), kernel_linesearch=4)
    to = ct.TrajOptConfig(lbfgs=LBFGSConfig(history=6, n_iters=to_iters, max_step=0.5))
    return ct.MotionPlanConfig(ik=ik, trajopt=to, retry_ik_seed_scale=2, n_trajopt_seeds_retry=4)


@pytest.fixture(scope="module")
def planner(franka):
    return ct.MotionPlanner(franka["kt"].params, _shallow_cfg(), device="cpu")


def _inputs(p, cap, names):
    world = _world(ct, p["world"], cap, device="cpu")
    goal = ct.Pose(torch.tensor([p["goal_pose"][:3]]), torch.tensor([p["goal_pose"][3:]]))
    start = ct.JointState.from_position(torch.tensor([p["q_start"]]), names)
    return world, goal, start


def _check_reaches(kt, res, goal, start):
    q0 = start.position[0]
    assert float((res.solver_trajectory.position[0, 0] - q0).abs().max()) <= 1e-5
    assert float((res.trajectory.position[0, 0] - q0).abs().max()) <= 1e-5
    if bool(res.success[0]):
        tp = kt.tool_pose(res.solver_trajectory.position[:, -1])
        pe = float((tp.position.reshape(-1, 3)[0] - goal.position[0]).norm())
        dot = float((tp.quaternion.reshape(-1, 4)[0] * goal.quaternion[0]).sum().abs())
        assert pe <= 0.005 + 1e-5
        assert 2.0 * np.arccos(min(dot, 1.0)) <= 0.05 + 1e-4


@pytest.mark.parametrize("index", [0, 40], ids=["tabletop", "shelf"])
def test_plan_pose_reaches_the_goal(franka, planner, suite, index):
    kt = franka["kt"]
    world, goal, start = _inputs(suite["problems"][index], suite["cuboid_capacity"], kt.joint_names)
    res = planner.plan_pose(world, goal, start, attribute=True)
    assert bool(res.success[0]) and planner.last_attempts == 1
    _check_reaches(kt, res, goal, start)
    assert res.trajectory.position.shape == (1, 234, 7)  # ceil(0.15 * 31 / 0.02) + 1
    assert res.solver_trajectory.position.shape == (1, 32, 7)
    assert torch.isfinite(res.trajectory.velocity).all()
    assert {"ik_ms", "trajopt_ms", "interpolate_ms"} <= set(planner.last_attribution)
    # the whole trajectory is collision-free and inside the limits
    assert bool(ct.RobotSceneCollision(kt.params).validate_trajectory(
        world, res.solver_trajectory.position)[0])


def test_unreachable_goal_runs_the_retry_with_prm_and_fails_without_nan(franka, planner, suite):
    kt = franka["kt"]
    p = dict(suite["problems"][0])
    p["goal_pose"] = [2.5, 2.5, 2.5] + list(p["goal_pose"][3:])
    world, goal, start = _inputs(p, suite["cuboid_capacity"], kt.joint_names)
    res = planner.plan_pose(world, goal, start, attribute=True)
    assert planner.last_attempts == 2 and "graph_seed_ms" in planner.last_attribution
    assert not bool(res.success.any()) and not bool(res.ik_success.any())
    for t in (res.trajectory.position, res.solver_trajectory.position, res.position_error,
              res.motion_time):
        assert torch.isfinite(t).all()
    assert float((res.solver_trajectory.position[0, 0] - start.position[0]).abs().max()) <= 1e-5


def test_batch_planner_buckets_and_concatenates(franka, suite):
    kt = franka["kt"]
    # one attempt, shallow: this checks the bucketing, not the plans
    cfg = dataclasses.replace(_shallow_cfg(ik_iters=2, to_iters=2), max_attempts=1)
    bp = ct.BatchMotionPlanner(kt.params, cfg, max_batch_size=2, device="cpu")
    world, _, _ = _inputs(suite["problems"][0], suite["cuboid_capacity"], kt.joint_names)
    probs = [suite["problems"][i] for i in (0, 1, 2)]
    goals = ct.Pose(torch.tensor([p["goal_pose"][:3] for p in probs]),
                    torch.tensor([p["goal_pose"][3:] for p in probs]))
    start = ct.JointState.from_position(torch.tensor([p["q_start"] for p in probs]), kt.joint_names)
    res = bp.plan_pose(world, goals, start)
    assert res.success.shape == (3,) and res.trajectory.position.shape == (3, 234, 7)
    # every JointState is padded to the longest interpolated horizon, as the
    # JAX package's BatchMotionPlanner does, holding the last solver state
    assert res.solver_trajectory.position.shape == (3, 234, 7)
    tail = res.solver_trajectory.position[:, 31:]
    assert torch.equal(tail, res.solver_trajectory.position[:, 31:32].expand_as(tail))
    np.testing.assert_allclose(res.solver_trajectory.position[:, 0].numpy(),
                               start.position.numpy(), atol=1e-5)
    assert torch.isfinite(res.trajectory.position).all()


def test_plan_grasp_approaches_along_the_tool_axis(franka, planner, suite):
    kt = franka["kt"]
    world, goal, start = _inputs(suite["problems"][0], suite["cuboid_capacity"], kt.joint_names)
    approach, grasp_traj, ok = planner.plan_grasp(world, goal, start, approach_offset=0.05)
    assert bool(approach.success[0]) and bool(ok[0])
    assert grasp_traj.position.shape == (1, 12, 7)
    # the approach ends 5 cm back along the grasp frame's z axis
    tp = kt.tool_pose(approach.solver_trajectory.position[:, -1])
    d = goal.position[0] - tp.position.reshape(-1, 3)[0]
    assert abs(float(d.norm()) - 0.05) < 0.006
    end = kt.tool_pose(grasp_traj.position[:, -1]).position.reshape(-1, 3)[0]
    assert float((end - goal.position[0]).norm()) < 0.005 + 1e-5


def test_validate_trajectory_matches_jax(franka):
    from curobo_tpu.collision.robot_scene import RobotSceneCollision as JRSC

    rng = np.random.RandomState(4)
    q = np.cumsum(rng.normal(0, 0.15, (6, 10, 7)), axis=1).astype(np.float32)
    a = np.asarray(JRSC(franka["kj"].params).validate_trajectory(franka["wj"], jnp.asarray(q)))
    b = ct.RobotSceneCollision(franka["kt"].params).validate_trajectory(
        franka["wt"], torch.as_tensor(q)).numpy()
    assert np.array_equal(a, b)


def test_plan_cspace_and_device_refusals(franka, planner, suite):
    """plan_cspace runs on the Franka (the generic trajectory route; held to
    the JAX package in tests/test_torch_trajopt.py): from a suite problem's
    start to its goal configuration, pinned at both ends."""
    p = suite["problems"][40]
    names = franka["kt"].joint_names
    start = ct.JointState.from_position(torch.tensor([p["q_start"]]), names)
    goal = ct.JointState.from_position(torch.tensor([p["q_goal_oracle"]]), names)
    res = planner.plan_cspace(franka["wt"], goal, start)
    st = res.solver_trajectory
    assert st.position.shape == (1, 32, 7) and bool(res.ik_success.all())
    assert torch.isfinite(res.trajectory.position).all() and torch.isfinite(st.jerk).all()
    torch.testing.assert_close(st.position[:, 0], start.position, atol=1e-5, rtol=0)
    torch.testing.assert_close(st.position[:, -1], goal.position, atol=1e-5, rtol=0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.MotionPlanner(franka["kt"].params)
