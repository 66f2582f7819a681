"""Inverse dynamics (RNEA) and torque-limited motion generation of the PyTorch
package against the JAX package on the CPU.

`compute_inverse_dynamics` on the Franka, the UR10e, the dual UR10e (a tree:
forces gathered from two children) and the Unitree G1 with its floating base
(prismatic joints), with a payload and an external wrench; a mimic robot whose
inertials and live mimic links are carried in through
`convert.kinematics_params_from_numpy` (the YAML has none); gravity
compensation; the autograd gradient against `jax.grad`; the torque term of
`RobotRollout.evaluate_trajectory` (Franka, weight 100, 3 kg payload, B = 4,
H = 32), cost and gradient, against the JAX `RobotRollout`; and a
torque-limited `TrajOptSolver`, `MPCSolver` and `MotionPlanner` that build and
run on the CPU at a small budget.

Tolerances (float32): torques within 1e-5 of the largest |tau|; the rollout's
cost and gradient to a relative error median < 1e-4 and 99th percentile <
1e-2 (`tests/test_pallas_ik.py:70-76`).
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
from curobo_tpu.geom import types as jgt
from curobo_tpu.geom import world as jwm
from curobo_tpu.robot.dynamics import Dynamics as JDynamics
from curobo_tpu.robot.dynamics import compute_inverse_dynamics as jid
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.rollout.robot_rollout import Goal as JGoal
from curobo_tpu.rollout.robot_rollout import RobotRollout as JRollout
from curobo_tpu.rollout.robot_rollout import RobotRolloutConfig as JRolloutConfig
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu.types.state import JointState as JJointState
from curobo_tpu_torch.convert import kinematics_params_from_numpy
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig
from curobo_tpu_torch.opt.mppi import MPPIConfig
from curobo_tpu_torch.robot.dynamics import Dynamics, compute_inverse_dynamics
from curobo_tpu_torch.rollout.robot_rollout import Goal, RobotRollout, RobotRolloutConfig
from curobo_tpu_torch.transition.bspline import BSplineConfig, BSplineTransition

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")
TAU_REL = 1e-5
MED, P99 = 1e-4, 1e-2


def _kins(robot):
    return (JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, robot + ".yml")),
            ct.Kinematics.from_robot_yaml(ct.robot_config_path(robot), device="cpu"))


def _states(rng, B, D, scale=1.0):
    q = rng.uniform(-1.0, 1.0, (B, D)).astype(np.float32) * scale
    qd = rng.normal(0.0, 1.0, (B, D)).astype(np.float32)
    qdd = rng.normal(0.0, 3.0, (B, D)).astype(np.float32)
    return q, qd, qdd


def _with_payload(p, kg, lib):
    if lib == "jax":
        return dataclasses.replace(p, link_mass=p.link_mass.at[p.n_links - 1].add(kg))
    m = p.link_mass.clone()
    m[p.n_links - 1] += kg
    return dataclasses.replace(p, link_mass=m)


def _assert_tau(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err < TAU_REL, err


# the G1's floating base is six prismatic and revolute joints; its JAX RNEA
# runs eagerly (a jit of its 60 links compiles for minutes)
@pytest.mark.parametrize("robot,payload,wrench", [
    ("franka", 0.0, False), ("franka", 3.0, True), ("ur10e", 2.0, True),
    ("dual_ur10e", 0.0, True), ("unitree_g1", 0.0, True),
])
def test_rnea_matches_jax(robot, payload, wrench):
    kj, kt = _kins(robot)
    pj, pt = kj.params, kt.params
    if payload:
        pj, pt = _with_payload(pj, payload, "jax"), _with_payload(pt, payload, "torch")
    rng = np.random.RandomState(len(robot) + int(payload))
    B = 8
    q, qd, qdd = _states(rng, B, kt.n_dof, 0.5 if robot == "unitree_g1" else 1.0)
    ew = rng.normal(0.0, 5.0, (B, pt.n_links, 6)).astype(np.float32) if wrench else None
    def fn(*x):
        return jid(pj, *x[:3], external_wrench=x[3] if wrench else None)

    args = [jnp.asarray(x) for x in (q, qd, qdd, ew if wrench else q)]
    ref = (fn if robot == "unitree_g1" else jax.jit(fn))(*args)
    got = compute_inverse_dynamics(pt, *(torch.as_tensor(x) for x in (q, qd, qdd)),
                                   external_wrench=None if ew is None else torch.as_tensor(ew))
    assert got.shape == (B, kt.n_dof)
    _assert_tau(got.numpy(), ref)


def _np_tree(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _np_tree(v)
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def test_mimic_robot_with_inertials_matches_jax():
    """`simple_mimic_robot.yml` with random inertials and its two chain links
    made live mimics of the one dof (multipliers 0.7 and -1.5): three links
    add to one torque."""
    kj, _ = _kins("simple_mimic_robot")
    rng = np.random.RandomState(3)
    L = kj.params.n_links
    A = rng.normal(0.0, 0.05, (L, 3, 3))
    inertia = (A @ np.swapaxes(A, -1, -2) + 0.01 * np.eye(3)).astype(np.float32)
    pj = dataclasses.replace(
        kj.params, dof_idx=(-1, 0, 0, 0),
        mimic_mult=jnp.asarray([0.0, 0.7, -1.5, 1.0], jnp.float32),
        link_mass=jnp.asarray(rng.uniform(0.5, 2.0, L).astype(np.float32)),
        link_com=jnp.asarray(rng.normal(0.0, 0.1, (L, 3)).astype(np.float32)),
        link_inertia=jnp.asarray(inertia),
    )
    pt = kinematics_params_from_numpy(_np_tree(pj), device="cpu")
    q, qd, qdd = _states(rng, 16, 1)
    ref = jid(pj, *(jnp.asarray(x) for x in (q, qd, qdd)))
    got = compute_inverse_dynamics(pt, *(torch.as_tensor(x) for x in (q, qd, qdd)))
    _assert_tau(got.numpy(), ref)
    assert float(np.abs(np.asarray(ref)).max()) > 1.0


def test_gravity_compensation_and_facade():
    kj, kt = _kins("franka")
    q = np.random.RandomState(5).uniform(-1.0, 1.0, (6, 7)).astype(np.float32)
    ref = JDynamics(kj.params).gravity_compensation(jnp.asarray(q))
    dyn = Dynamics(kt.params, device="cpu")
    got = dyn.gravity_compensation(torch.as_tensor(q))
    _assert_tau(got.numpy(), ref)
    # at rest the torques are the gravity compensation; moving adds to them
    z = torch.zeros_like(got)
    assert torch.equal(dyn.compute_inverse_dynamics(torch.as_tensor(q), z, z), got)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Dynamics(kt.params)  # the CUDA device by default


def test_gradient_matches_jax_grad():
    """d/d(q, qd, qdd) of a weighted torque sum, with payload and wrench."""
    kj, kt = _kins("franka")
    pj, pt = _with_payload(kj.params, 3.0, "jax"), _with_payload(kt.params, 3.0, "torch")
    rng = np.random.RandomState(11)
    q, qd, qdd = _states(rng, 8, 7)
    w = rng.normal(size=(8, 7)).astype(np.float32)
    ew = rng.normal(0.0, 5.0, (8, pt.n_links, 6)).astype(np.float32)

    def f_j(a, b, c):
        return jnp.sum(jnp.asarray(w) * jid(pj, a, b, c, external_wrench=jnp.asarray(ew)) ** 2)

    g_j = jax.jit(jax.grad(f_j, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, qd, qdd)))
    xs = [torch.as_tensor(x).requires_grad_(True) for x in (q, qd, qdd)]
    tau = compute_inverse_dynamics(pt, *xs, external_wrench=torch.as_tensor(ew))
    g_t = torch.autograd.grad((torch.as_tensor(w) * tau ** 2).sum(), xs)
    for a, b in zip(g_t, g_j):
        b = np.asarray(b, np.float64)
        assert np.abs(a.numpy() - b).max() < TAU_REL * np.abs(b).max() * 10


def _rel(a, b, floor):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / (np.abs(b) + floor)


def _assert_close(a, b, floor, what):
    r = _rel(a, b, floor)
    assert np.median(r) < MED and np.percentile(r, 99) < P99, (what, np.median(r), np.percentile(r, 99))


def _scene(mod):
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]))


def test_torque_term_of_the_rollout_matches_jax():
    """Franka, torque_limit_weight 100, payload 3 kg, B = 4, H = 32: the cost
    and its gradient with respect to the trajectory's position, velocity and
    acceleration."""
    kj, kt = _kins("franka")
    rng = np.random.RandomState(2)
    B, H, D = 4, 32, 7
    tr = BSplineTransition(BSplineConfig(degree=5, n_control=16, horizon=H))
    qs = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, D)).astype(np.float32))
    knots = qs[:, None] + torch.as_tensor(rng.normal(0, 0.6, (B, tr.cfg.n_free, D)).astype(np.float32))
    traj = tr.rollout(knots, qs, torch.full((B,), 0.03))
    st = kt.compute_kinematics(torch.as_tensor(rng.uniform(-1.0, 1.0, (B, D)).astype(np.float32)))
    pos, quat = st.tool_pose.position[:, 0].numpy(), st.tool_pose.quaternion[:, 0].numpy()
    kw = dict(torque_limit_weight=100.0, payload_mass=3.0)
    rt = RobotRollout(kt.params, RobotRolloutConfig(**kw))
    rj = JRollout(kj.params, JRolloutConfig(**kw))
    gt_ = Goal.from_pose(ct.Pose(torch.as_tensor(pos), torch.as_tensor(quat)))
    gj = JGoal.from_pose(JPose(jnp.asarray(pos), jnp.asarray(quat)))
    wt = ct.compile_scene(_scene(tgt), device="cpu")
    wj = jwm.compile_scene(_scene(jgt))
    fields = ("position", "velocity", "acceleration", "jerk")
    arrays = [getattr(traj, f).detach().numpy() for f in fields]

    def cost_j(p, v, a, j):
        return rj.evaluate_trajectory(wj, gj, JJointState(p, v, a, j)).cost

    c_j, vjp = jax.jit(lambda *x: jax.vjp(cost_j, *x))(*(jnp.asarray(x) for x in arrays))
    g_j = jax.jit(vjp)(jnp.ones_like(c_j))
    xs = [torch.as_tensor(x).requires_grad_(True) for x in arrays]
    res = rt.evaluate_trajectory(wt, gt_, ct.JointState(*xs))
    # the objective reads no jerk beyond its bound and smoothness terms,
    # which are 0 by default: its gradient is held where it is used
    g_t = torch.autograd.grad(res.cost.sum(), xs[:3])
    _assert_close(res.cost.detach().numpy(), c_j, 1e-2, "cost")
    for f, a, b in zip(fields, g_t, g_j):
        _assert_close(a.numpy(), b, 1.0, f"gradient by {f}")
    # the torque term is live on these trajectories: it moves the cost
    base = RobotRollout(kt.params, RobotRolloutConfig()).evaluate_trajectory(wt, gt_, traj)
    assert bool((res.cost.detach() > base.cost + 1.0).any())
    # where the YAML gives no effort the port's is inf: the term adds 0 and
    # its gradient stays finite
    lim = dataclasses.replace(kt.params.joint_limits,
                              effort=torch.full_like(kt.params.joint_limits.effort, float("inf")))
    free = RobotRollout(dataclasses.replace(kt.params, joint_limits=lim), RobotRolloutConfig(**kw))
    res_inf = free.evaluate_trajectory(wt, gt_, ct.JointState(*xs))
    g_inf = torch.autograd.grad(res_inf.cost.sum(), xs[:3])
    assert torch.equal(res_inf.cost.detach(), base.cost)
    assert all(torch.isfinite(g).all() for g in g_inf)


@pytest.fixture(scope="module")
def torque_franka():
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    return kt, ct.compile_scene(_scene(tgt), device="cpu")


def _torque_rollout(base):
    return dataclasses.replace(base, torque_limit_weight=100.0, payload_mass=3.0)


def test_torque_limited_solvers_run_on_the_generic_route(torque_franka):
    kt, world = torque_franka
    p = kt.params
    q0 = p.retract_config[None]
    st = kt.compute_kinematics(q0 + 0.2)
    goal = ct.Pose(st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0])
    tcfg = ct.TrajOptConfig(
        n_seeds=2, bspline=BSplineConfig(degree=5, n_control=8, horizon=12),
        lbfgs=LBFGSConfig(history=4, n_iters=3), finetune_attempts=0)
    tcfg = dataclasses.replace(tcfg, rollout=_torque_rollout(tcfg.rollout))
    ts = ct.TrajOptSolver(p, tcfg, device="cpu")
    assert ts._solve_kernel is None and not ts._use_kernel(ct.Goal.from_pose(goal))
    res = ts.solve_pose(world, goal, q0, (q0 + 0.2)[:, None].expand(1, 2, 7))
    assert torch.isfinite(res.trajectory.position).all() and torch.isfinite(res.cost).all()

    mcfg = ct.MPCConfig(mppi=MPPIConfig(n_particles=4, n_iters=1, init_std=0.05),
                        lbfgs=LBFGSConfig(history=4, n_iters=2))
    mcfg = dataclasses.replace(mcfg, rollout=_torque_rollout(mcfg.rollout))
    mpc = ct.MPCSolver(p, mcfg, device="cpu")
    assert mpc._solve_kernel is None
    out, state = mpc.step(world, mpc.make_goal(goal), mpc.setup(q0), ct.JointState.from_position(q0))
    assert torch.isfinite(out.command.position).all() and state.tick == 1


def test_torque_limited_planner_plans_end_to_end(torque_franka, monkeypatch):
    """IK on the kernel route (its plain version on the CPU), trajectory
    optimisation on the generic route, PRM on the retry."""
    kt, world = torque_franka
    p = kt.params
    tcfg = ct.TrajOptConfig(n_seeds=2, bspline=BSplineConfig(degree=5, n_control=8, horizon=12),
                            lbfgs=LBFGSConfig(history=4, n_iters=3), finetune_attempts=0)
    cfg = ct.MotionPlanConfig(
        ik=ct.IKConfig(n_seeds=4, use_particle_stage=False, lbfgs=LBFGSConfig(history=4, n_iters=4)),
        trajopt=dataclasses.replace(tcfg, rollout=_torque_rollout(tcfg.rollout)),
        n_trajopt_seeds=2, n_trajopt_seeds_retry=2, retry_ik_seed_scale=1)
    planner = ct.MotionPlanner(p, cfg, device="cpu")
    routes = []
    run = planner.trajopt._finetune_impl  # its last argument is use_kernel
    monkeypatch.setattr(planner.trajopt, "_finetune_impl",
                        lambda *a: routes.append(a[-1]) or run(*a))
    q0 = p.retract_config[None]
    far = ct.Pose(torch.tensor([[2.5, 2.5, 2.5]]), torch.tensor([[1.0, 0.0, 0.0, 0.0]]))
    res = planner.plan_pose(world, far, ct.JointState.from_position(q0))
    assert planner.last_attempts == 2 and not bool(res.success.any())
    assert routes == [False, False] and planner._prm is not None
    assert torch.isfinite(res.trajectory.position).all()
