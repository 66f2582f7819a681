"""Model-predictive control of the PyTorch package against the JAX package on
the CPU, on the UR10e at MPC's spline (3, 10, 24).

- `MPCConfig.from_yaml` and the bundled `tasks/mpc.yml`;
- the shared tick tail `_finish_step` (brake fallback included);
- a kernel-route tick (`traj_solve`'s plain version with injected noise)
  against the JAX package's in-kernel loops over the blast objective
  (`tests/_jax_traj_loops.py`) followed by the JAX `_finish_step`;
- a generic-route tick (c-space goal) against the JAX `_step_impl` with the
  JAX package's MPPI signs injected;
- `run_ticks` against sequential `step`s (bit for bit), the brake fallback
  and commands within limits through the public entry point, the route
  choice, and the refusals.

Loop limits as in `tests/test_torch_traj_kernels.py`: median relative cost
difference < 1e-3 and >= 95 % of the robots within 1e-3 rad in the knots (a
strict comparison in a line search can flip on a rounding difference and
part two runs); where the runs agree, the command and plan within 2e-3.
"""

import dataclasses
import filecmp
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
from curobo_tpu.opt.lbfgs import LBFGSConfig as JLBFGSConfig
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.solver.mpc import MPCConfig as JMPCConfig
from curobo_tpu.solver.mpc import MPCSolver as JMPCSolver
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig
from curobo_tpu_torch.opt.mppi import MPPIConfig
from curobo_tpu_torch.solver.mpc import MPCConfig, MPCSolver, MPCState

from _jax_traj_loops import JaxLoopSolver

JAX_CONTENT = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content")
B = 16  # robots of the comparisons
# a cheaper budget than mpc.yml's 64 x 2 / 8 for the CPU loops; the spline is MPC's
MPPI_P, MPPI_IT, LBFGS_IT, HIST = 8, 2, 4, 8


def _scene(mod):
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        mod.SphereObstacle(name="ball", pose=[0.35, 0.2, 0.45, 1, 0, 0, 0], radius=0.08),
    )


def _cfgs(**kw):
    jc = JMPCConfig(mppi=dataclasses.replace(JMPCConfig().mppi, n_particles=MPPI_P, n_iters=MPPI_IT),
                    lbfgs=JLBFGSConfig(history=HIST, n_iters=LBFGS_IT, max_step=0.3), **kw)
    tc = MPCConfig(mppi=dataclasses.replace(MPCConfig().mppi, n_particles=MPPI_P, n_iters=MPPI_IT),
                   lbfgs=LBFGSConfig(history=HIST, n_iters=LBFGS_IT, max_step=0.3), **kw)
    return jc, tc


@pytest.fixture(scope="module")
def ur10e():
    kj = JKin.from_robot_yaml(os.path.join(JAX_CONTENT, "robots", "ur10e.yml"))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    wj = jwm.compile_scene(_scene(jgt))
    wt = ct.compile_scene(_scene(tgt), device="cpu")
    D = kt.n_dof
    rng = np.random.RandomState(3)
    q0 = rng.uniform(-1.0, 1.0, (B, D)).astype(np.float32)
    qd = rng.uniform(-0.3, 0.3, (B, D)).astype(np.float32)
    qg = (q0 + rng.uniform(-0.3, 0.3, (B, D))).astype(np.float32)
    st = kt.compute_kinematics(torch.as_tensor(qg))
    pos, quat = st.tool_pose.position[:, 0].numpy(), st.tool_pose.quaternion[:, 0].numpy()
    return dict(kj=kj, kt=kt, wj=wj, wt=wt, q0=q0, qd=qd, qg=qg, pos=pos, quat=quat, D=D)


def _close_where_agree(xt, xj, ct_, cj):
    rel = np.abs(ct_ - cj) / (np.abs(cj) + 1e-2)
    assert np.median(rel) < 1e-3, np.median(rel)
    agree = np.abs(xt - xj).reshape(xt.shape[0], -1).max(axis=-1) < 1e-3
    assert agree.mean() >= 0.95, agree.mean()
    return agree


def _hold_tick(rt, st_t, rj, st_j, agree):
    for a, b in ((rt.command.position, rj.command.position),
                 (rt.command.velocity, rj.command.velocity),
                 (rt.plan.position, rj.plan.position),
                 (st_t.q_filtered, st_j.q_filtered)):
        np.testing.assert_allclose(a.numpy()[agree], np.asarray(b)[agree], atol=2e-3)
    np.testing.assert_array_equal(rt.feasible.numpy()[agree], np.asarray(rj.feasible)[agree])


def test_config_from_yaml_matches_jax():
    src = os.path.join(JAX_CONTENT, "tasks", "mpc.yml")
    dst = ct.content_path("tasks", "mpc.yml")
    assert filecmp.cmp(src, dst, shallow=False)
    ct_, cj = MPCConfig.from_yaml(dst), JMPCConfig.from_yaml(src)
    assert dataclasses.asdict(ct_) == dataclasses.asdict(cj)
    assert ct_ == MPCConfig()  # the defaults are the task file
    assert MPCConfig.from_yaml({"control_dt": 0.05, "mppi": {"n_particles": 8}}).mppi.n_particles == 8


def test_finish_step_matches_jax_with_the_brake_branch(ur10e):
    u = ur10e
    jc, tc = _cfgs()
    js_ = JMPCSolver(u["kj"].params, jc)
    ts = MPCSolver(u["kt"].params, tc, device="cpu")
    rng = np.random.RandomState(4)
    n_free = tc.bspline.n_free
    knots = (u["q0"][:, None] + rng.normal(0, 0.2, (B, n_free, u["D"]))).astype(np.float32)
    dt = np.full(B, tc.control_dt, np.float32)
    feasible = np.arange(B) % 3 != 0  # every third robot brakes
    cost, pe, re = (rng.uniform(0, 1, B).astype(np.float32) for _ in range(3))
    traj_j = js_.transition.rollout(jnp.asarray(knots), jnp.asarray(u["q0"]), jnp.asarray(dt))
    rj, sj = js_._finish_step(jnp.asarray(knots), traj_j, jnp.asarray(u["q0"]), jnp.asarray(u["qd"]),
                              jnp.asarray(feasible), jnp.asarray(cost), jnp.asarray(pe),
                              jnp.asarray(re), jax.random.PRNGKey(0), jnp.asarray(dt))
    k_t = torch.as_tensor(knots)
    q0_t, dt_t = torch.as_tensor(u["q0"]), torch.as_tensor(dt)
    # the same trajectory on both sides (the spline products round apart by
    # up to 5e-5 in the acceleration; `tests/test_torch_bspline.py` holds them)
    traj_t = ct.JointState(**{f: torch.as_tensor(np.asarray(getattr(traj_j, f))) for f in
                              ("position", "velocity", "acceleration", "jerk", "dt")})
    state = MPCState(free_knots=k_t, q_filtered=q0_t, seed=7, tick=3)
    rt, st = ts._finish_step(k_t, traj_t, q0_t, torch.as_tensor(u["qd"]), torch.as_tensor(feasible),
                             torch.as_tensor(cost), torch.as_tensor(pe), torch.as_tensor(re),
                             state, dt_t)
    for a, b in ((rt.command.position, rj.command.position),
                 (rt.command.velocity, rj.command.velocity),
                 (rt.command.acceleration, rj.command.acceleration),
                 (rt.plan.position, rj.plan.position), (rt.plan.velocity, rj.plan.velocity),
                 (rt.plan.acceleration, rj.plan.acceleration),
                 (st.q_filtered, sj.q_filtered), (st.free_knots, sj.free_knots)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    assert (st.seed, st.tick) == (7, 4)
    # the braked robots: velocity decays from the measured one
    brake = ~feasible
    np.testing.assert_allclose(rt.command.velocity.numpy()[brake],
                               u["qd"][brake] * tc.brake_decay ** 2, rtol=1e-6)


def test_kernel_route_tick_matches_jax_loops(ur10e):
    u = ur10e
    jc, tc = _cfgs()
    ts = MPCSolver(u["kt"].params, tc, device="cpu")
    goal = ts.make_goal(ct.Pose(torch.as_tensor(u["pos"]), torch.as_tensor(u["quat"])))
    assert ts._use_kernel(goal)
    rng = np.random.RandomState(6)
    n_free, D = tc.bspline.n_free, u["D"]
    free0 = (u["q0"][:, None] + rng.normal(0, 0.05, (B, n_free, D))).astype(np.float32)
    noise = rng.normal(size=(MPPI_IT, MPPI_P, B, n_free * D)).astype(np.float32)
    state = MPCState(free_knots=torch.as_tensor(free0), q_filtered=torch.as_tensor(u["q0"]))
    rt, st = ts._step_impl_kernel(u["wt"], goal, state, torch.as_tensor(u["q0"]),
                                  torch.as_tensor(u["qd"]), noise=torch.as_tensor(noise))

    js_ = JMPCSolver(u["kj"].params, jc)
    ref = JaxLoopSolver(u["kj"].params, jc.rollout, jc.bspline, u["wj"], False)
    goal7 = np.concatenate([u["pos"], u["quat"]], axis=-1)
    dt = np.full(B, jc.control_dt, np.float32)
    mp = jc.mppi
    x, c, pe, re, fe, _ = ref.solve(
        goal7, free0.reshape(B, -1), u["q0"], None, dt, jc.lbfgs.n_iters, jc.lbfgs.history, 5,
        jc.lbfgs.max_step, noise=noise, L=np.asarray(js_._smooth_L),
        mppi=(mp.n_iters, mp.n_particles, mp.init_std, mp.std_decay, mp.min_std,
              mp.temperature, mp.step_size))
    knots = jnp.asarray(x.reshape(B, n_free, D))
    q0 = jnp.asarray(u["q0"])
    traj = js_.transition.rollout(knots, q0, jnp.asarray(dt))
    rj, sj = js_._finish_step(knots, traj, q0, jnp.asarray(u["qd"]), jnp.asarray(fe > 0.5),
                              jnp.asarray(c), jnp.asarray(pe), jnp.asarray(re),
                              jax.random.PRNGKey(0), jnp.asarray(dt))
    agree = _close_where_agree(st.free_knots.numpy(), np.asarray(sj.free_knots),
                               rt.cost.numpy(), np.asarray(rj.cost))
    _hold_tick(rt, st, rj, sj, agree)
    assert rt.feasible.any()


def test_generic_route_tick_matches_jax_with_injected_signs(ur10e):
    u = ur10e
    jc, tc = _cfgs()
    ts = MPCSolver(u["kt"].params, tc, device="cpu")
    js_ = JMPCSolver(u["kj"].params, jc)
    goal_t = dataclasses.replace(
        ts.make_goal(ct.Pose(torch.as_tensor(u["pos"]), torch.as_tensor(u["quat"]))),
        goal_cspace=torch.as_tensor(u["qg"]))
    goal_j = dataclasses.replace(
        js_.make_goal(JPose(jnp.asarray(u["pos"]), jnp.asarray(u["quat"]))),
        goal_cspace=jnp.asarray(u["qg"]))
    assert not ts._use_kernel(goal_t)
    q0 = u["q0"]
    sj0 = js_.setup(jnp.asarray(q0), key=jax.random.PRNGKey(2))
    _, sub = jax.random.split(sj0.key)  # the draw inside the JAX tick
    n = tc.bspline.n_free * u["D"]
    signs = np.array(jax.random.rademacher(sub, (B, n), dtype=jnp.float32))
    rj, sj = js_._step_jit(u["wj"], goal_j, sj0, jnp.asarray(q0), jnp.asarray(u["qd"]))
    st0 = ts.setup(torch.as_tensor(q0))
    rt, st = ts._step_impl(u["wt"], goal_t, st0, torch.as_tensor(q0), torch.as_tensor(u["qd"]),
                           signs=torch.as_tensor(signs))
    agree = _close_where_agree(st.free_knots.numpy(), np.asarray(sj.free_knots),
                               rt.cost.numpy(), np.asarray(rj.cost))
    _hold_tick(rt, st, rj, sj, agree)


def _small_solver(kt, **kw):
    cfg = MPCConfig(mppi=MPPIConfig(n_particles=4, n_iters=1, init_std=0.08, temperature=0.02),
                    lbfgs=LBFGSConfig(history=4, n_iters=2, max_step=0.3), **kw)
    return MPCSolver(kt.params, cfg, device="cpu")


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "generic"])
def test_run_ticks_equals_sequential_steps(ur10e, use_pallas):
    u = ur10e
    ts = _small_solver(u["kt"], use_pallas=use_pallas)
    q0 = torch.as_tensor(u["q0"][:2])
    goal = ts.make_goal(ct.Pose(torch.as_tensor(u["pos"][:2]), torch.as_tensor(u["quat"][:2])))
    assert ts._use_kernel(goal) == use_pallas
    T = 3
    worlds = [u["wt"].update_obstacle_pose("ball", [0.35, 0.2 + 0.05 * t, 0.45], [1, 0, 0, 0])
              for t in range(T)]
    js = ct.JointState.from_position(q0)
    res, st_r = ts.run_ticks(ct.stack_worlds(worlds), goal, ts.setup(q0, seed=5), js)
    assert res.command.position.shape == (T, 2, u["D"]) and res.plan.position.shape == (T, 2, 24, u["D"])
    st = ts.setup(q0, seed=5)
    for t in range(T):
        r, st = ts.step(worlds[t], goal, st, js)
        js = ct.JointState(position=r.command.position, velocity=r.command.velocity)
        assert torch.equal(res.command.position[t], r.command.position)
        assert torch.equal(res.cost[t], r.cost) and torch.equal(res.feasible[t], r.feasible)
    assert torch.equal(st_r.free_knots, st.free_knots) and st_r.tick == st.tick == T


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "generic"])
def test_ticks_draw_from_seed_and_tick(ur10e, use_pallas):
    u = ur10e
    # MPPI alone, wide: its result moves with every draw
    ts = MPCSolver(u["kt"].params, MPCConfig(
        mppi=MPPIConfig(n_particles=16, n_iters=2, init_std=0.3), use_gradient_stage=False,
        use_pallas=use_pallas), device="cpu")
    q0 = torch.as_tensor(u["q0"][:2])
    goal = ts.make_goal(ct.Pose(torch.as_tensor(u["pos"][:2]), torch.as_tensor(u["quat"][:2])))
    js = ct.JointState.from_position(q0)
    # the optimised knots (the plan of an infeasible robot is its brake profile)
    a = ts.step(u["wt"], goal, ts.setup(q0, seed=1), js)[1].free_knots
    b = ts.step(u["wt"], goal, ts.setup(q0, seed=1), js)[1].free_knots
    c = ts.step(u["wt"], goal, ts.setup(q0, seed=2), js)[1].free_knots
    d = ts.step(u["wt"], goal, dataclasses.replace(ts.setup(q0, seed=1), tick=1), js)[1].free_knots
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_brake_fallback_and_commands_within_limits(ur10e):
    """A goal inside the table makes every plan infeasible once the world
    encloses the robot: the command is the braked measured velocity. A
    reachable goal gives commands within the joint limits."""
    u = ur10e
    kt = u["kt"]
    ts = _small_solver(kt)
    q0 = kt.params.retract_config[None]
    qd = torch.full((1, u["D"]), 0.5)
    cage = ct.compile_scene(tgt.Scene().add(
        tgt.SphereObstacle(name="cage", pose=[0, 0, 0.5, 1, 0, 0, 0], radius=3.0)), device="cpu")
    goal = ts.make_goal(ct.Pose(torch.tensor([[0.4, 0.0, -0.1]]), torch.tensor([[1.0, 0, 0, 0]])))
    res, _ = ts.step(cage, goal, ts.setup(q0), ct.JointState(position=q0, velocity=qd))
    assert not bool(res.feasible[0])
    torch.testing.assert_close(res.command.velocity, qd * ts.cfg.brake_decay ** 2)
    torch.testing.assert_close(res.command.position, q0 + qd * (ts.cfg.brake_decay
                               + ts.cfg.brake_decay ** 2) * ts.cfg.control_dt)
    assert torch.equal(res.command.acceleration, torch.zeros_like(qd))

    st = kt.compute_kinematics(q0 + 0.4)
    goal = ts.make_goal(ct.Pose(st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0]))
    state, js = ts.setup(q0), ct.JointState.from_position(q0)
    lim = kt.params.joint_limits
    for _ in range(4):
        res, state = ts.step(u["wt"], goal, state, js)
        q = res.command.position
        assert bool(res.feasible.all())
        assert bool(((q >= lim.lower - 1e-3) & (q <= lim.upper + 1e-3)).all())
        assert bool((res.command.velocity.abs() <= lim.velocity * 1.05).all())
        js = ct.JointState(position=q, velocity=res.command.velocity)


def test_refusals_and_device(ur10e):
    kt = ur10e["kt"]
    # a torque limit builds no kernel and takes the generic route
    tq = MPCSolver(kt.params, MPCConfig(rollout=dataclasses.replace(
        MPCConfig().rollout, torque_limit_weight=1.0)), device="cpu")
    assert tq._solve_kernel is None
    # the support-polygon term takes the generic route
    from curobo_tpu_torch.cost.support_polygon import SupportPolygonConfig

    sp = MPCSolver(kt.params, MPCConfig(rollout=dataclasses.replace(
        MPCConfig().rollout, support_polygon=SupportPolygonConfig(weight=1.0),
        support_hull=((0.0, 0.0), (1.0, 0.0), (0.0, 1.0)))), device="cpu")
    pose0 = ct.Pose(torch.zeros(1, 3), torch.tensor([[1.0, 0, 0, 0]]))
    assert sp._solve_kernel is None and not sp._use_kernel(sp.make_goal(pose0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MPCSolver(kt.params)
    # route choice reads the goal's structure only
    ts = MPCSolver(kt.params, device="cpu")
    pose = ct.Pose(torch.zeros(1, 3), torch.tensor([[1.0, 0, 0, 0]]))
    assert ts._use_kernel(ts.make_goal(pose))
    g3 = ct.Pose(torch.zeros(1, 3, 1, 3), torch.tensor([1.0, 0, 0, 0]).expand(1, 3, 1, 4))
    assert not ts._use_kernel(ts.make_goal(g3))
    crit = ct.Goal.from_pose(pose, criteria=[ct.ToolPoseCriteria()])
    assert not ts._use_kernel(crit)
    assert not MPCSolver(kt.params, MPCConfig(use_pallas=False), device="cpu")._use_kernel(
        ts.make_goal(pose))
