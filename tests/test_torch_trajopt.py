"""The trajectory optimization solver of the PyTorch package against the JAX
package on the CPU, on the UR10e with a small spline (3, 10, 8).

The PyTorch `TrajOptSolver.solve_pose(device="cpu")` (seeds, dt estimate, two
finetune rounds through the plain `traj_solve`, best-seed merge, final check
through the plain `traj_cost_grad` metrics) is held to the JAX
`TrajOptSolver._finetune_impl`, whose `solve_fn` is `_solve_seeds_pallas`
given a `solve_kernel=` that runs the JAX package's in-kernel loops over the
blast objective (`tests/_jax_traj_loops.py`). Then the interpolation, the
particle stage through the solver, and the refusals.
"""

import dataclasses
import functools
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
from curobo_tpu.robot.kinematics import compute_kinematics as jfk
from curobo_tpu.rollout.robot_rollout import Goal as JGoal
from curobo_tpu.solver.trajopt import TrajOptConfig as JTrajOptConfig
from curobo_tpu.solver.trajopt import TrajOptResult as JTrajOptResult
from curobo_tpu.solver.trajopt import TrajOptSolver as JTrajOptSolver
from curobo_tpu.transition.bspline import BSplineConfig as JBSplineConfig
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu.types.state import JointState as JJointState
from curobo_tpu_torch.cost import terms as tterms
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig
from curobo_tpu_torch.opt.mppi import MPPIConfig
from curobo_tpu_torch.transition.bspline import BSplineConfig

from _jax_traj_loops import JaxLoopSolver

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")
LBFGS, HIST, LS = 3, 4, 5  # L-BFGS of the test budget; line search of build_solver
B, S = 20, 4


def _scene(mod):
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        mod.SphereObstacle(name="ball", pose=[0.35, 0.2, 0.45, 1, 0, 0, 0], radius=0.08),
    )


def _cfg(mod_cfg, bsp, lbfgs, **kw):
    base = mod_cfg().rollout
    rollout = dataclasses.replace(base, collision_cost=dataclasses.replace(
        base.collision_cost, sweep_steps=2))
    return mod_cfg(bspline=bsp, lbfgs=lbfgs, rollout=rollout, **kw)


@pytest.fixture(scope="module")
def ur10e():
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "ur10e.yml"))
    wj = jwm.compile_scene(_scene(jgt)).anonymized()
    jcfg = _cfg(JTrajOptConfig, JBSplineConfig(degree=3, n_control=10, horizon=8),
                JLBFGSConfig(history=HIST, n_iters=LBFGS, max_step=0.5))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    wt = ct.compile_scene(_scene(tgt), device="cpu")
    tcfg = _cfg(ct.TrajOptConfig, BSplineConfig(degree=3, n_control=10, horizon=8),
                LBFGSConfig(history=HIST, n_iters=LBFGS, max_step=0.5))
    D = kj.n_dof
    rng = np.random.RandomState(7)
    q_start = rng.uniform(-1.0, 1.0, (B, D)).astype(np.float32)
    q_goal = rng.uniform(-1.0, 1.0, (B, D)).astype(np.float32)
    # seed 0 is the exact goal configuration (an IK solution), the others are
    # perturbed ones that miss the pose
    seed_q = (q_goal[:, None] + rng.normal(0, 0.05, (B, S, D)) * (np.arange(S) > 0)[None, :, None])
    seed_q = seed_q.astype(np.float32)
    st = jfk(kj.params, jnp.asarray(q_goal))
    pos, quat = np.array(st.tool_pose.position[:, 0]), np.array(st.tool_pose.quaternion[:, 0])

    ref = JaxLoopSolver(kj.params, jcfg.rollout, jcfg.bspline, wj, True)

    def solve_kernel(goal7, free, qs, dt, seed, world, q_end=None):
        out = ref.solve(goal7, free, qs, q_end, dt, LBFGS, HIST, LS, jcfg.lbfgs.max_step)
        return tuple(jnp.asarray(a) for a in out[:4]) + (
            jnp.asarray(out[4], jnp.float32), jnp.asarray(out[5]))

    js = JTrajOptSolver(kj.params, jcfg)
    fn = functools.partial(js._solve_seeds_pallas, solve_kernel=solve_kernel)
    goal_j = JGoal.from_pose(JPose(jnp.asarray(pos), jnp.asarray(quat)))
    rj = js._finetune_impl(wj, goal_j, jnp.asarray(q_start), jnp.asarray(seed_q), None,
                           jax.random.PRNGKey(0), solve_fn=fn, solve_fn_ft=fn)
    ts = ct.TrajOptSolver(kt.params, tcfg, device="cpu")
    rt = ts.solve_pose(wt, ct.Pose(torch.as_tensor(pos), torch.as_tensor(quat)),
                       torch.as_tensor(q_start), torch.as_tensor(seed_q))
    return dict(kj=kj, js=js, ts=ts, rj=rj, rt=rt, q_start=q_start, seed_q=seed_q, pos=pos,
                quat=quat, wt=wt, kt=kt, tcfg=tcfg)


def test_seeds_dt_estimate_and_retiming_match_jax(ur10e):
    u = ur10e
    qs, sq = u["q_start"], u["seed_q"]
    dt_j = np.asarray(u["js"].estimate_dt(jnp.asarray(qs)[:, None], jnp.asarray(sq)))
    dt_t = u["ts"].estimate_dt(torch.as_tensor(qs)[:, None], torch.as_tensor(sq)).numpy()
    np.testing.assert_allclose(dt_t, dt_j, atol=1e-6)
    bq = np.broadcast_to(qs[:, None], sq.shape)
    fj = np.asarray(u["js"].transition.linear_seed(jnp.asarray(bq), jnp.asarray(sq), q_goal_pinned=True))
    ft = u["ts"].transition.linear_seed(torch.as_tensor(bq.copy()), torch.as_tensor(sq),
                                        q_goal_pinned=True).numpy()
    np.testing.assert_allclose(ft, fj, atol=1e-6)
    # the retimed dt of the solver's trajectories (a max over steps and joints
    # of |v|/v_lim, sqrt|a|/a_lim, cbrt|j|/j_lim): rtol/atol of
    # tests/test_pallas_traj.py:213-227
    rt = u["rt"]
    tr = rt.trajectory
    traj_j = JJointState(position=jnp.asarray(tr.position.numpy()), velocity=jnp.asarray(tr.velocity.numpy()),
                         acceleration=jnp.asarray(tr.acceleration.numpy()), jerk=jnp.asarray(tr.jerk.numpy()))
    a = np.asarray(u["js"]._retime_dt(traj_j, jnp.asarray(rt.dt.numpy())))
    b = u["ts"]._retime_dt(tr, rt.dt).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


def test_solve_pose_matches_jax_solver(ur10e):
    u = ur10e
    rj, rt = u["rj"], u["rt"]
    sj, st = np.asarray(rj.success), rt.success.numpy()
    # success reads a clearance and a pose error against thresholds after two
    # L-BFGS rounds whose line search can part on a rounding difference
    assert (sj == st).mean() >= 0.95
    assert 0 < st.sum() < B  # both outcomes occur
    both = sj & st
    np.testing.assert_allclose(rt.dt.numpy()[both], np.asarray(rj.dt)[both], rtol=1e-3)
    np.testing.assert_allclose(rt.motion_time.numpy()[both], np.asarray(rj.motion_time)[both],
                               rtol=1e-3)
    assert rt.trajectory.position.shape == (B, 8, 6) and rt.free_knots.shape == (B, 4, 6)
    # pinned terminal state: the chosen seed configuration, at rest
    np.testing.assert_allclose(rt.trajectory.position[:, -1].numpy(), rt.q_end.numpy(), atol=1e-5)
    np.testing.assert_allclose(rt.trajectory.position[:, 0].numpy(), u["q_start"], atol=1e-5)
    assert (rt.position_error.numpy()[st] <= 0.005).all()


def test_interpolate_matches_jax(ur10e):
    u = ur10e
    rt = u["rt"]
    j = lambda t: None if t is None else jnp.asarray(t.numpy())
    traj = JJointState(position=j(rt.trajectory.position), dt=j(rt.dt))
    rj = JTrajOptResult(
        trajectory=traj, success=j(rt.success), dt=j(rt.dt), motion_time=j(rt.motion_time),
        position_error=j(rt.position_error), rotation_error=j(rt.rotation_error), cost=j(rt.cost),
        free_knots=j(rt.free_knots), q_end=j(rt.q_end),
    )
    a = u["js"].interpolate(rj, jnp.asarray(u["q_start"]), 0.02, h_out=40)
    b = u["ts"].interpolate(rt, torch.as_tensor(u["q_start"]), 0.02, h_out=40)
    assert b.position.shape == (B, 40, 6)
    np.testing.assert_allclose(b.position.numpy(), np.asarray(a.position), atol=1e-5)
    # finite differences of positions that agree to 1e-5, over 0.02 s
    np.testing.assert_allclose(b.velocity.numpy(), np.asarray(a.velocity), atol=1e-3)
    np.testing.assert_allclose(b.acceleration.numpy(), np.asarray(a.acceleration), atol=1e-1)
    c = u["ts"].interpolate(rt, torch.as_tensor(u["q_start"]), 0.02)  # horizon from the motion
    assert c.position.shape[1] == int(np.ceil(float(rt.motion_time.max()) / 0.02)) + 1


def test_particle_stage_runs_through_the_solver(ur10e):
    u = ur10e
    cfg = dataclasses.replace(u["tcfg"], use_particle_stage=True,
                              mppi=MPPIConfig(n_particles=3, n_iters=1, init_std=0.05),
                              finetune_attempts=0)
    ts = ct.TrajOptSolver(u["kt"].params, cfg, device="cpu")
    goal = ct.Pose(torch.as_tensor(u["pos"][:2]), torch.as_tensor(u["quat"][:2]))
    args = (u["wt"], goal, torch.as_tensor(u["q_start"][:2]), torch.as_tensor(u["seed_q"][:2]))
    a, b, c = ts.solve_pose(*args, seed=1), ts.solve_pose(*args, seed=1), ts.solve_pose(*args, seed=2)
    assert torch.equal(a.free_knots, b.free_knots)
    assert not torch.equal(a.free_knots, c.free_knots)
    assert torch.isfinite(a.cost).all()


def test_what_the_kernel_route_does_not_serve_raises(ur10e):
    """C-space goals, goal sets, per-axis pose weights, worlds with a voxel
    grid and a torque limit take the generic route, as in the JAX package."""
    u = ur10e
    ts, wt = u["ts"], u["wt"]
    qs, sq = torch.as_tensor(u["q_start"][:2]), torch.as_tensor(u["seed_q"][:2])
    goal = ct.Pose(torch.as_tensor(u["pos"][:2]), torch.as_tensor(u["quat"][:2]))
    assert ts._use_kernel(ct.Goal.from_pose(goal))
    gset = ct.Pose(torch.as_tensor(u["pos"][:2])[:, None, None].expand(2, 3, 1, 3).contiguous(),
                   torch.as_tensor(u["quat"][:2])[:, None, None].expand(2, 3, 1, 4).contiguous())
    assert not ts._use_kernel(ct.Goal.from_pose(gset))
    for res in (ts.solve_cspace(wt, sq[:, 0], qs), ts.solve_pose(wt, gset, qs, sq)):
        assert torch.isfinite(res.cost).all() and torch.isfinite(res.trajectory.position).all()
    voxel = ct.compile_scene(tgt.Scene().add(tgt.VoxelGridObstacle(
        name="esdf", pose=[0.4, 0, 0.4, 1, 0, 0, 0], dims=[0.4, 0.4, 0.4], voxel_size=0.1)),
        device="cpu")
    routes, run = [], ts._finetune_impl  # the last argument is use_kernel
    ts._finetune_impl = lambda *a: routes.append(a[-1]) or run(*a)
    try:
        res = ts.solve_pose(voxel, goal, qs, sq)
    finally:
        del ts._finetune_impl
    assert routes == [False] and torch.isfinite(res.trajectory.position).all()
    base = u["tcfg"]
    tq = ct.TrajOptSolver(u["kt"].params, dataclasses.replace(
        base, rollout=dataclasses.replace(base.rollout, torque_limit_weight=1.0)), device="cpu")
    assert tq._solve_kernel is None
    axis = ct.TrajOptSolver(u["kt"].params, dataclasses.replace(base, rollout=dataclasses.replace(
        base.rollout, pose_cost=tterms.PoseCostConfig(position_axis_weight=(1.0, 1.0, 0.0)))),
        device="cpu")
    assert axis._solve_kernel is None and not axis._use_kernel(ct.Goal.from_pose(goal))
    with pytest.raises(ValueError, match="seed_q"):
        ts.solve_pose(wt, goal, qs, sq[..., :5])


@pytest.fixture(scope="module")
def cspace(ur10e):
    """solve_cspace of both packages: the JAX one takes its generic route
    (`_finetune_xla`: `_solve_seeds` over the blast objective)."""
    u = ur10e
    q_goal = u["seed_q"][:, 0]
    rj = u["js"].solve_cspace(jwm.compile_scene(_scene(jgt)), jnp.asarray(q_goal),
                              jnp.asarray(u["q_start"]))
    rt = u["ts"].solve_cspace(u["wt"], torch.as_tensor(q_goal), torch.as_tensor(u["q_start"]))
    return dict(rj=rj, rt=rt, q_goal=q_goal)


def test_solve_cspace_matches_jax_generic_route(ur10e, cspace):
    u, rj, rt = ur10e, cspace["rj"], cspace["rt"]
    sj, st = np.asarray(rj.success), rt.success.numpy()
    assert (sj == st).mean() >= 0.95
    assert 0 < st.sum()
    both = sj & st
    np.testing.assert_allclose(rt.motion_time.numpy()[both], np.asarray(rj.motion_time)[both],
                               rtol=1e-3)
    # the spline ends pinned at the goal configuration, and starts at q_start
    np.testing.assert_allclose(rt.trajectory.position[:, -1].numpy(), cspace["q_goal"], atol=1e-5)
    np.testing.assert_allclose(rt.trajectory.position[:, 0].numpy(), u["q_start"], atol=1e-5)


def test_plan_cspace_matches_jax(ur10e, cspace):
    """`MotionPlanner.plan_cspace` = `solve_cspace` + interpolation, held to
    the JAX solve and the JAX interpolation of it."""
    u, rj = ur10e, cspace["rj"]
    planner = ct.MotionPlanner(u["kt"].params, ct.MotionPlanConfig(trajopt=u["tcfg"]), device="cpu")
    names = u["kt"].joint_names
    res = planner.plan_cspace(u["wt"], ct.JointState.from_position(torch.as_tensor(cspace["q_goal"]), names),
                              ct.JointState.from_position(torch.as_tensor(u["q_start"]), names))
    sj, st = np.asarray(rj.success), res.success.numpy()
    assert (sj == st).mean() >= 0.95 and bool(res.ik_success.all())
    interp_j = u["js"].interpolate(rj, jnp.asarray(u["q_start"]), 0.02)
    both = sj & st
    n = min(res.trajectory.position.shape[1], interp_j.position.shape[1])
    np.testing.assert_allclose(res.trajectory.position.numpy()[both, :n],
                               np.asarray(interp_j.position)[both, :n], atol=2e-3)
    assert torch.isfinite(res.trajectory.position).all() and res.plan_time > 0.0


def test_solver_without_device_raises_where_there_is_no_card(ur10e):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.TrajOptSolver(ur10e["kt"].params)
