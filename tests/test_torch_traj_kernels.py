"""The trajectory kernels' plain PyTorch versions against the JAX package on
the CPU.

`traj_cost_grad_plain` is held on the Franka with the full spline (5, 16, 32)
to the JAX blast reference (`BlastRollout.evaluate_trajectory` through
`BSplineTransition.rollout`, run eagerly: a compile of it costs 15 s, of its
gradient 51 s on the CPU), with the limits the JAX package holds its own Pallas
trajectory kernel to (`tests/test_pallas_traj.py`); its retimed dt to JAX
`TrajOptSolver._retime_dt`. Cost, metrics and retiming are held for pin_goal
and the speed metric on and off; the gradient against `jax.grad` for the case
with every term (pinned end and speed metric).

`traj_solve_plain` is held on the UR10e with a small spline (3, 6, 8) to the
JAX package's own in-kernel loops over the blast objective
(`tests/_jax_traj_loops.py`), with the same numpy noise injected into both and
the knot smoothing on and off. The CUDA kernels themselves are held against
these plain versions on the card by `chip_smoke.py`.
"""

import dataclasses
import json
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
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.robot.kinematics import compute_kinematics as jfk
from curobo_tpu.rollout.robot_rollout import Goal as JGoal
from curobo_tpu.solver.trajopt import TrajOptConfig as JTrajOptConfig
from curobo_tpu.solver.trajopt import TrajOptSolver as JTrajOptSolver
from curobo_tpu.transition.bspline import BSplineConfig as JBSplineConfig
from curobo_tpu.transition.bspline import BSplineTransition as JBSplineTransition
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.ops import ik_kernels as ikk
from curobo_tpu_torch.ops import traj_kernels as tk
from curobo_tpu_torch.opt.mppi import smooth_sample_transform
from curobo_tpu_torch.transition.bspline import BSplineConfig

from _jax_traj_loops import JaxLoopSolver

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_ROBOTS = os.path.join(ROOT, "curobo_tpu", "content", "robots")
CASES = [(True, False), (False, False), (True, True), (False, True)]
CASE_IDS = ["pin", "free-end", "pin+speed", "free-end+speed"]


def _rollout(mod_cfg, speed, sweep=None):
    base = mod_cfg().rollout
    cc = dataclasses.replace(base.collision_cost, speed_metric=speed)
    if sweep is not None:
        cc = dataclasses.replace(cc, sweep_steps=sweep)
    return dataclasses.replace(base, collision_cost=cc)


@pytest.fixture(scope="module")
def franka():
    """16 Franka trajectories in problem 0's world (16-cuboid capacity) around
    the suite's start and goal configurations, for every (pin_goal,
    speed_metric) case: the blast reference (cost, pose errors, feasibility,
    retimed dt) run eagerly, and the plain version's inputs."""
    from curobo_tpu.ops.blast import BlastRollout

    with open(ct.content_path("problems", "franka_motion.json")) as fh:
        suite = json.load(fh)
    probs = suite["problems"]
    spec = probs[0]["world"]["cuboids"]
    cap = {"cuboid": suite["cuboid_capacity"]}
    wj = jwm.compile_scene(jgt.Scene().add(*[jgt.Cuboid(**o) for o in spec]), capacities=cap)
    wt = ct.compile_scene(tgt.Scene().add(*[tgt.Cuboid(**o) for o in spec]), capacities=cap,
                          device="cpu")
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "franka.yml"))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    NP = 16
    rng = np.random.RandomState(3)
    qs = np.asarray([p["q_start"] for p in probs[:NP]], np.float32)
    qe = np.asarray([p["q_goal_oracle"] for p in probs[:NP]], np.float32)
    qs = (qs + rng.normal(0, 0.05, qs.shape)).astype(np.float32)
    qe = (qe + rng.normal(0, 0.05, qe.shape)).astype(np.float32)
    dt = rng.uniform(0.02, 0.1, NP).astype(np.float32)
    tr = JBSplineTransition(JBSplineConfig())
    st = jfk(kj.params, jnp.asarray(qe))
    pos, quat = st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0]
    goal7 = np.concatenate([np.asarray(pos), np.asarray(quat)], axis=-1)
    goal = JGoal.from_pose(JPose(pos, quat))
    solver = JTrajOptSolver.__new__(JTrajOptSolver)
    solver.params, solver.cfg = kj.params, JTrajOptConfig()
    wtabs = ikk.pack_world_arrays(wt)
    cases = {}
    for (pin, speed), cid in zip(CASES, CASE_IDS):
        free = np.asarray(tr.linear_seed(jnp.asarray(qs), jnp.asarray(qe), q_goal_pinned=pin))
        free = (free + rng.normal(0, 0.05, free.shape)).astype(np.float32)
        blast = BlastRollout(kj.params, _rollout(JTrajOptConfig, speed))

        def jcost(x, free=free, pin=pin, blast=blast):
            traj = tr.rollout(x.reshape(free.shape), jnp.asarray(qs), jnp.asarray(dt),
                              q_goal=jnp.asarray(qe) if pin else None)
            return blast.evaluate_trajectory(wj, goal, traj), traj

        with jax.disable_jit():
            res, traj = jcost(jnp.asarray(free.reshape(NP, -1)))
            ref = dict(cost=np.asarray(res.cost), pos_err=np.asarray(res.pos_err),
                       rot_err=np.asarray(res.rot_err), feasible=np.asarray(res.feasible),
                       dt=np.asarray(solver._retime_dt(traj, jnp.asarray(dt))))
        tt = tk.build_traj_tables(kt.params, _rollout(ct.TrajOptConfig, speed), BSplineConfig(),
                                  pin, "cpu")
        args = (torch.as_tensor(goal7), torch.as_tensor(free.reshape(NP, -1)),
                torch.as_tensor(qs), torch.as_tensor(qe) if pin else None, torch.as_tensor(dt))
        cases[cid] = dict(ref=ref, tt=tt, args=args, jcost=jcost, free=free.reshape(NP, -1))
    return dict(cases=cases, wtabs=wtabs)


@pytest.mark.parametrize("case", CASE_IDS)
def test_cost_matches_blast(franka, case):
    f = franka["cases"][case]
    c, _ = tk.traj_cost_grad(f["tt"], franka["wtabs"], *f["args"], "cost")
    cb = f["ref"]["cost"]
    # sums over 32 steps x (694 pairs + 61 spheres x 4 sweep samples) run in
    # another order than in XLA: the limits of tests/test_pallas_traj.py
    rel = np.abs(c.numpy() - cb) / (np.abs(cb) + 1e-2)
    assert np.median(rel) < 1e-4
    assert np.max(rel) < 1e-3


def test_grad_matches_jax_grad_of_blast(franka):
    f = franka["cases"]["pin+speed"]
    _, g = tk.traj_cost_grad(f["tt"], franka["wtabs"], *f["args"], "grad")
    with jax.disable_jit():
        gb = np.asarray(jax.grad(lambda x: jnp.sum(f["jcost"](x)[0].cost))(jnp.asarray(f["free"])))
    # the blast reference's argmin and hinge kinks are taken at other rounding
    # points: median and 99th percentile of the relative error
    rel_g = np.abs(g.numpy() - gb) / (np.abs(gb) + 1.0)
    assert np.median(rel_g) < 1e-4
    assert np.percentile(rel_g, 99) < 1e-2


@pytest.mark.parametrize("case", CASE_IDS)
def test_cost_modes_agree(franka, case):
    f = franka["cases"][case]
    wt = franka["wtabs"]
    c_grad, _ = tk.traj_cost_grad(f["tt"], wt, *f["args"], "grad")
    c_cost, none = tk.traj_cost_grad(f["tt"], wt, *f["args"], "cost")
    c_met = tk.traj_cost_grad(f["tt"], wt, *f["args"], "metrics")[0]
    assert none is None
    np.testing.assert_allclose(c_cost.numpy(), c_grad.numpy(), rtol=1e-6)
    np.testing.assert_allclose(c_met.numpy(), c_grad.numpy(), rtol=1e-6)


@pytest.mark.parametrize("case", CASE_IDS)
def test_metrics_and_retiming_match_jax(franka, case):
    f = franka["cases"][case]
    ref = f["ref"]
    _, pe, re, fe, dt_ret = tk.traj_cost_grad(f["tt"], franka["wtabs"], *f["args"], "metrics")
    np.testing.assert_allclose(pe.numpy(), ref["pos_err"], atol=1e-5)
    np.testing.assert_allclose(re.numpy(), ref["rot_err"], atol=1e-5)
    assert np.array_equal(fe.numpy() > 0.5, ref["feasible"])
    cfg = ct.TrajOptConfig()
    dt_k = np.clip(dt_ret.numpy(), cfg.min_dt, cfg.max_dt)
    # the retiming ratio is a max over steps and joints of |v|/v_lim etc.;
    # rtol/atol of tests/test_pallas_traj.py:213-227
    np.testing.assert_allclose(dt_k, ref["dt"], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The solver loops: UR10e, small spline, the JAX package's loops over blast
# ---------------------------------------------------------------------------
LBFGS, HIST, LS, MPPI_IT, MPPI_P = 3, 4, 2, 2, 4
MPPI = (MPPI_IT, MPPI_P, 0.1, 0.9, 0.005, 0.05, 0.9)  # TrajSolveBudget defaults


def _ur_scene(mod):
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        mod.SphereObstacle(name="ball", pose=[0.35, 0.2, 0.45, 1, 0, 0, 0], radius=0.08),
    )


@pytest.fixture(scope="module")
def ur10e():
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "ur10e.yml"))
    wj = jwm.compile_scene(_ur_scene(jgt))
    bsp = JBSplineConfig(degree=3, n_control=6, horizon=8)
    D, NP = kj.n_dof, 64
    rng = np.random.RandomState(5)
    qs = rng.uniform(-1.2, 1.2, (NP, D)).astype(np.float32)
    qe = rng.uniform(-1.2, 1.2, (NP, D)).astype(np.float32)
    st = jfk(kj.params, jnp.asarray(qe))
    pos, quat = st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0]
    goal7 = np.concatenate([np.asarray(pos), np.asarray(quat)], axis=-1)
    free = np.asarray(JBSplineTransition(bsp).linear_seed(jnp.asarray(qs), jnp.asarray(qe)))
    nfD = free.shape[1] * D
    free = (free.reshape(NP, -1) + rng.normal(0, 0.05, (NP, nfD))).astype(np.float32)
    dt = rng.uniform(0.03, 0.1, NP).astype(np.float32)
    noise = rng.normal(size=(MPPI_IT, MPPI_P, NP, nfD)).astype(np.float32)
    ref = JaxLoopSolver(kj.params, _rollout(JTrajOptConfig, False, sweep=2), bsp, wj, False)

    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    wt = ct.compile_scene(_ur_scene(tgt), device="cpu")
    tt = tk.build_traj_tables(kt.params, _rollout(ct.TrajOptConfig, False, sweep=2),
                              BSplineConfig(degree=3, n_control=6, horizon=8))
    args = (torch.as_tensor(goal7), torch.as_tensor(free), torch.as_tensor(qs), None,
            torch.as_tensor(dt))
    return dict(ref=ref, jargs=(goal7, free, qs, None, dt), free=free, noise=noise, tt=tt, wtabs=ikk.pack_world_arrays(wt),
                args=args, NP=NP, nfD=nfD, n_free=free.shape[1] // D)


def _hold_loop_to_jax(out_t, out_j):
    xj, cj = out_j[0], out_j[1]
    xt, ct_ = out_t[0].numpy(), out_t[1].numpy()
    # the loops are held loosely: a strict `<` in the line search (or between
    # two particles' costs) can flip on a rounding difference and the two runs
    # then part; a wrong history slot, step rule or noise order would move most
    # trajectories, not 5 % (the limits of tests/test_torch_solver_ik.py)
    rel = np.abs(ct_ - cj) / (np.abs(cj) + 1e-2)
    assert np.median(rel) < 1e-3
    agree = np.abs(xt - xj).max(axis=-1) < 1e-3
    assert agree.mean() >= 0.95
    for k in (2, 3):  # pos_err, rot_err where the runs agree
        np.testing.assert_allclose(out_t[k].numpy()[agree], out_j[k][agree], atol=2e-3)
    assert np.mean((out_t[4].numpy() > 0.5)[agree] == out_j[4][agree]) >= 0.99
    cfg = ct.TrajOptConfig()
    np.testing.assert_allclose(np.clip(out_t[5].numpy(), cfg.min_dt, cfg.max_dt)[agree],
                               out_j[5][agree], rtol=1e-3, atol=1e-5)


def test_lbfgs_solve_matches_jax_loop(ur10e):
    u = ur10e
    out_j = u["ref"].solve(*u["jargs"], LBFGS, HIST, LS, 0.4)
    b = tk.TrajSolveBudget(mppi_iters=0, lbfgs_iters=LBFGS, history=HIST, n_linesearch=LS)
    out_t = tk.traj_solve(u["tt"], u["wtabs"], *u["args"], b)
    _hold_loop_to_jax(out_t, out_j)
    # the stages did work: three iterations took most of the cost away
    c0 = tk.traj_cost_grad(u["tt"], u["wtabs"], *u["args"], "cost")[0]
    assert float(out_t[1].mean()) < 0.5 * float(c0.mean())


@pytest.mark.parametrize("smooth", [False, True], ids=["white", "eps_smooth"])
def test_mppi_solve_matches_jax_loop_with_the_same_noise(ur10e, smooth):
    u = ur10e
    L = smooth_sample_transform(u["n_free"], 6) if smooth else None
    out_j = u["ref"].solve(*u["jargs"], LBFGS, HIST, LS, 0.4, noise=u["noise"],
                           L=None if L is None else L.numpy(), mppi=MPPI)
    b = tk.TrajSolveBudget(mppi_iters=MPPI_IT, n_particles=MPPI_P, lbfgs_iters=LBFGS,
                           history=HIST, n_linesearch=LS)
    out_t = tk.traj_solve(u["tt"], u["wtabs"], *u["args"], b, noise=torch.as_tensor(u["noise"]),
                          eps_smooth=L)
    _hold_loop_to_jax(out_t, out_j)


def test_mppi_stage_is_keyed_by_seed(ur10e):
    u = ur10e
    sl = slice(0, 8)
    args = tuple(None if a is None else a[sl] for a in u["args"])
    b = tk.TrajSolveBudget(mppi_iters=1, n_particles=3, lbfgs_iters=0, history=1)
    x1 = tk.traj_solve(u["tt"], u["wtabs"], *args, b, seed=5)[0]
    x2 = tk.traj_solve(u["tt"], u["wtabs"], *args, b, seed=5)[0]
    x3 = tk.traj_solve(u["tt"], u["wtabs"], *args, b, seed=6)[0]
    assert torch.equal(x1, x2) and not torch.equal(x1, x3)
    z = tk.traj_philox_normal(5, 8, 1, 3, u["nfD"], "cpu")
    x4 = tk.traj_solve(u["tt"], u["wtabs"], *args, b, noise=z)[0]
    assert torch.equal(x1, x4)  # the generator's draws are the debug entry's


def test_knot_clip_follows_the_dof_pattern(ur10e):
    tt = ur10e["tt"]
    y = tk._clip_knots_plain(tt, torch.full((2, tt.nfD), 100.0))
    for r in range(tt.nfD):
        assert float(y[0, r]) == float(tt.dof_t[r % tt.D, 5])


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------
def test_refusals(ur10e):
    u = ur10e
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    cfg = ct.TrajOptConfig().rollout
    with pytest.raises(ValueError, match="horizon 129"):
        tk.build_traj_tables(kt.params, cfg, BSplineConfig(degree=3, n_control=8, horizon=129))
    pin_tt = tk.build_traj_tables(kt.params, cfg, BSplineConfig(degree=3, n_control=10, horizon=8),
                                  pin_goal=True)
    g, _, q, _, d = u["args"]
    with pytest.raises(ValueError, match="requires q_end"):
        tk.traj_cost_grad(pin_tt, u["wtabs"], g, torch.zeros(g.shape[0], pin_tt.nfD), q, None, d)
    cost = tk.TrajCost(kt.params, cfg, BSplineConfig(degree=3, n_control=6, horizon=8))
    voxel = dataclasses.replace(ct.compile_scene(_ur_scene(tgt), device="cpu"), voxel_grids=(object(),))
    with pytest.raises(NotImplementedError, match="voxel"):
        cost(g, u["args"][1], q, d, voxel)
    dual = ct.Kinematics.from_robot_yaml(os.path.join(JAX_ROBOTS, "dual_ur10e.yml"), device="cpu")
    with pytest.raises(NotImplementedError, match="tool frames"):
        tk.build_traj_tables(dual.params, cfg, BSplineConfig())
    with pytest.raises(NotImplementedError, match="torque"):
        tk.build_traj_tables(kt.params, dataclasses.replace(cfg, torque_limit_weight=1.0), BSplineConfig())
    with pytest.raises(ValueError, match="x must have shape"):
        tk.traj_cost_grad(u["tt"], u["wtabs"], g, u["args"][1][:, :5], q, None, d)
    with pytest.raises(ValueError, match="noise must be"):
        tk.traj_solve(u["tt"], u["wtabs"], *u["args"], tk.TrajSolveBudget(mppi_iters=1, n_particles=2),
                      noise=torch.zeros(1, 2, 3, 4))
    with pytest.raises(ValueError, match="history"):
        tk.traj_solve(u["tt"], u["wtabs"], *u["args"], tk.TrajSolveBudget(history=0))
