"""The LM seed stage and the analytic Jacobian of the PyTorch package against
the JAX package on the CPU, and the dual-arm IK solve that uses them.

- `analytic_jacobian` against JAX's on the Franka, the UR10e and the dual-arm
  UR10e, and against autograd of the package's own FK;
- `lm_step` in both forms (primal R >= D, dual R < D) against JAX's;
- `SeedIK` against the JAX `SeedIK._solve` on the same seeds and goals: at 3
  iterations the runs agree seed by seed; by 12 a tie between accepting and
  rejecting a step can part single seeds, so the share of seeds solved is
  held instead;
- a factorisation that fails leaves no NaN;
- `IKSolver.solve_pose` on the dual arm with the LM stage (the kernel route's
  plain version), and the generic route's LM seed pool against the JAX
  `IKSolver._solve_impl`.
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
from curobo_tpu.opt.lbfgs import LBFGSConfig as JLBFGSConfig
from curobo_tpu.opt.lm import LMConfig as JLMConfig
from curobo_tpu.opt.lm import SeedIK as JSeedIK
from curobo_tpu.opt.lm import lm_step as jlm_step
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.robot.kinematics import compute_kinematics as jfk
from curobo_tpu.rollout.robot_rollout import Goal as JGoal
from curobo_tpu.solver.ik import IKConfig as JIKConfig
from curobo_tpu.solver.ik import IKSolver as JIKSolver
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig
from curobo_tpu_torch.opt.lm import LMConfig, SeedIK, lm_step

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")


def _pair(robot):
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, robot + ".yml"))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path(robot), device="cpu")
    return kj, kt


def _goal_arrays(kj, rng, n, span=1.5):
    """Tool poses of random configurations: (position (n, T, 3), quaternion
    (n, T, 4)) as numpy."""
    qg = rng.uniform(-span, span, (n, kj.n_dof)).astype(np.float32)
    st = jfk(kj.params, jnp.asarray(qg))
    return np.asarray(st.tool_pose.position), np.asarray(st.tool_pose.quaternion)


def _table(mod):
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.0, 0.0, -0.1, 1, 0, 0, 0], dims=[4.0, 4.0, 0.2])
    )


# ---------------------------------------------------------------------------
# Jacobian
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("robot", ["franka", "ur10e", "dual_ur10e"])
def test_jacobian_matches_jax(robot):
    kj, kt = _pair(robot)
    q = np.random.RandomState(0).uniform(-2.0, 2.0, (64, kj.n_dof)).astype(np.float32)
    a = np.asarray(jfk(kj.params, jnp.asarray(q), compute_jacobian=True).jacobian)
    b = kt.compute_kinematics(torch.as_tensor(q), compute_jacobian=True).jacobian.numpy()
    assert b.shape == (64, kj.params.n_tools, 6, kj.n_dof)
    np.testing.assert_allclose(b, a, atol=1e-5)
    np.testing.assert_array_equal(kt.params.tool_ancestor_mask(), kj.params.tool_ancestor_mask())
    np.testing.assert_array_equal(kt.params.dof_routing_matrix(), kj.params.dof_routing_matrix())


@pytest.mark.parametrize("robot", ["franka", "dual_ur10e"])
def test_jacobian_matches_autograd_of_fk(robot):
    """Rows 0:3 are d(tool position)/dq; rows 3:6 the world angular velocity,
    vee(dR/dq R^T), of each tool frame."""
    _, kt = _pair(robot)
    p = kt.params
    q_all = torch.as_tensor(np.random.RandomState(1).uniform(-2.0, 2.0, (4, p.n_dof)),
                            dtype=torch.float32)
    J = kt.compute_kinematics(q_all, compute_jacobian=True).jacobian
    ti = list(p.tool_frame_idx)
    for n in range(q_all.shape[0]):
        def fk(q):
            R, pos = ct.robot.kinematics.link_transforms(p, q)
            return pos[ti], R[ti]

        dpos, dR = torch.autograd.functional.jacobian(fk, q_all[n])  # (T, 3, D), (T, 3, 3, D)
        R = fk(q_all[n])[1]
        S = torch.einsum("tijd,tkj->tikd", dR, R)  # dR/dq R^T, skew per dof
        w = torch.stack([S[:, 2, 1], S[:, 0, 2], S[:, 1, 0]], dim=1)  # (T, 3, D)
        torch.testing.assert_close(J[n, :, :3], dpos, atol=1e-5, rtol=0)
        torch.testing.assert_close(J[n, :, 3:], w, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# LM step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R,D", [(12, 12), (12, 6), (6, 7)], ids=["primal-square", "primal", "dual"])
def test_lm_step_matches_jax(R, D):
    rng = np.random.RandomState(R * 100 + D)
    J = rng.normal(size=(128, R, D)).astype(np.float32)
    r = rng.normal(size=(128, R)).astype(np.float32)
    lam = rng.uniform(1e-3, 1.0, size=(128,)).astype(np.float32)
    a = np.asarray(jlm_step(jnp.asarray(J), jnp.asarray(r), jnp.asarray(lam)))
    b, ok = lm_step(torch.as_tensor(J), torch.as_tensor(r), torch.as_tensor(lam))
    assert bool(ok.all())
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-5)


def test_failed_factorisation_is_a_rejected_step_without_nan():
    """A matrix that is not positive definite: the step is 0 and flagged, and
    in `SeedIK` the iteration is rejected (the best-so-far keeps the seed)
    where JAX's Cholesky would hand on NaN."""
    J = torch.zeros(3, 6, 6)
    d, ok = lm_step(J, torch.ones(3, 6), torch.full((3,), -1.0))
    assert not bool(ok.any()) and torch.equal(d, torch.zeros(3, 6))
    kj, kt = _pair("ur10e")
    gp, gq = _goal_arrays(kj, np.random.RandomState(2), 16)
    q0 = torch.as_tensor(np.random.RandomState(3).uniform(-1.5, 1.5, (16, 6)), dtype=torch.float32)
    gp, gq = torch.as_tensor(gp), torch.as_tensor(gq)
    r0 = SeedIK(kt.params)._residual_only(q0, gp, gq)
    one = SeedIK(kt.params, LMConfig(n_iters=1, damping=-10.0))
    q1, c1 = one._solve(q0, gp, gq)
    assert torch.equal(q1, q0) and torch.equal(c1, (r0 * r0).sum(-1))
    q4, c4 = SeedIK(kt.params, LMConfig(n_iters=4, damping=-10.0))._solve(q0, gp, gq)
    assert torch.isfinite(q4).all() and torch.isfinite(c4).all()
    assert bool((c4 <= c1).all()) and float(c4.mean()) < float(c1.mean())


# ---------------------------------------------------------------------------
# SeedIK
# ---------------------------------------------------------------------------
def _seed_ik_both(robot, n_iters, n=256):
    kj, kt = _pair(robot)
    rng = np.random.RandomState(4)
    q0 = rng.uniform(-1.5, 1.5, (n, kj.n_dof)).astype(np.float32)
    gp, gq = _goal_arrays(kj, rng, n)
    qj, cj = JSeedIK(kj.params, JLMConfig(n_iters=n_iters))._solve(
        jnp.asarray(q0), jnp.asarray(gp), jnp.asarray(gq))
    st = SeedIK(kt.params, LMConfig(n_iters=n_iters))
    qt, ctt = st.solve(ct.Pose(torch.as_tensor(gp), torch.as_tensor(gq)), torch.as_tensor(q0))
    return np.asarray(qj), np.asarray(cj), qt.numpy(), ctt.numpy()


@pytest.mark.parametrize("robot", ["ur10e", "dual_ur10e"])
def test_seed_ik_short_matches_jax(robot):
    qj, cj, qt, ctt = _seed_ik_both(robot, 3)
    agree = np.abs(qt - qj).max(axis=-1) < 1e-4
    assert agree.mean() >= 0.95
    np.testing.assert_allclose(ctt[agree], cj[agree], rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("robot", ["ur10e", "dual_ur10e"])
def test_seed_ik_full_solves_the_share_jax_solves(robot):
    qj, cj, qt, ctt = _seed_ik_both(robot, 12)
    assert np.isfinite(ctt).all() and np.isfinite(qt).all()
    solved_j, solved_t = (cj < 1e-6).mean(), (ctt < 1e-6).mean()  # residual under 1 mm
    assert abs(solved_t - solved_j) <= 0.02
    assert solved_t > 0.2  # twelve iterations solve a good share from random seeds


# ---------------------------------------------------------------------------
# The slice: dual-arm IK with the LM seed stage
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dual_ik():
    kj, kt = _pair("dual_ur10e")
    wt = ct.compile_scene(_table(tgt), device="cpu")
    rsc = ct.RobotSceneCollision(kt.params)
    rng = np.random.RandomState(11)
    lo = np.maximum(kt.params.joint_limits.lower.numpy(), -np.pi)
    hi = np.minimum(kt.params.joint_limits.upper.numpy(), np.pi)
    pool, got = [], 0
    while got < 8:  # the reference bench's goal sampling (`bench.py:258-269`)
        cand = rng.uniform(lo, hi, (32, kt.n_dof)).astype(np.float32)
        ok = rsc.validate(wt, torch.as_tensor(cand)).numpy()
        pool.append(cand[ok])
        got += int(ok.sum())
    st = kt.compute_kinematics(torch.as_tensor(np.concatenate(pool)[:8]))
    goals = ct.Pose(st.tool_pose.position, st.tool_pose.quaternion)  # (8, 2)
    return kj, kt, wt, goals


def test_dual_solve_lm_seeds_match_jax_and_take_the_kernel_route(dual_ik, monkeypatch):
    """8 goals x 8 seeds, LM 4, warm-up 8, L-BFGS 4: the LM-refined seeds
    equal the JAX `_lm_warm_start` of the same Halton seeds; the solve takes
    the kernel route (its plain version here), and what converges reaches
    both tools' goals."""
    kj, kt, wt, goals = dual_ik
    kw = dict(n_seeds=8, use_lm_seed=True, lm_seed_iters=4, warmup_iters=8,
              use_particle_stage=False, kernel_linesearch=6)
    js = JIKSolver(kj.params, JIKConfig(lbfgs=JLBFGSConfig(history=10, n_iters=4), **kw))
    ts = ct.IKSolver(kt.params, ct.IKConfig(lbfgs=LBFGSConfig(history=10, n_iters=4), **kw),
                     device="cpu")
    B = goals.position.shape[0]
    seeds_j = js.generate_seeds(B, kj.params.retract_config)
    seeds_t = ts.generate_seeds(B, kt.params.retract_config)
    assert np.array_equal(seeds_t.numpy(), np.asarray(seeds_j))  # Halton, bit for bit
    gj = JGoal.from_pose(JPose(jnp.asarray(goals.position.numpy()),
                               jnp.asarray(goals.quaternion.numpy()))).tile_seeds(8)
    lm_j, cost_j = js._lm_warm_start(gj, seeds_j)
    gt_ = ct.Goal.from_pose(goals).tile_seeds(8)
    lm_t, cost_t = ts._lm_warm_start(gt_, seeds_t)
    agree = np.abs(lm_t.numpy() - np.asarray(lm_j)).max(axis=-1) < 1e-4
    assert agree.mean() >= 0.95
    np.testing.assert_allclose(cost_t.numpy()[agree], np.asarray(cost_j)[agree], rtol=1e-3, atol=1e-7)

    def refuse(*a, **k):
        raise AssertionError("the generic route ran")

    monkeypatch.setattr(ts, "_solve_impl", refuse)
    assert ts._use_kernel(ct.Goal.from_pose(goals))
    res = ts.solve_pose(wt, goals, seed_state=kt.params.retract_config)
    for name in ("solution", "position_error", "rotation_error", "cost", "seed_solutions"):
        assert torch.isfinite(getattr(res, name)).all(), name
    fk = kt.compute_kinematics(res.seed_solutions).tool_pose.position  # (B, S, 2, 3)
    err = (fk - goals.position[:, None]).norm(dim=-1).amax(dim=-1)
    conv = res.seed_success
    assert bool((err[conv] < 0.005 + 1e-5).all())
    # the LM stage brought the seeds closer than the Halton draw left them
    assert float(cost_t.mean()) < 0.5 * float(
        ts._seed_ik._residual_only(seeds_t, gt_.goal_pos[..., 0, :, :],
                                   gt_.goal_quat[..., 0, :, :]).pow(2).sum(-1).mean())


def test_dual_solve_at_the_bench_budget_reaches_both_goals(dual_ik):
    """Two goals at the reference bench's budget (32 seeds, LM 12, warm-up 32,
    L-BFGS 24 x 6): both solved, both tools within 5 mm by FK."""
    _, kt, wt, goals = dual_ik
    cfg = ct.IKConfig(n_seeds=32, use_lm_seed=True, lm_seed_iters=12, warmup_iters=32,
                      use_particle_stage=False, lbfgs=LBFGSConfig(history=10, n_iters=24),
                      kernel_linesearch=6)
    two = ct.Pose(goals.position[:2], goals.quaternion[:2])
    res = ct.IKSolver(kt.params, cfg, device="cpu").solve_pose(
        wt, two, seed_state=kt.params.retract_config)
    assert bool(res.success.all())
    fk = kt.compute_kinematics(res.solution).tool_pose.position
    assert float((fk - two.position).norm(dim=-1).max()) < 0.005
    assert bool(ct.RobotSceneCollision(kt.params).validate(wt, res.solution).all())


def test_generic_route_lm_seed_pool_matches_jax():
    """UR10e, `use_pallas=False`: 24 Halton seeds LM-refined, the best 6 by LM
    residual kept, then L-BFGS; the kept seeds and the success share against
    the JAX `_solve_impl` with the same pool (no particle stage, so no PRNG
    stream is involved)."""
    kj, kt = _pair("ur10e")
    kw = dict(n_seeds=6, use_lm_seed=True, lm_seed_iters=12, lm_seed_pool=24,
              use_particle_stage=False, use_pallas=False)
    js = JIKSolver(kj.params, JIKConfig(lbfgs=JLBFGSConfig(history=6, n_iters=20), **kw))
    ts = ct.IKSolver(kt.params, ct.IKConfig(lbfgs=LBFGSConfig(history=6, n_iters=20), **kw),
                     device="cpu")
    B = 8
    gp, gq = _goal_arrays(kj, np.random.RandomState(6), B, span=1.2)
    gp, gq = gp[:, 0], gq[:, 0]
    wj, wt = jwm.compile_scene(_table(jgt)), ct.compile_scene(_table(tgt), device="cpu")
    rj = jax.jit(js._solve_impl)(wj.anonymized(), JGoal.from_pose(JPose(jnp.asarray(gp), jnp.asarray(gq))),
                                 js.generate_seeds(B, n=24), jax.random.PRNGKey(0))
    goal = ct.Goal.from_pose(ct.Pose(torch.as_tensor(gp), torch.as_tensor(gq)))
    assert not ts._use_kernel(goal)
    seeds = ts.generate_seeds(B, n=24)
    assert seeds.shape == (B, 24, 6)
    rt = ts._solve_impl(wt, goal, seeds, 0)
    assert rt.seed_solutions.shape == (B, 6, 6)
    ss_j, ss_t = np.asarray(rj.seed_success), rt.seed_success.numpy()
    assert abs(ss_j.mean() - ss_t.mean()) <= 0.05
    assert rt.success.numpy().sum() >= B // 4  # the route solves goals (some lie under the table)
    ok = rt.success.numpy()
    fk = kt.compute_kinematics(rt.solution).tool_pose.position[:, 0].numpy()
    assert (np.linalg.norm(fk - gp, axis=-1)[ok] < 0.005 + 1e-5).all()
