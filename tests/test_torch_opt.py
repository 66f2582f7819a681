"""The generic route's optimizers of the PyTorch package against the JAX
package on the CPU: `lbfgs_optimize` and `mppi_optimize` (with the JAX
package's Rademacher signs injected) on a batched Rosenbrock written here and
on the UR10e IK objective (`RobotRollout.evaluate_config`), and the
quasi-random normal bank (`halton_gaussian`).

Limits (those of the port's earlier solver-loop checks): median relative cost
difference < 1e-3 and >= 95 % of the rows within 1e-3 (absolute in x), since
a strict comparison in the line search can flip on a rounding difference and
part the two runs on a few rows; a wrong history slot or step rule would move
most of them.
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
from curobo_tpu.opt.lbfgs import LineSearchConfig as JLineSearchConfig
from curobo_tpu.opt.lbfgs import lbfgs_optimize as jlbfgs
from curobo_tpu.opt.mppi import MPPIConfig as JMPPIConfig
from curobo_tpu.opt.mppi import mppi_optimize as jmppi
from curobo_tpu.opt.mppi import smooth_sample_transform as jsmooth
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.rollout.robot_rollout import Goal as JGoal
from curobo_tpu.rollout.robot_rollout import RobotRollout as JRollout
from curobo_tpu.solver.ik import IKConfig as JIKConfig
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu.util import sampling as jsampling
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig, LineSearchConfig, lbfgs_optimize
from curobo_tpu_torch.opt.mppi import MPPIConfig, mppi_optimize, smooth_sample_transform
from curobo_tpu_torch.rollout.robot_rollout import Goal, RobotRollout
from curobo_tpu_torch.util import sampling as tsampling

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")
MED, FRAC, XTOL = 1e-3, 0.95, 1e-3


def _agree(xt, ct_, xj, cj, med=MED, frac=FRAC):
    xt, ct_, xj, cj = (np.asarray(a, np.float64) for a in (xt, ct_, xj, cj))
    rel = np.abs(ct_ - cj) / (np.abs(cj) + 1e-2)
    dx = np.abs(xt - xj).reshape(xt.shape[0], -1).max(axis=-1) if xt.ndim > 1 else np.abs(xt - xj)
    assert np.median(rel) < med, np.median(rel)
    assert np.mean(dx < XTOL) >= frac, np.mean(dx < XTOL)


def _rosen_t(x):
    return (100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2).sum(dim=-1)


def _rosen_j(x):
    return jnp.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2, axis=-1)


def _x0(n=64, d=6, seed=0):
    return np.random.RandomState(seed).uniform(-1.5, 1.5, (n, d)).astype(np.float32)


def test_halton_gaussian_matches_jax():
    np.testing.assert_array_equal(tsampling.halton_sequence(300, 7), jsampling.halton_sequence(300, 7))
    zt = tsampling.halton_gaussian(300, 7)
    zj = jsampling.halton_gaussian(300, 7)
    np.testing.assert_allclose(zt, zj, atol=1e-6, rtol=0)
    bt = tsampling.gaussian_halton_bank(64, 5).numpy()
    bj = np.asarray(jsampling.gaussian_halton_bank(64, 5))
    np.testing.assert_allclose(bt, bj, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["strong_wolfe", "armijo", "greedy"])
def test_lbfgs_rosenbrock_matches_jax(kind):
    x0 = _x0()
    # Rosenbrock's valley amplifies rounding: over 25 iterations the two runs
    # part on most rows (checked: 1e-7 apart after 8 iterations, 6e-5 after
    # 12, 0.2 after 25), so the comparison stops at 10
    cfg_kw = dict(history=6, n_iters=10, max_step=0.5)
    jc = JLBFGSConfig(line_search=JLineSearchConfig(kind=kind), **cfg_kw)
    tc = LBFGSConfig(line_search=LineSearchConfig(kind=kind), **cfg_kw)
    xj, cj = jax.jit(lambda x: jlbfgs(_rosen_j, x, jc))(jnp.asarray(x0))
    xt, ct_ = lbfgs_optimize(_rosen_t, torch.as_tensor(x0), tc)
    _agree(xt.numpy(), ct_.numpy(), np.asarray(xj), np.asarray(cj))
    # it optimizes: the median cost falls by an order of magnitude
    assert np.median(ct_.numpy()) < 0.1 * np.median(_rosen_t(torch.as_tensor(x0)).numpy())


def test_lbfgs_bounds_project_once_and_reevaluate():
    x0 = _x0(32, 4, seed=1)
    lo, hi = np.full(4, -0.5, np.float32), np.full(4, 0.8, np.float32)
    cfg = dict(history=4, n_iters=10)
    xj, cj = jlbfgs(_rosen_j, jnp.asarray(x0), JLBFGSConfig(**cfg), jnp.asarray(lo), jnp.asarray(hi))
    xt, ct_ = lbfgs_optimize(_rosen_t, torch.as_tensor(x0), LBFGSConfig(**cfg),
                             torch.as_tensor(lo), torch.as_tensor(hi))
    assert (xt.numpy() >= lo).all() and (xt.numpy() <= hi).all()
    np.testing.assert_allclose(ct_.numpy(), _rosen_t(xt).numpy(), rtol=1e-6)
    _agree(xt.numpy(), ct_.numpy(), np.asarray(xj), np.asarray(cj))


def _jax_signs(key, shape):
    return np.array(jax.random.rademacher(key, shape, dtype=jnp.float32))


@pytest.mark.parametrize("smooth", [False, True])
def test_mppi_rosenbrock_matches_jax_with_injected_signs(smooth):
    x0 = _x0(48, 6, seed=2)
    kw = dict(n_particles=32, n_iters=5, init_std=0.3, temperature=0.05)
    key = jax.random.PRNGKey(3)
    signs = _jax_signs(key, x0.shape)  # the draw inside jmppi with this key
    eps_j = eps_t = None
    if smooth:  # the knot-axis smoothing of MPC, over 3 "knots" x 2 "dof"
        Lj, Lt = jsmooth(3, 2), smooth_sample_transform(3, 2)
        eps_j = lambda e: jnp.einsum("kj,...jd->...kd", Lj, e.reshape(e.shape[:-1] + (3, 2))).reshape(e.shape)
        eps_t = lambda e: torch.einsum("kj,...jd->...kd", Lt, e.reshape(e.shape[:-1] + (3, 2))).reshape(e.shape)
    xj, cj = jmppi(_rosen_j, jnp.asarray(x0), key, JMPPIConfig(**kw), eps_transform=eps_j)
    xt, ct_ = mppi_optimize(_rosen_t, torch.as_tensor(x0), None, MPPIConfig(**kw),
                            eps_transform=eps_t, signs=torch.as_tensor(signs))
    _agree(xt.numpy(), ct_.numpy(), np.asarray(xj), np.asarray(cj))
    assert (ct_.numpy() <= _rosen_t(torch.as_tensor(x0)).numpy() + 1e-6).all()


def test_mppi_generator_signs_are_rademacher_and_seeded():
    x0 = torch.zeros((4000, 3))
    seen = []
    cfg = MPPIConfig(n_particles=2, n_iters=1, init_std=1.0, step_size=0.0, elite_keep=False)

    def spy(x):
        seen.append(x)
        return x.sum(dim=-1) * 0.0

    mppi_optimize(spy, x0, torch.Generator().manual_seed(5), cfg)
    bank0 = torch.as_tensor(tsampling.halton_gaussian(2, 3)[0], dtype=torch.float32)
    signs = seen[1][0] / bank0  # particle 0 of iteration 0: bank[0] * signs
    torch.testing.assert_close(signs.abs(), torch.ones_like(signs))
    assert abs(float(signs.mean())) < 0.055  # 12000 fair coins: 6 sigma
    seen.clear()
    mppi_optimize(spy, x0, torch.Generator().manual_seed(5), cfg)
    assert torch.equal(seen[1][0] / bank0, signs)


def _scene(mod):
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        mod.SphereObstacle(name="ball", pose=[0.35, 0.2, 0.45, 1, 0, 0, 0], radius=0.08),
    )


@pytest.fixture(scope="module")
def ur10e_ik():
    """The UR10e IK objective (default IKConfig rollout) of both packages on
    the same 16 goals x 4 seeds."""
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "ur10e.yml"))
    wj = jwm.compile_scene(_scene(jgt))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    wt = ct.compile_scene(_scene(tgt), device="cpu")
    rcfg_j, rcfg_t = JIKConfig().rollout, ct.IKConfig().rollout
    rng = np.random.RandomState(11)
    D = kt.n_dof
    qg = rng.uniform(-1.2, 1.2, (16, D)).astype(np.float32)
    st = kt.compute_kinematics(torch.as_tensor(qg))
    pos = st.tool_pose.position[:, 0].numpy()
    quat = st.tool_pose.quaternion[:, 0].numpy()
    seeds = (qg[:, None] + rng.normal(0, 0.3, (16, 4, D))).astype(np.float32)
    gj = JGoal.from_pose(JPose(jnp.asarray(pos), jnp.asarray(quat))).tile_seeds(4)
    gt_ = Goal.from_pose(ct.Pose(torch.as_tensor(pos), torch.as_tensor(quat))).tile_seeds(4)
    rj, rt = JRollout(kj.params, rcfg_j), RobotRollout(kt.params, rcfg_t)
    lo, hi = kt.params.dof_clip_bounds()
    return dict(
        cost_j=lambda x: rj.evaluate_config(wj, gj, x).cost,
        cost_t=lambda x: rt.evaluate_config(wt, gt_, x).cost,
        seeds=seeds, lo=np.asarray(lo, np.float32), hi=np.asarray(hi, np.float32),
    )


def test_lbfgs_ur10e_ik_matches_jax(ur10e_ik):
    u = ur10e_ik
    cfg = dict(history=4, n_iters=6)
    lo, hi = u["lo"], u["hi"]
    xj, cj = jax.jit(lambda x: jlbfgs(u["cost_j"], x, JLBFGSConfig(**cfg), jnp.asarray(lo),
                                      jnp.asarray(hi)))(jnp.asarray(u["seeds"]))
    xt, ct_ = lbfgs_optimize(u["cost_t"], torch.as_tensor(u["seeds"]), LBFGSConfig(**cfg),
                             torch.as_tensor(lo), torch.as_tensor(hi))
    _agree(xt.numpy().reshape(64, -1), ct_.numpy().reshape(-1),
           np.asarray(xj).reshape(64, -1), np.asarray(cj).reshape(-1))


def test_mppi_ur10e_ik_matches_jax(ur10e_ik):
    u = ur10e_ik
    kw = dict(n_particles=16, n_iters=3, init_std=0.3)
    key = jax.random.PRNGKey(4)
    signs = _jax_signs(key, u["seeds"].shape)
    lo, hi = u["lo"], u["hi"]
    xj, cj = jax.jit(lambda x: jmppi(u["cost_j"], x, key, JMPPIConfig(**kw), jnp.asarray(lo),
                                     jnp.asarray(hi)))(jnp.asarray(u["seeds"]))
    xt, ct_ = mppi_optimize(u["cost_t"], torch.as_tensor(u["seeds"]), None, MPPIConfig(**kw),
                            torch.as_tensor(lo), torch.as_tensor(hi), signs=torch.as_tensor(signs))
    _agree(xt.numpy().reshape(64, -1), ct_.numpy().reshape(-1),
           np.asarray(xj).reshape(64, -1), np.asarray(cj).reshape(-1))
