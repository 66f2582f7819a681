"""The B-spline transition, the trajectory utilities and the motion-generation
content of the PyTorch package against the JAX package on the CPU.

The basis matrices come from the same scipy code in float64 and must be equal
bit for bit. Everything evaluated in float32 (trajectories, seeds, Cox-de Boor
at query times, resampling) is held to atol 1e-6: the same products summed in
another order.
"""

import dataclasses
import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.solver.trajopt import TrajOptConfig as JTrajOptConfig
from curobo_tpu.transition import bspline as jbs
from curobo_tpu.types.state import JointState as JJointState
from curobo_tpu.util import trajectory as jtraj
from curobo_tpu_torch.transition import bspline as tbs
from curobo_tpu_torch.util import trajectory as ttraj

ROOT = os.path.join(os.path.dirname(__file__), "..")
ATOL = 1e-6


@pytest.mark.parametrize("shape", [(5, 16, 32), (3, 6, 8), (4, 10, 20)])
def test_basis_matrices_equal_jax(shape):
    n_ctrl, degree = shape[1], shape[0]
    for mj, mt in zip(jbs._basis_matrices(n_ctrl, degree, shape[2]),
                      tbs._basis_matrices(n_ctrl, degree, shape[2])):
        assert mt.dtype == np.float64
        assert np.array_equal(mj, mt)


def test_basis_refuses_too_few_control_points():
    with pytest.raises(ValueError, match="must exceed degree"):
        tbs._basis_matrices(5, 5, 8)


@pytest.fixture(scope="module")
def spline_inputs():
    rng = np.random.RandomState(0)
    B, S, D = 3, 4, 7
    cfg = tbs.BSplineConfig()
    return dict(
        cfg=cfg, jcfg=jbs.BSplineConfig(), D=D,
        qs=rng.uniform(-1, 1, (B, S, D)).astype(np.float32),
        qe=rng.uniform(-1, 1, (B, S, D)).astype(np.float32),
        dt=rng.uniform(0.02, 0.1, (B, S)).astype(np.float32),
        free=rng.normal(0, 0.5, (B, S, cfg.n_free, D)).astype(np.float32),
        free_pin=rng.normal(0, 0.5, (B, S, cfg.n_free_cspace, D)).astype(np.float32),
        paths=rng.uniform(-1, 1, (B, S, 12, D)).astype(np.float32),
        tq=rng.uniform(-0.1, 1.1, (B, S, 50)).astype(np.float32),
    )


@pytest.mark.parametrize("pin", [False, True])
def test_rollout_matches_jax(spline_inputs, pin):
    u = spline_inputs
    jt, tt = jbs.BSplineTransition(u["jcfg"]), tbs.BSplineTransition(u["cfg"])
    free = u["free_pin"] if pin else u["free"]
    qg = u["qe"] if pin else None
    tj = jt.rollout(jnp.asarray(free), jnp.asarray(u["qs"]), jnp.asarray(u["dt"]),
                    q_goal=None if qg is None else jnp.asarray(qg))
    tr = tt.rollout(torch.as_tensor(free), torch.as_tensor(u["qs"]), torch.as_tensor(u["dt"]),
                    q_goal=None if qg is None else torch.as_tensor(qg))
    # derivatives scale by 1/T^k (T ~ 1 s): compare relative to the magnitude
    for name in ("position", "velocity", "acceleration", "jerk"):
        a, b = np.asarray(getattr(tj, name)), getattr(tr, name).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=ATOL * max(1.0, np.abs(a).max()))
    if pin:  # the pinned far end is the goal, at rest
        np.testing.assert_allclose(tr.position[..., -1, :].numpy(), u["qe"], atol=1e-5)


@pytest.mark.parametrize("pin", [False, True])
def test_seeds_match_jax(spline_inputs, pin):
    u = spline_inputs
    jt, tt = jbs.BSplineTransition(u["jcfg"]), tbs.BSplineTransition(u["cfg"])
    a = jt.linear_seed(jnp.asarray(u["qs"]), jnp.asarray(u["qe"]), q_goal_pinned=pin)
    b = tt.linear_seed(torch.as_tensor(u["qs"]), torch.as_tensor(u["qe"]), q_goal_pinned=pin)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
    a = jt.path_seed(jnp.asarray(u["paths"]), q_goal_pinned=pin)
    b = tt.path_seed(torch.as_tensor(u["paths"]), q_goal_pinned=pin)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


def test_evaluate_at_matches_jax(spline_inputs):
    u = spline_inputs
    jt, tt = jbs.BSplineTransition(u["jcfg"]), tbs.BSplineTransition(u["cfg"])
    ctrl_j = jt.assemble_control(jnp.asarray(u["free"]), jnp.asarray(u["qs"]))
    ctrl_t = tt.assemble_control(torch.as_tensor(u["free"]), torch.as_tensor(u["qs"]))
    np.testing.assert_array_equal(ctrl_t.numpy(), np.asarray(ctrl_j))
    a = jt.evaluate_at(ctrl_j, jnp.asarray(u["dt"]), jnp.asarray(u["tq"]))
    b = tt.evaluate_at(ctrl_t, torch.as_tensor(u["dt"]), torch.as_tensor(u["tq"]))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


def test_assemble_control_broadcasts_leading_axes(spline_inputs):
    u = spline_inputs
    tt = tbs.BSplineTransition(u["cfg"])
    free = torch.zeros((5,) + u["free"].shape)  # extra leading candidate axis
    ctrl = tt.assemble_control(free, torch.as_tensor(u["qs"]), torch.as_tensor(u["qe"]))
    assert ctrl.shape == (5,) + u["free"].shape[:2] + (u["cfg"].n_free + 2 * tbs.N_PIN, u["D"])


@pytest.mark.parametrize("rel", ["problems/franka_motion.json", "tasks/trajopt.yml"])
def test_content_copies_are_byte_identical(rel):
    a = os.path.join(ROOT, "curobo_tpu", "content", rel)
    b = ct.content_path(*rel.split("/"))
    assert filecmp.cmp(a, b, shallow=False)


def test_trajopt_yaml_loads_like_jax():
    path = ct.content_path("tasks", "trajopt.yml")
    cj, cp = JTrajOptConfig.from_yaml(path), ct.TrajOptConfig.from_yaml(path)

    def flat(c):
        return {k: v for k, v in dataclasses.asdict(c).items() if k != "mppi"}

    assert flat(cj) == flat(cp)
    assert dataclasses.asdict(cj.mppi) == dataclasses.asdict(cp.mppi)
    assert cp.lbfgs.n_iters == 80 and cp.finetune_attempts == 2


def _traj(q):
    return (JJointState.from_position(jnp.asarray(q)),
            ct.JointState.from_position(torch.as_tensor(q)))


def test_linear_resample_and_smooth_match_jax():
    rng = np.random.RandomState(1)
    q = rng.uniform(-1, 1, (3, 17, 7)).astype(np.float32)
    tj, tt = _traj(q)
    tj = dataclasses.replace(tj, dt=jnp.full((3,), 0.05))
    tt = dataclasses.replace(tt, dt=torch.full((3,), 0.05))
    rj, rt = jtraj.linear_resample(tj, 40), ttraj.linear_resample(tt, 40)
    # jnp.linspace and torch.linspace round some grid points the other way:
    # a few float32 ulps at |q| <= 1
    np.testing.assert_allclose(rt.position.numpy(), np.asarray(rj.position), atol=4 * ATOL)
    np.testing.assert_allclose(rt.dt.numpy(), np.asarray(rj.dt), rtol=1e-6)
    sj, st = jtraj.linear_smooth(tj, 5, 2), ttraj.linear_smooth(tt, 5, 2)
    np.testing.assert_allclose(st.position.numpy(), np.asarray(sj.position), atol=ATOL)
    np.testing.assert_array_equal(st.position[:, [0, -1]].numpy(), q[:, [0, -1]])


def test_state_filter_and_execution_manager_match_jax():
    rng = np.random.RandomState(2)
    fj, ft = jtraj.JointStateFilter(alpha=0.7), ttraj.JointStateFilter(alpha=0.7)
    for _ in range(3):
        q, v = rng.normal(size=(1, 7)).astype(np.float32), rng.normal(size=(1, 7)).astype(np.float32)
        a = fj(JJointState(position=jnp.asarray(q), velocity=jnp.asarray(v)))
        b = ft(ct.JointState(position=torch.as_tensor(q), velocity=torch.as_tensor(v)))
        np.testing.assert_allclose(b.position.numpy(), np.asarray(a.position), atol=ATOL)
        np.testing.assert_allclose(b.velocity.numpy(), np.asarray(a.velocity), atol=ATOL)
    plan = rng.normal(size=(1, 12, 7)).astype(np.float32)
    mj, mt = jtraj.TrajectoryExecutionManager(0.02, 4), ttraj.TrajectoryExecutionManager(0.02, 4)
    with pytest.raises(RuntimeError, match="no plan"):
        mt.next_command()
    mj.update_plan(JJointState.from_position(jnp.asarray(plan)))
    mt.update_plan(ct.JointState.from_position(torch.as_tensor(plan)))
    for _ in range(7):
        assert mt.steps_remaining == mj.steps_remaining
        (pa, va), (pb, vb) = mj.next_command(), mt.next_command()
        np.testing.assert_array_equal(pb, np.asarray(pa))
        np.testing.assert_array_equal(vb, np.asarray(va))
