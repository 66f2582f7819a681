"""The port's motion retargeter (`curobo_tpu_torch/motion/retargeter.py`)
against the JAX package's on the CPU, on the retargeting G1
(`unitree_g1_29dof_retarget.yml`: 35 dof with its 6-dof virtual base, 14 tool
frames, 400 spheres, 55 414 self-collision pairs).

Held: the YAML copy (byte for byte) and the model facts of
`tests/test_humanoid.py::TestG1Retarget::test_model`; the objective of the
local frames (`_cost`) and its gradient against the JAX `_cost` and
`jax.grad` of it on numpy-made inputs at B = 4; the local frame of
`TestG1Retarget::test_retargets_frame` (a 10 cm shift of every target, q0
given) under the same 2 cm limit and against the JAX solution; the frame
chaining of `solve_sequence`, `reset`, the mode check, one MPC-mode frame
at a CPU-small MPC config, and the default MPC mode raising as the
reference's does. No JAX global IK is run on the humanoid (minutes of
XLA compile on the CPU); the port's global frame runs on the card
(`chip_smoke.py` phase `retarget`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.motion.retargeter import MotionRetargeter as JRetargeter
from curobo_tpu.motion.retargeter import RetargetConfig as JRetargetConfig
from curobo_tpu.opt.lbfgs import LBFGSConfig as JLBFGSConfig
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.robot.kinematics import compute_kinematics as jfk
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu_torch.motion.retargeter import MotionRetargeter, RetargetConfig
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
NAME = "unitree_g1_29dof_retarget.yml"
JAX_PATH = os.path.join(ROOT, "curobo_tpu", "content", "robots", NAME)


@pytest.fixture(scope="module")
def kins():
    return JKin.from_robot_yaml(JAX_PATH), ct.Kinematics.from_robot_yaml(
        ct.robot_config_path(NAME), device="cpu")


def test_yaml_copy_is_byte_identical():
    with open(JAX_PATH, "rb") as f, open(ct.robot_config_path(NAME), "rb") as g:
        assert f.read() == g.read()


def test_model(kins):
    _, kt = kins
    p = kt.params
    assert p.n_dof == 35 and p.n_tools == 14 and p.n_spheres == 400
    assert int(torch.isfinite(p.self_collision.pair_margin).sum()) == 55414
    assert "pelvis" in p.tool_frame_names and "left_ankle_roll_link" in p.tool_frame_names
    q = p.retract_config
    st0 = kt.compute_kinematics(q)
    q1 = q.clone()
    q1[2] += 0.5
    st1 = kt.compute_kinematics(q1)
    pel = p.tool_frame_names.index("pelvis")
    np.testing.assert_allclose((st1.tool_pose.position[pel] - st0.tool_pose.position[pel]).numpy(),
                               [0.0, 0.0, 0.5], atol=1e-6)


def _inputs(kt, rng, B):
    """q near retract with the arms and legs swung (self-collision active),
    the previous frame's q near it, and goals = FK of other near-retract
    configurations."""
    p = kt.params
    r = p.retract_config.numpy()
    body = (np.arange(p.n_dof) >= 6).astype(np.float32)
    q = (r + rng.normal(0, 0.6, (B, p.n_dof)) * body).astype(np.float32)
    q_prev = (q + rng.normal(0, 0.05, q.shape)).astype(np.float32)
    qg = (r + rng.normal(0, 0.3, (B, p.n_dof))).astype(np.float32)
    st = kt.compute_kinematics(torch.as_tensor(qg))
    return q, q_prev, st.tool_pose.position.numpy(), st.tool_pose.quaternion.numpy()


def test_cost_and_gradient_match_jax(kins):
    kj, kt = kins
    rng = np.random.RandomState(0)
    q, q_prev, gp, gq = _inputs(kt, rng, 4)
    rj = JRetargeter(kj.params, JRetargetConfig())
    rt = MotionRetargeter(kt.params, RetargetConfig(), device="cpu")

    def jcost(x):
        return rj._cost(x, jnp.asarray(gp), jnp.asarray(gq), jnp.asarray(q_prev))

    cj = np.asarray(jcost(jnp.asarray(q)))
    gj = np.asarray(jax.grad(lambda x: jnp.sum(jcost(x)))(jnp.asarray(q)))
    x = torch.as_tensor(q).requires_grad_(True)
    c = rt._cost(x, torch.as_tensor(gp), torch.as_tensor(gq), torch.as_tensor(q_prev))
    (g,) = torch.autograd.grad(c.sum(), x)
    # the self-collision term is active in every case
    from curobo_tpu_torch.geom.self_collision import self_collision_cost

    sc = self_collision_cost(kt.params.self_collision, kt.compute_kinematics(x.detach()).spheres)
    assert bool((sc > 0).all())
    # float32 FK over 46 links and sums over 55k pairs, in another order
    np.testing.assert_allclose(c.detach().numpy(), cj, rtol=1e-5)
    r = np.abs(g.numpy() - gj) / (np.abs(gj) + 1.0)
    assert np.median(r) < 1e-4 and np.percentile(r, 99) < 1e-2, (np.median(r), r.max())


def test_local_frame_tracks_a_shift_like_jax(kins):
    """`TestG1Retarget.test_retargets_frame`: every target 10 cm forward of
    retract (a pure base translation), q0 given, 25 L-BFGS iterations: every
    tool within 2 cm, in both packages, and the two solutions' tool positions
    within 2 mm of each other (the two L-BFGS runs are the same algorithm on
    the same objective; their line searches may choose differently once the
    costs tie to float32 rounding)."""
    kj, kt = kins
    tw, lb = ((200.0, 20.0),), dict(history=8, n_iters=25, max_step=0.2)
    q0 = kt.params.retract_config
    st = kt.compute_kinematics(q0)
    pos = st.tool_pose.position.numpy()[None] + np.asarray([0.10, 0.0, 0.0], np.float32)
    quat = st.tool_pose.quaternion.numpy()[None]
    rt = MotionRetargeter(kt.params, RetargetConfig(tool_weights=tw, lbfgs=LBFGSConfig(**lb)),
                          device="cpu")
    res = rt.solve_frame(ct.Pose(torch.as_tensor(pos), torch.as_tensor(quat)), q0[None])
    assert res.success is None and res.cost.shape == (1,)
    ft = kt.compute_kinematics(res.joint_state.position[0]).tool_pose.position.numpy()
    err = np.linalg.norm(ft - pos[0], axis=-1)
    assert float(err.max()) < 0.02, err

    rj = JRetargeter(kj.params, JRetargetConfig(tool_weights=tw, lbfgs=JLBFGSConfig(**lb)))
    resj = rj.solve_frame(JPose(jnp.asarray(pos), jnp.asarray(quat)), jnp.asarray(q0.numpy())[None])
    fj = np.asarray(jfk(kj.params, resj.joint_state.position[0]).tool_pose.position)
    assert float(np.linalg.norm(fj - pos[0], axis=-1).max()) < 0.02
    assert float(np.linalg.norm(ft - fj, axis=-1).max()) < 2e-3
    np.testing.assert_allclose(float(res.cost[0]), float(resj.cost[0]), rtol=0.05, atol=1e-3)


def _cheap(kt, mode="local_ik"):
    return MotionRetargeter(kt.params, RetargetConfig(
        mode=mode, lbfgs=LBFGSConfig(history=4, n_iters=2, max_step=0.3)), device="cpu")


def test_solve_sequence_chains_the_frames_and_reset(kins):
    _, kt = kins
    p = kt.params
    rt = _cheap(kt)
    seen = []
    solve = rt._solve_frame

    def recorded(q_prev, gp, gq):
        q, c = solve(q_prev, gp, gq)
        seen.append((q_prev, q))
        return q, c

    rt._solve_frame = recorded
    st = kt.compute_kinematics(p.retract_config)
    F = 3
    shift = torch.linspace(0.0, 0.04, F)[:, None, None] * torch.tensor([1.0, 0.0, 0.0])
    seq = ct.Pose(st.tool_pose.position[None] + shift, st.tool_pose.quaternion[None].expand(F, -1, -1))
    traj = rt.solve_sequence(seq, p.retract_config)
    assert traj.position.shape == (F, p.n_dof) and traj.joint_names == p.joint_names
    assert torch.equal(seen[0][0], p.retract_config[None])
    for f in range(F):
        assert torch.equal(traj.position[f], seen[f][1][0])
        if f:
            assert torch.equal(seen[f][0], seen[f - 1][1])  # warm start = previous solution
    # reset: the next frame is a global IK frame
    rt.reset()
    called = []
    rt._solve_global = lambda goal, world: called.append(goal.position.shape) or "global"
    assert rt.solve_frame(ct.Pose(seq.position[:1], seq.quaternion[:1])) == "global"
    assert called == [(1, p.n_tools, 3)]


def test_bad_mode_and_missing_device_raise(kins):
    with pytest.raises(ValueError):
        RetargetConfig(mode="teleport")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            MotionRetargeter(kins[1].params)


def test_mpc_mode_frame(kins):
    """One MPC-mode frame (2 control ticks) at a CPU-small MPC config whose
    MPPI bank the reference's Halton sampler takes (one free knot: 35
    dimensions of its 62): the 14-tool robot takes the MPC solver's generic
    route."""
    _, kt = kins
    p = kt.params
    rt = _cheap(kt, mode="mpc")
    rt._mpc = ct.MPCSolver(p, ct.MPCConfig(
        bspline=ct.MPCConfig().bspline.__class__(degree=3, n_control=4, horizon=6),
        mppi=ct.MPCConfig().mppi.__class__(n_particles=4, n_iters=1, init_std=0.05),
        lbfgs=LBFGSConfig(history=2, n_iters=1, max_step=0.3)), device="cpu")
    st = kt.compute_kinematics(p.retract_config)
    goal = ct.Pose(st.tool_pose.position[None] + torch.tensor([0.02, 0.0, 0.0]),
                   st.tool_pose.quaternion[None])
    res = rt.solve_frame(goal, p.retract_config[None])
    assert not rt._mpc._use_kernel(rt._mpc.make_goal(goal))
    assert res.trajectory.position.shape == (1, 2, p.n_dof)
    assert torch.isfinite(res.trajectory.position).all() and torch.isfinite(res.cost).all()
    assert torch.equal(rt._prev_q, res.joint_state.position)
    assert torch.equal(res.trajectory.position[:, -1], res.joint_state.position)


def test_default_mpc_mode_raises_like_jax(kins):
    """With the default `MPCConfig` (7 free knots x 35 dof = 245 MPPI
    dimensions) the reference's MPC mode raises in its Halton sampler, which
    stops at 62 primes; the port raises the same error at the same frame."""
    kj, kt = kins
    q0 = kt.params.retract_config
    st = kt.compute_kinematics(q0)
    pos, quat = st.tool_pose.position[None], st.tool_pose.quaternion[None]
    rt = MotionRetargeter(kt.params, RetargetConfig(mode="mpc"), device="cpu")
    with pytest.raises(ValueError) as et:
        rt.solve_frame(ct.Pose(pos, quat), q0[None])
    rj = JRetargeter(kj.params, JRetargetConfig(mode="mpc"))
    with pytest.raises(ValueError) as ej:
        rj.solve_frame(JPose(jnp.asarray(pos.numpy()), jnp.asarray(quat.numpy())),
                       jnp.asarray(q0.numpy())[None])
    assert str(et.value) == str(ej.value) == "halton dim 245 > 62 supported"
