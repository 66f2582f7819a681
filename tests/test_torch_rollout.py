"""The generic objective of the PyTorch package (`RobotRollout.evaluate_config`
and `evaluate_trajectory` over the term functions of `cost/terms.py`) against
the JAX package's two generic objectives, `RobotRollout` and the B-last
`BlastRollout`, on the CPU: goal sets (G = 3), c-space goals with the null-space
term and a bound margin, per-tool criteria, per-axis and metric pose costs,
the run weight and the swept scene term; then the autograd gradient against
`jax.grad`, and `evaluate_trajectory` against the trajectory kernel's plain
version on a configuration the kernel takes.

Cost on the Franka (jitted JAX objectives: the eager ones cost tens of
seconds), gradients on the UR10e. Limits of `tests/test_pallas_ik.py:70-76`:
relative error median < 1e-4 and 99th percentile < 1e-2 (cost over |ref| +
1e-2, gradient over |ref| + 1); feasibility flags equal. The pair distance is
sqrt(max(d2, 1e-12)) here and in the JAX `RobotRollout`, sqrt(d2 + 1e-12) in
blast: at most 1e-6 m apart, at coincident centres only.
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
from curobo_tpu.ops.blast import BlastRollout as JBlast
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.rollout.robot_rollout import Goal as JGoal
from curobo_tpu.rollout.robot_rollout import RobotRollout as JRollout
from curobo_tpu.rollout.robot_rollout import RobotRolloutConfig as JRolloutConfig
from curobo_tpu.transition.bspline import BSplineConfig as JBSplineConfig
from curobo_tpu.transition.bspline import BSplineTransition as JBSpline
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu.types.state import JointState as JJointState
from curobo_tpu.types.tool_pose import ToolPoseCriteria as JCriteria
from curobo_tpu_torch.cost import terms as tterms
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.geom import world as twm
from curobo_tpu_torch.ops import ik_kernels as ikk
from curobo_tpu_torch.ops import traj_kernels as tk
from curobo_tpu_torch.rollout.robot_rollout import Goal, RobotRollout, RobotRolloutConfig
from curobo_tpu_torch.transition.bspline import BSplineConfig, BSplineTransition
from curobo_tpu_torch.types.tool_pose import ToolPoseCriteria, criteria_for_tools

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")
MED, P99 = 1e-4, 1e-2
N, G, H = 64, 3, 8


def _scene(mod):
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        mod.SphereObstacle(name="ball", pose=[0.35, 0.2, 0.45, 1, 0, 0, 0], radius=0.08),
        mod.Capsule(name="bar", pose=[0.5, -0.3, 0.4, 0.9239, 0.3827, 0, 0], radius=0.05,
                    base=[0, 0, -0.2], tip=[0, 0, 0.2]),
        mod.Cylinder(name="post", pose=[-0.3, 0.4, 0.3, 1, 0, 0, 0], radius=0.08, height=0.6),
    )


def _rel(a, b, floor):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / (np.abs(b) + floor)


def _assert_close(a, b, floor=1e-2, what="cost"):
    r = _rel(a, b, floor)
    assert np.median(r) < MED and np.percentile(r, 99) < P99, (what, np.median(r), np.percentile(r, 99))


# rollout configurations: (name, rollout kwargs, goal kind, criteria)
CASES = {
    "default": (dict(), "pose", False),
    "goal_set": (dict(), "goal_set", False),
    "cspace_null": (dict(null_space_weight=1.0), "cspace", False),
    # blast ignores the bound margin (`ops/blast.py:632-637` uses the raw
    # limits), so this case is held to the JAX RobotRollout only
    "bound_margin": (dict(bound_cost=dict(margin=0.05)), "pose", False),
    "criteria": (dict(), "pose", True),
    "axis_metric_pose": (dict(pose_cost=dict(position_axis_weight=(1.0, 0.5, 2.0),
                                             rotation_axis_weight=(0.3, 1.0, 1.0),
                                             quadratic=False)), "pose", False),
    "mpc_run_weight_swept": (dict(pose_run_weight=0.5, velocity_weight=0.1, acceleration_weight=0.01,
                                  jerk_weight=0.001, collision_cost=dict(weight=1000.0, sweep_steps=3),
                                  bound_cost=dict(velocity_weight=20.0, acceleration_weight=0.5,
                                                  jerk_weight=0.01)), "pose", False),
    "discrete": (dict(use_swept_collision=False), "pose", False),
    "speed_metric": (dict(collision_cost=dict(speed_metric=True)), "pose", False),
}
CONFIG_CASES = ["default", "goal_set", "cspace_null", "bound_margin", "criteria",
                "axis_metric_pose"]


def _seed(case, k):
    return 1000 * k + list(CASES).index(case)


def _rollout_cfg(mod, kw):
    base = mod.RobotRolloutConfig()
    fields = {}
    for k, v in kw.items():
        if isinstance(v, dict):
            fields[k] = dataclasses.replace(getattr(base, k), **v)
        else:
            fields[k] = v
    return dataclasses.replace(base, **fields)


class _Mods:
    def __init__(self, **kw):
        self.__dict__.update(kw)


JM = _Mods(RobotRolloutConfig=JRolloutConfig)
TM = _Mods(RobotRolloutConfig=RobotRolloutConfig)


def _goals(kin_t, rng, B, kind, crit, lead=()):
    """Both packages' goals for B problems (numpy-seeded)."""
    D = kin_t.n_dof
    lo = kin_t.params.joint_limits.lower.numpy()
    hi = kin_t.params.joint_limits.upper.numpy()
    n_g = G if kind == "goal_set" else 1
    qg = rng.uniform(0.8 * lo, 0.8 * hi, (B, n_g, D)).astype(np.float32)
    st = kin_t.compute_kinematics(torch.as_tensor(qg))
    pos = st.tool_pose.position[:, :, :1].numpy()  # (B, g, 1, 3)
    quat = st.tool_pose.quaternion[:, :, :1].numpy()
    crit_t = crit_j = None
    if crit:
        crit_t = [ToolPoseCriteria((1.0, 0.0, 2.0, 0.5, 1.0, 0.0), (0.003, 0.02))]
        crit_j = [JCriteria((1.0, 0.0, 2.0, 0.5, 1.0, 0.0), (0.003, 0.02))]
    gt_ = Goal.from_pose(ct.Pose(torch.as_tensor(pos), torch.as_tensor(quat)), criteria=crit_t)
    gj = JGoal.from_pose(JPose(jnp.asarray(pos), jnp.asarray(quat)), criteria=crit_j)
    if kind == "cspace":
        gt_ = dataclasses.replace(gt_, goal_cspace=torch.as_tensor(qg[:, 0]))
        gj = dataclasses.replace(gj, goal_cspace=jnp.asarray(qg[:, 0]))
    return gt_, gj


def _refs(case):
    """The JAX objectives a case is held to: blast serves G = 1 without
    per-tool criteria (`BlastRollout.supports`) and reads no bound margin."""
    _, kind, crit = CASES[case]
    return ["generic"] + ([] if kind == "goal_set" or crit or case == "bound_margin" else ["blast"])


@pytest.fixture(scope="module")
def franka():
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "franka.yml"))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    return dict(kj=kj, kt=kt, wj=jwm.compile_scene(_scene(jgt)),
                wt=ct.compile_scene(_scene(tgt), device="cpu"))


@pytest.fixture(scope="module")
def ur10e():
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "ur10e.yml"))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    return dict(kj=kj, kt=kt, wj=jwm.compile_scene(_scene(jgt)),
                wt=ct.compile_scene(_scene(tgt), device="cpu"))


def _configs(kt, rng, n):
    lo = kt.params.joint_limits.lower.numpy()
    hi = kt.params.joint_limits.upper.numpy()
    # 5 % of the values slightly outside the limits: the bound terms and the
    # out-of-bounds flag see both sides
    return rng.uniform(lo - 0.05, hi + 0.05, (n, kt.n_dof)).astype(np.float32)


def _ref_rollouts(kj, cfg_j):
    return {"generic": JRollout(kj.params, cfg_j), "blast": JBlast(kj.params, cfg_j)}


@pytest.mark.parametrize("case", CONFIG_CASES)
def test_evaluate_config_matches_jax(franka, case):
    kw, kind, crit = CASES[case]
    kt, kj = franka["kt"], franka["kj"]
    rng = np.random.RandomState(_seed(case, 0))
    q = _configs(kt, rng, N)
    gt_, gj = _goals(kt, rng, N, kind, crit)
    cfg_t, cfg_j = _rollout_cfg(TM, kw), _rollout_cfg(JM, kw)
    rt = RobotRollout(kt.params, cfg_t).evaluate_config(franka["wt"], gt_, torch.as_tensor(q))
    refs = _ref_rollouts(kj, cfg_j)
    for name in _refs(case):
        rj = jax.jit(lambda qq: refs[name].evaluate_config(franka["wj"], gj, qq))(jnp.asarray(q))
        _assert_close(rt.cost.numpy(), rj.cost, what=f"{name} cost")
        _assert_close(rt.pos_err.numpy(), rj.pos_err, 1e-3, f"{name} pos_err")
        _assert_close(rt.rot_err.numpy(), rj.rot_err, 1e-3, f"{name} rot_err")
        np.testing.assert_array_equal(rt.feasible.numpy(), np.asarray(rj.feasible))
        if name == "generic":
            for f in ("in_collision", "self_colliding", "out_of_bounds"):
                np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)))
        if kind == "cspace":
            _assert_close(rt.cspace_err.numpy(), rj.cspace_err, 1e-3, f"{name} cspace_err")
    # the inputs reach every branch of feasibility
    assert 0 < int(rt.feasible.sum()) < N


def _trajectories(kt, rng, B, bsp):
    """JointState trajectories (B, H, D) from random free knots, in numpy."""
    D = kt.n_dof
    tr = BSplineTransition(bsp)
    q_start = torch.as_tensor(_configs(kt, rng, B) * 0.8)
    knots = q_start[:, None] + torch.as_tensor(rng.normal(0, 0.4, (B, bsp.n_free, D)).astype(np.float32))
    dt = torch.as_tensor(rng.uniform(0.02, 0.1, B).astype(np.float32))
    return tr.rollout(knots, q_start, dt)


def _jtraj(traj):
    return JJointState(**{f: jnp.asarray(getattr(traj, f).numpy()) for f in
                          ("position", "velocity", "acceleration", "jerk", "dt")})


@pytest.mark.parametrize("case", ["default", "goal_set", "cspace_null", "bound_margin",
                                  "criteria", "mpc_run_weight_swept", "discrete", "speed_metric"])
def test_evaluate_trajectory_matches_jax(franka, case):
    kw, kind, crit = CASES[case]
    kt, kj = franka["kt"], franka["kj"]
    rng = np.random.RandomState(_seed(case, 1))
    B = 16
    traj = _trajectories(kt, rng, B, BSplineConfig(degree=3, n_control=8, horizon=H))
    gt_, gj = _goals(kt, rng, B, kind, crit)
    cfg_t, cfg_j = _rollout_cfg(TM, kw), _rollout_cfg(JM, kw)
    rt = RobotRollout(kt.params, cfg_t).evaluate_trajectory(franka["wt"], gt_, traj)
    refs = _ref_rollouts(kj, cfg_j)
    jt = _jtraj(traj)
    # blast's trajectory objective compiles for about 5 s a case: two cases
    names = _refs(case) if case in ("default", "mpc_run_weight_swept") else ["generic"]
    for name in names:
        rj = jax.jit(lambda t: refs[name].evaluate_trajectory(franka["wj"], gj, t))(jt)
        _assert_close(rt.cost.numpy(), rj.cost, what=f"{name} cost")
        _assert_close(rt.pos_err.numpy(), rj.pos_err, 1e-3, f"{name} pos_err")
        np.testing.assert_array_equal(rt.feasible.numpy(), np.asarray(rj.feasible))


@pytest.mark.parametrize("case", CONFIG_CASES)
def test_config_gradient_matches_jax_grad(ur10e, case):
    kw, kind, crit = CASES[case]
    kt, kj = ur10e["kt"], ur10e["kj"]
    rng = np.random.RandomState(_seed(case, 2))
    q = _configs(kt, rng, N)
    gt_, gj = _goals(kt, rng, N, kind, crit)
    rt_ = RobotRollout(kt.params, _rollout_cfg(TM, kw))
    rj_ = JRollout(kj.params, _rollout_cfg(JM, kw))
    qt = torch.as_tensor(q).requires_grad_(True)
    (g_t,) = torch.autograd.grad(rt_.evaluate_config(ur10e["wt"], gt_, qt).cost.sum(), qt)
    g_j = jax.jit(jax.grad(lambda qq: jnp.sum(rj_.evaluate_config(ur10e["wj"], gj, qq).cost)))(
        jnp.asarray(q))
    _assert_close(g_t.numpy(), g_j, 1.0, "gradient")


@pytest.mark.parametrize("case", ["mpc_run_weight_swept", "cspace_null"])
def test_trajectory_gradient_matches_jax_grad(ur10e, case):
    """Gradient with respect to the free knots through the B-spline rollout."""
    kw, kind, crit = CASES[case]
    kt, kj = ur10e["kt"], ur10e["kj"]
    rng = np.random.RandomState(_seed(case, 3))
    B, D = 16, kt.n_dof
    bsp_t, bsp_j = BSplineConfig(degree=3, n_control=8, horizon=H), JBSplineConfig(3, 8, H)
    q_start = _configs(kt, rng, B) * 0.8
    knots = (q_start[:, None] + rng.normal(0, 0.4, (B, bsp_t.n_free, D))).astype(np.float32)
    dt = rng.uniform(0.02, 0.1, B).astype(np.float32)
    gt_, gj = _goals(kt, rng, B, kind, crit)
    rt_ = RobotRollout(kt.params, _rollout_cfg(TM, kw))
    rj_ = JRollout(kj.params, _rollout_cfg(JM, kw))
    tr_t, tr_j = BSplineTransition(bsp_t), JBSpline(bsp_j)
    kt_ = torch.as_tensor(knots).requires_grad_(True)
    c = rt_.evaluate_trajectory(ur10e["wt"], gt_, tr_t.rollout(kt_, torch.as_tensor(q_start),
                                                                torch.as_tensor(dt))).cost
    (g_t,) = torch.autograd.grad(c.sum(), kt_)

    def cost_j(k):
        return jnp.sum(rj_.evaluate_trajectory(
            ur10e["wj"], gj, tr_j.rollout(k, jnp.asarray(q_start), jnp.asarray(dt))).cost)

    g_j = jax.jit(jax.grad(cost_j))(jnp.asarray(knots))
    _assert_close(g_t.numpy(), g_j, 1.0, "knot gradient")


def test_evaluate_trajectory_matches_trajectory_kernel_plain(ur10e):
    """The port's two trajectory objectives on a configuration both take (the
    trajectory optimizer's rollout, swept with the speed metric off): the
    generic `evaluate_trajectory` and the kernel's plain version."""
    kt = ur10e["kt"]
    rng = np.random.RandomState(5)
    B, D = 32, kt.n_dof
    bsp = BSplineConfig(degree=5, n_control=12, horizon=16)
    cfg = dataclasses.replace(ct.TrajOptConfig().rollout, pose_run_weight=0.3)
    q_start = torch.as_tensor(_configs(kt, rng, B) * 0.8)
    x = q_start[:, None] + torch.as_tensor(rng.normal(0, 0.4, (B, bsp.n_free, D)).astype(np.float32))
    dt = torch.as_tensor(rng.uniform(0.02, 0.1, B).astype(np.float32))
    gt_, _ = _goals(kt, rng, B, "pose", False)
    tt = tk.build_traj_tables(kt.params, cfg, bsp, pin_goal=False, device="cpu")
    wtabs = ikk.pack_world_arrays(ur10e["wt"])
    goal7 = torch.cat([gt_.goal_pos[:, 0, 0], gt_.goal_quat[:, 0, 0]], dim=-1)
    c_k, pe_k, re_k, fe_k, _ = tk.traj_cost_grad_plain(tt, wtabs, goal7, x.reshape(B, -1), q_start,
                                                       None, dt, "metrics")
    res = RobotRollout(kt.params, cfg).evaluate_trajectory(
        ur10e["wt"], gt_, BSplineTransition(bsp).rollout(x, q_start, dt))
    _assert_close(res.cost.numpy(), c_k.numpy())
    _assert_close(res.pos_err.numpy(), pe_k.numpy(), 1e-3, "pos_err")
    np.testing.assert_array_equal(res.feasible.numpy(), fe_k.numpy() > 0.5)


def test_terms_and_world_helpers_match_jax(franka):
    """Stand-alone pieces: `stack_worlds` / `world_at`, `collision_cost`,
    `criteria_for_tools`, `bound_violation`."""
    wt, wj = franka["wt"], franka["wj"]
    rng = np.random.RandomState(9)
    sph = np.concatenate([rng.uniform(-0.5, 0.8, (50, 3)), rng.uniform(-0.02, 0.1, (50, 1))], -1)
    sph = sph.astype(np.float32)
    np.testing.assert_allclose(twm.collision_cost(wt, torch.as_tensor(sph), 0.03).numpy(),
                               np.asarray(jwm.collision_cost(wj, jnp.asarray(sph), 0.03)),
                               atol=1e-6)
    moved = wt.update_obstacle_pose("ball", [0.1, 0.1, 0.1], [1, 0, 0, 0])
    stacked = ct.stack_worlds([wt, moved, wt])
    assert stacked.spheres.center.shape == (3,) + tuple(wt.spheres.center.shape)
    assert stacked.cuboids.names == wt.cuboids.names
    np.testing.assert_array_equal(twm.world_at(stacked, 1).spheres.center.numpy(),
                                  moved.spheres.center.numpy())
    other = ct.compile_scene(_scene(tgt), capacities={"cuboid": 3}, device="cpu")
    with pytest.raises(ValueError, match="capacities"):
        ct.stack_worlds([wt, other])
    tw, tol = criteria_for_tools(("a", "b"), {"b": ToolPoseCriteria.disabled()})
    assert tw.shape == (2, 6) and float(tw[1].sum()) == 0.0 and np.isinf(tol[1].numpy()).all()
    lim = franka["kt"].params.joint_limits
    q = torch.stack([lim.lower - 1e-3, (lim.lower + lim.upper) / 2])
    assert tterms.bound_violation(q, lim, eps=1e-4).tolist() == [True, False]


def test_unported_terms_raise(franka):
    kt = franka["kt"]
    traj = _trajectories(kt, np.random.RandomState(0), 2, BSplineConfig(3, 8, H))
    gt_, _ = _goals(kt, np.random.RandomState(0), 2, "pose", False)
    # the torque term is ported: it adds a finite, non-negative penalty
    base = RobotRollout(kt.params, RobotRolloutConfig()).evaluate_trajectory(franka["wt"], gt_, traj)
    r = RobotRollout(kt.params, RobotRolloutConfig(torque_limit_weight=1.0))
    res = r.evaluate_trajectory(franka["wt"], gt_, traj)
    assert torch.isfinite(res.cost).all() and bool((res.cost >= base.cost).all())

    # the support-polygon term is ported: it needs a hull baked into the config
    from curobo_tpu_torch.cost.support_polygon import SupportPolygonConfig

    r = RobotRollout(kt.params, RobotRolloutConfig(support_polygon=SupportPolygonConfig(weight=1.0)))
    with pytest.raises(ValueError, match="hull"):
        r.evaluate_config(franka["wt"], gt_, traj.position[:, 0])
