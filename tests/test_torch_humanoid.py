"""The Unitree G1 whole-body slice of the PyTorch package against the JAX
package on the CPU: FK, collision spheres and the centre of mass; the chunked
self-collision sum (162 111 pairs) and its recomputing backward; the
support-polygon term; the generic objective with `ik_g1.yml`'s rollout and a
baked hull; the task configs; the route (`robot_takes_kernel`); and a
CPU-sized solve of the benchmark protocol.

Inputs are made from numpy seeds and handed to both packages. No JAX G1 solve
is traced and no gradient of the JAX G1 rollout is taken (minutes of XLA
compile on the CPU): the JAX objective is evaluated forward only, and the
self-collision gradient is held to `jax.grad` of the JAX chunked pair scan
alone, a small graph. Limits: FK and centre of mass 1e-5 (float32 chains of
60 links); the self-collision sum over 162k pair terms, whose order differs,
relative 1e-5 of the value; gradients with the repo's relative-error limits,
median < 1e-4 and 99th percentile < 1e-2.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.cost import support_polygon as jsp
from curobo_tpu.geom import self_collision as jsc
from curobo_tpu.geom import world as jwm
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.robot.kinematics import compute_com as jcom
from curobo_tpu.robot.kinematics import compute_kinematics as jfk
from curobo_tpu.robot.params import SelfCollisionParams as JSC
from curobo_tpu.rollout.robot_rollout import Goal as JGoal
from curobo_tpu.rollout.robot_rollout import RobotRollout as JRollout
from curobo_tpu.solver.ik import IKConfig as JIKConfig
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu_torch.cost import support_polygon as tsp
from curobo_tpu_torch.geom import self_collision as tsc
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.ops import ik_kernels as ikk
from curobo_tpu_torch.ops import self_collision_kernels as sck
from curobo_tpu_torch.robot.kinematics import compute_com as tcom
from curobo_tpu_torch.robot.params import SelfCollisionParams as TSC
from curobo_tpu_torch.rollout.robot_rollout import Goal, RobotRollout

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_CONTENT = os.path.join(ROOT, "curobo_tpu", "content")
MED, P99 = 1e-4, 1e-2


@pytest.fixture(scope="module")
def g1():
    kj = JKin.from_robot_yaml(os.path.join(JAX_CONTENT, "robots", "unitree_g1.yml"))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("unitree_g1"), device="cpu")
    return dict(kj=kj, kt=kt, pj=kj.params, pt=kt.params)


def _near_retract(p, rng, n, scale):
    r = np.asarray(p.retract_config, np.float32)
    return (r + rng.uniform(-scale, scale, (n, p.n_dof))).astype(np.float32)


def _full_range(p, rng, n):
    return rng.uniform(np.asarray(p.joint_limits.lower), np.asarray(p.joint_limits.upper),
                       (n, p.n_dof)).astype(np.float32)


def _rel(a, b, floor):
    r = np.abs(np.asarray(a, np.float64) - b) / (np.abs(b) + floor)
    return float(np.median(r)), float(np.percentile(r, 99))


def _sc_params_t(sc_j, n):
    """The port's SelfCollisionParams from the JAX one, cut to the first n
    pairs."""
    f = lambda a: torch.as_tensor(np.asarray(a)[:n])
    return TSC(pair_a=f(sc_j.pair_a), pair_b=f(sc_j.pair_b), pair_margin=f(sc_j.pair_margin),
               pair_buffer=f(sc_j.pair_buffer))


def _sc_params_j(sc_j, n):
    return JSC(pair_a=sc_j.pair_a[:n], pair_b=sc_j.pair_b[:n],
               pair_margin=sc_j.pair_margin[:n], pair_buffer=sc_j.pair_buffer[:n])


# ---------------------------------------------------------------------------
# FK, spheres, centre of mass
# ---------------------------------------------------------------------------
def test_fk_spheres_and_com_match_jax(g1):
    pj, pt = g1["pj"], g1["pt"]
    assert (pt.n_dof, pt.n_tools, pt.n_spheres, pt.self_collision.pair_a.shape[0]) == (
        49, 4, 674, 162111)
    q = _full_range(pj, np.random.RandomState(0), 8)
    sj = jfk(pj, jnp.asarray(q))
    st = g1["kt"].compute_kinematics(torch.as_tensor(q))
    for a, b in ((sj.tool_pose.position, st.tool_pose.position), (sj.spheres, st.spheres),
                 (jcom(pj, sj.link_rot, sj.link_pos), tcom(pt, st.link_rot, st.link_pos))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)
    # quaternions up to sign
    qa, qb = np.asarray(sj.tool_pose.quaternion), st.tool_pose.quaternion.numpy()
    assert np.abs(np.abs((qa * qb).sum(-1)) - 1.0).max() < 1e-5


# ---------------------------------------------------------------------------
# chunked self-collision
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def g1_spheres(g1):
    """Spheres (4, 674, 4) of full-range configurations: most self-collide."""
    q = _full_range(g1["pj"], np.random.RandomState(1), 4)
    return np.array(jfk(g1["pj"], jnp.asarray(q)).spheres)


@pytest.mark.parametrize("activation", [0.0, 0.02])
def test_self_collision_cost_and_distance_match_jax(g1, g1_spheres, activation):
    scj, sct = g1["pj"].self_collision, g1["pt"].self_collision
    cj = np.asarray(jsc.self_collision_cost(scj, jnp.asarray(g1_spheres), activation))
    dj = np.asarray(jsc.self_collision_distance(scj, jnp.asarray(g1_spheres)))
    sph = torch.as_tensor(g1_spheres)
    ct_ = tsc.self_collision_cost(sct, sph, activation).numpy()
    dt = tsc.self_collision_distance(sct, sph).numpy()
    assert (dj > 0).sum() >= 2 and (cj > 0).sum() >= 2  # self-colliding cases
    np.testing.assert_allclose(ct_, cj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=1e-7)


def _grad_both(sc_j, sc_t, spheres, activation):
    gj = np.asarray(jax.grad(
        lambda s: jnp.sum(jsc.self_collision_cost(sc_j, s, activation) * jnp.arange(1.0, 1.0 + s.shape[0]))
    )(jnp.asarray(spheres)))
    s = torch.as_tensor(spheres).requires_grad_(True)
    c = tsc.self_collision_cost(sc_t, s, activation)
    (gt,) = torch.autograd.grad((c * torch.arange(1.0, 1.0 + s.shape[0])).sum(), s)
    return gj, gt.numpy(), np.asarray(jsc.self_collision_cost(sc_j, jnp.asarray(spheres), activation)), c.detach().numpy()


def test_self_collision_gradient_matches_jax(g1, g1_spheres):
    gj, gt, _, _ = _grad_both(g1["pj"].self_collision, g1["pt"].self_collision, g1_spheres, 0.02)
    assert np.abs(gj).max() > 1.0
    med, p99 = _rel(gt, gj, 1.0)
    assert med < MED and p99 < P99, (med, p99)
    assert np.all(gt[..., 3] == 0.0)  # radii carry no gradient


@pytest.mark.parametrize("n_configs", [4, 400])
def test_pair_count_not_a_multiple_of_the_chunk(g1, n_configs):
    """5000 pairs: one JAX chunk of 4096 and one padded with dead pairs; the
    port's chunk is 4096 at 4 configurations and 873 at 400 (the CPU keeps a
    block near 1M floats), each with a shorter last chunk."""
    n = 5000
    scj = _sc_params_j(g1["pj"].self_collision, n)
    sct = _sc_params_t(g1["pj"].self_collision, n)
    rng = np.random.RandomState(2)
    base = _full_range(g1["pj"], rng, 4)
    q = base[rng.randint(0, 4, n_configs)] + rng.normal(0, 0.05, (n_configs, base.shape[1])).astype(np.float32)
    spheres = np.array(jfk(g1["pj"], jnp.asarray(q)).spheres)
    pt = tsc._sphere_major(torch.as_tensor(spheres))
    assert n % sck._chunk_size(pt) != 0
    gj, gt, cj, ct_ = _grad_both(scj, sct, spheres, 0.02)
    assert (cj > 0).sum() >= 2
    np.testing.assert_allclose(ct_, cj, rtol=1e-5, atol=1e-6)
    med, p99 = _rel(gt, gj, 1.0)
    assert med < MED and p99 < P99, (med, p99)
    np.testing.assert_allclose(tsc.self_collision_distance(sct, torch.as_tensor(spheres)).numpy(),
                               np.asarray(jsc.self_collision_distance(scj, jnp.asarray(spheres))),
                               rtol=1e-6, atol=1e-7)


def _unchunked_cost(sc, spheres, activation):
    """The pair sum as one gather of every pair (the formula before chunking)."""
    pos = spheres[..., :3]
    ca, cb = pos[..., sc.pair_a.long(), :], pos[..., sc.pair_b.long(), :]
    dist = torch.sqrt(torch.sum((ca - cb) ** 2, dim=-1).clamp_min(1e-12))
    return (sc.pair_margin + activation - dist).clamp_min(0.0), dist


def test_franka_equals_the_unchunked_formula():
    """818 pairs, one chunk: equal to the unchunked formula to the float32
    order of the pair sum; the distance (a max) equal to the rounding of the
    squared distance's three terms."""
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    sc = kt.params.self_collision
    rng = np.random.RandomState(3)
    lo, hi = kt.params.dof_clip_bounds(np.pi)
    q = torch.as_tensor(rng.uniform(lo, hi, (2, 16, kt.n_dof)).astype(np.float32))
    spheres = kt.compute_kinematics(q).spheres.detach()
    for act in (0.0, 0.1):
        s = spheres.clone().requires_grad_(True)
        c = tsc.self_collision_cost(sc, s, act)
        (g,) = torch.autograd.grad(c.sum(), s)
        s2 = spheres.clone().requires_grad_(True)
        hinge, dist = _unchunked_cost(sc, s2, act)
        (g2,) = torch.autograd.grad(hinge.sum(), s2)
        assert c.shape == (2, 16)
        np.testing.assert_allclose(c.detach().numpy(), hinge.sum(-1).detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), g2.numpy(), rtol=1e-5, atol=1e-5)
    assert float(c.detach().max()) > 0.0
    d_ref = (sc.pair_margin - dist).clamp_min(0.0).amax(-1).detach()
    np.testing.assert_allclose(tsc.self_collision_distance(sc, spheres).numpy(), d_ref.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_backward_saves_no_per_chunk_tensor(g1, g1_spheres):
    """The autograd graph of the pair sum holds the sphere positions and the
    pair tables only: nothing with a pair axis and a batch axis."""
    sct = g1["pt"].self_collision
    P = sct.pair_a.shape[0]
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    s = torch.as_tensor(g1_spheres).requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        c = tsc.self_collision_cost(sct, s, 0.02)
    B, S = g1_spheres.shape[:2]
    assert saved, "the pair sum saved nothing for its backward"
    for shape in saved:
        n = int(np.prod(shape))
        assert n <= max(S * 3 * B, P), shape
        assert shape in ((S, 3, B), (P,)), shape
    c.sum().backward()
    assert torch.isfinite(s.grad).all()


# ---------------------------------------------------------------------------
# support polygon
# ---------------------------------------------------------------------------
def test_convex_hull_matches_jax():
    rng = np.random.RandomState(4)
    for pts, pad in ((rng.normal(size=(40, 2)), 0.0), (rng.uniform(-1, 1, (12, 2)), 0.05),
                     (np.asarray([[0, 0], [1, 0], [2, 0], [2, 0], [2, 1], [0, 1]], float), 0.1)):
        np.testing.assert_array_equal(tsp.convex_hull_2d(pts, pad), jsp.convex_hull_2d(pts, pad))


@pytest.mark.parametrize("inside_weight", [0.0, 0.001])
def test_signed_distance_and_cost_match_jax(inside_weight):
    rng = np.random.RandomState(5)
    hull = jsp.convex_hull_2d(rng.normal(size=(20, 2)), 0.03)
    hull_pad = np.concatenate([hull, hull[-1:], hull[-1:]])  # repeated vertices
    pts = rng.normal(0, 1.2, (64, 2)).astype(np.float32)
    cfg_j = jsp.SupportPolygonConfig(weight=50.0, inside_cost_weight=inside_weight, margin_target=0.05)
    cfg_t = tsp.SupportPolygonConfig(weight=50.0, inside_cost_weight=inside_weight, margin_target=0.05)
    for h in (hull, hull_pad):
        sd_j = np.asarray(jsp.signed_distance_to_hull(jnp.asarray(pts), jnp.asarray(h)))
        sd_t = tsp.signed_distance_to_hull(torch.as_tensor(pts), torch.as_tensor(h)).numpy()
        np.testing.assert_allclose(sd_t, sd_j, atol=1e-6)
        assert (sd_j < 0).sum() > 4 and (sd_j > 0).sum() > 4
        cj = jax.grad(lambda x: jnp.sum(jsp.support_polygon_cost(x, jnp.asarray(h), cfg_j)))(jnp.asarray(pts))
        x = torch.as_tensor(pts).requires_grad_(True)
        c = tsp.support_polygon_cost(x, torch.as_tensor(h), cfg_t)
        (gt,) = torch.autograd.grad(c.sum(), x)
        np.testing.assert_allclose(
            c.detach().numpy(),
            np.asarray(jsp.support_polygon_cost(jnp.asarray(pts), jnp.asarray(h), cfg_j)), atol=1e-5)
        np.testing.assert_allclose(gt.numpy(), np.asarray(cj), atol=1e-4)


def test_stance_hull_and_configure_rollout_match_jax(g1):
    pj, pt = g1["pj"], g1["pt"]
    cfg_j = JIKConfig.from_yaml(os.path.join(JAX_CONTENT, "tasks", "ik_g1.yml")).rollout
    cfg_t = ct.IKConfig.from_yaml(ct.content_path("tasks", "ik_g1.yml")).rollout
    names = cfg_t.support_polygon.foot_link_names
    assert tsp.foot_indices_from_links(pt, names) == jsp.foot_indices_from_links(pj, names)
    retract = np.asarray(pj.retract_config)
    hj = np.asarray(jsp.stance_hull(pj, retract, cfg_j.support_polygon))
    ht = tsp.stance_hull(pt, pt.retract_config, cfg_t.support_polygon).numpy()
    np.testing.assert_allclose(ht, hj, atol=1e-5)
    rj = jsp.configure_rollout(cfg_j, pj, retract)
    rt = tsp.configure_rollout(cfg_t, pt, retract)
    np.testing.assert_allclose(np.asarray(rt.support_hull), np.asarray(rj.support_hull), atol=1e-5)
    off = dataclasses.replace(cfg_t, support_polygon=None)
    assert tsp.configure_rollout(off, pt, retract) is off
    # the retract stance is balanced: its ground-projected CoM is inside
    st = g1["kt"].compute_kinematics(pt.retract_config)
    com = tcom(pt, st.link_rot, st.link_pos)
    sd = tsp.signed_distance_to_hull(com[:2], torch.as_tensor(rt.support_hull))
    assert float(sd) < 0.0


# ---------------------------------------------------------------------------
# the generic objective and the configs
# ---------------------------------------------------------------------------
def test_evaluate_config_matches_jax_with_support_polygon(g1):
    """`ik_g1.yml`'s rollout with its hull baked at retract, forward only."""
    pj, pt = g1["pj"], g1["pt"]
    retract = np.asarray(pj.retract_config)
    cfg_j = jsp.configure_rollout(
        JIKConfig.from_yaml(os.path.join(JAX_CONTENT, "tasks", "ik_g1.yml")).rollout, pj, retract)
    cfg_t = tsp.configure_rollout(
        ct.IKConfig.from_yaml(ct.content_path("tasks", "ik_g1.yml")).rollout, pt, retract)
    rng = np.random.RandomState(11)
    q = _near_retract(pj, rng, 4, 0.3)
    sj = jfk(pj, jnp.asarray(q[:1] + 0.1))
    gp, gq = np.asarray(sj.tool_pose.position), np.asarray(sj.tool_pose.quaternion)
    rj = JRollout(pj, cfg_j).evaluate_config(
        jwm.empty_world(), JGoal.from_pose(JPose(jnp.asarray(gp), jnp.asarray(gq))), jnp.asarray(q))
    rt = RobotRollout(pt, cfg_t).evaluate_config(
        ct.empty_world(device="cpu"),
        Goal.from_pose(ct.Pose(torch.as_tensor(gp), torch.as_tensor(gq))), torch.as_tensor(q))
    np.testing.assert_allclose(rt.cost.numpy(), np.asarray(rj.cost), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(rt.pos_err.numpy(), np.asarray(rj.pos_err), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rt.rot_err.numpy(), np.asarray(rj.rot_err), rtol=1e-5, atol=1e-5)
    for f in ("feasible", "self_colliding", "in_collision", "out_of_bounds"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), err_msg=f)
    # the term is in the cost, and the cost-only path gives the same cost
    off = RobotRollout(pt, dataclasses.replace(cfg_t, support_polygon=None))
    goal_t = Goal.from_pose(ct.Pose(torch.as_tensor(gp), torch.as_tensor(gq)))
    world_t = ct.empty_world(device="cpu")
    assert not torch.equal(off.cost_config(world_t, goal_t, torch.as_tensor(q)), rt.cost)
    assert torch.equal(RobotRollout(pt, cfg_t).cost_config(world_t, goal_t, torch.as_tensor(q)),
                       rt.cost)
    with pytest.raises(ValueError, match="hull"):
        RobotRollout(pt, dataclasses.replace(cfg_t, support_hull=None)).cost_config(
            world_t, goal_t, torch.as_tensor(q))


def test_evaluate_trajectory_support_polygon_matches_jax():
    """The term over a horizon, on the Franka (a hull from its first six
    spheres), against the jitted JAX trajectory objective."""
    from curobo_tpu.rollout.robot_rollout import RobotRolloutConfig as JCfg
    from curobo_tpu.types.state import JointState as JJS

    kj = JKin.from_robot_yaml(os.path.join(JAX_CONTENT, "robots", "franka.yml"))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    rng = np.random.RandomState(12)
    hull = jsp.convex_hull_2d(rng.uniform(-0.15, 0.15, (8, 2)), 0.0)
    hull_t = tuple(map(tuple, hull.tolist()))
    cfg_j = JCfg(support_polygon=jsp.SupportPolygonConfig(weight=50.0), support_hull=hull_t)
    cfg_t = ct.RobotRolloutConfig(support_polygon=tsp.SupportPolygonConfig(weight=50.0),
                                  support_hull=hull_t)
    B, H, D = 3, 4, kt.n_dof
    q = rng.uniform(-1.5, 1.5, (B, H, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (B, H, D)).astype(np.float32)
    sj = jfk(kj.params, jnp.asarray(q[:, -1]))
    gp, gq = np.asarray(sj.tool_pose.position), np.asarray(sj.tool_pose.quaternion)
    goal_j = JGoal.from_pose(JPose(jnp.asarray(gp), jnp.asarray(gq)))
    cj = jax.jit(lambda qq, vv: JRollout(kj.params, cfg_j).evaluate_trajectory(
        jwm.empty_world(), goal_j, JJS(position=qq, velocity=vv)).cost)(jnp.asarray(q), jnp.asarray(v))
    rt = RobotRollout(kt.params, cfg_t).evaluate_trajectory(
        ct.empty_world(device="cpu"), Goal.from_pose(ct.Pose(torch.as_tensor(gp), torch.as_tensor(gq))),
        ct.JointState(position=torch.as_tensor(q), velocity=torch.as_tensor(v)))
    off = RobotRollout(kt.params, dataclasses.replace(cfg_t, support_polygon=None)).evaluate_trajectory(
        ct.empty_world(device="cpu"), Goal.from_pose(ct.Pose(torch.as_tensor(gp), torch.as_tensor(gq))),
        ct.JointState(position=torch.as_tensor(q), velocity=torch.as_tensor(v)))
    assert float((rt.cost - off.cost).abs().min()) > 1e-3
    np.testing.assert_allclose(rt.cost.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-4)


def _tree(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


@pytest.mark.parametrize("name", ["ik_g1.yml", "ik.yml"])
def test_ik_config_from_yaml_matches_jax(name):
    cj = JIKConfig.from_yaml(os.path.join(JAX_CONTENT, "tasks", name))
    cfg = ct.IKConfig.from_yaml(ct.content_path("tasks", name))
    assert _tree(cfg) == _tree(cj)
    sp = cfg.rollout.support_polygon
    assert sp is None or isinstance(sp, tsp.SupportPolygonConfig)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------
def test_route_is_decided_by_the_robots_shapes(g1):
    pt = g1["pt"]
    pose1 = ct.Pose(torch.zeros(1, 4, 3), torch.tensor([1.0, 0, 0, 0]).expand(1, 4, 4))
    s = ct.IKSolver(pt, ct.IKConfig(), device="cpu")
    assert not ikk.robot_takes_kernel(pt, 12)
    assert s._ik_cost is None and s._solve_kernel is None
    assert not s._use_kernel(Goal.from_pose(pose1))
    # both the dof and the pair lists (4 words a pair) refuse the G1
    assert ikk.IK_MAXD < pt.n_dof
    assert 4 * 4 * int(torch.isfinite(pt.self_collision.pair_margin).sum()) > ikk.IK_SMEM_BYTES
    for robot, T in (("franka", 1), ("dual_ur10e", 2)):
        kin = ct.Kinematics.from_robot_yaml(ct.robot_config_path(robot), device="cpu")
        sk = ct.IKSolver(kin.params, ct.IKConfig(), device="cpu")
        assert ikk.robot_takes_kernel(kin.params, 12) and sk._solve_kernel is not None
        pose = ct.Pose(torch.zeros(1, T, 3), torch.tensor([1.0, 0, 0, 0]).expand(1, T, 4))
        assert sk._use_kernel(Goal.from_pose(pose))


def test_python_constants_match_the_kernel_sources():
    src = {}
    for f in ("ik_device.cuh", "ik_kernels.cu"):
        with open(os.path.join(ROOT, "curobo_tpu_torch", "ops", "csrc", f)) as fh:
            src[f] = fh.read()
    assert int(re.search(r"#define IK_MAXD (\d+)", src["ik_device.cuh"]).group(1)) == ikk.IK_MAXD
    assert int(re.search(r"#define IK_WARPS (\d+)", src["ik_kernels.cu"]).group(1)) == ikk._IK_WARPS
    assert "(((7 * IK_MAXT) + 3) & ~3)" in src["ik_device.cuh"]
    assert "#define IK_TERR_WORDS (6 * IK_MAXT)" in src["ik_device.cuh"]
    # the words of the robot tables and of a warp, as the launch counts them
    assert "3 * r.L + 17 * r.L + 4 * r.S + r.S + (r.S + 1) + 4 * r.P + (r.L + 1) + r.n_lsph +" in (
        src["ik_device.cuh"])
    assert "o.oQ = 18 * L + 6 * S; o.oGQ = o.oQ + IK_MAXD; o.words = o.oGQ + IK_MAXD;" in (
        src["ik_device.cuh"])
    assert "return 2 * m * D + 3 * m;" in src["ik_device.cuh"]


# ---------------------------------------------------------------------------
# a CPU-sized solve of the benchmark protocol
# ---------------------------------------------------------------------------
def test_cpu_sized_solve_of_the_benchmark_protocol(g1):
    """`tests/test_humanoid.py::test_hard_protocol_success_rate`'s sizes and
    gate on the port: free floating base (box +-2 m), goals = FK of
    collision-free configurations over the full limits (RandomState(7)), the
    table world, 4 seeds from an LM pool of 16, no MPPI, L-BFGS 30, 5 mm."""
    kt, p = g1["kt"], g1["pt"]
    cfg = ct.IKConfig.from_yaml(ct.content_path("tasks", "ik_g1.yml"))
    cfg = dataclasses.replace(
        cfg, n_seeds=4, lm_seed_pool=16, use_particle_stage=False,
        lbfgs=dataclasses.replace(cfg.lbfgs, n_iters=30), position_threshold=0.005,
        rollout=dataclasses.replace(cfg.rollout, support_polygon=None),
    )
    world = ct.compile_scene(tgt.Scene().add(
        tgt.Cuboid(name="table", pose=[0, 0, -0.2, 1, 0, 0, 0], dims=[4.0, 4.0, 0.2])), device="cpu")
    rng = np.random.RandomState(7)
    B = 10
    lo, hi = p.joint_limits.lower.numpy().copy(), p.joint_limits.upper.numpy().copy()
    lo[:3], hi[:3] = [-2.0, -2.0, 0.0], [2.0, 2.0, 1.5]
    rsc = ct.RobotSceneCollision(p)
    pool, got = [], 0
    while got < B:
        cand = rng.uniform(lo, hi, (8 * B, p.n_dof)).astype(np.float32)
        ok = rsc.validate(world, torch.as_tensor(cand)).numpy()
        pool.append(cand[ok])
        got += int(ok.sum())
    st = kt.compute_kinematics(torch.as_tensor(np.concatenate(pool)[:B]))
    goals = ct.Pose(st.tool_pose.position, st.tool_pose.quaternion)
    solver = ct.IKSolver(p, cfg, device="cpu")
    assert not solver._use_kernel(Goal.from_pose(goals))
    res = solver.solve_pose(world, goals, seed_state=p.retract_config)
    assert torch.isfinite(res.solution).all() and torch.isfinite(res.cost).all()
    n_ok = int(res.success.sum())
    assert n_ok >= int(0.8 * B), f"G1 success {n_ok}/{B}; pos_err={res.position_error.numpy()}"
    fk = kt.compute_kinematics(res.solution).tool_pose.position
    err = (fk - goals.position).norm(dim=-1).amax(dim=-1)
    assert float(err[res.success].max()) <= 0.005 + 1e-5
