"""The IK kernels' plain PyTorch versions against the JAX package on the CPU.

`ik_cost_grad_plain` is held to the JAX blast reference
(`BlastRollout.evaluate_config` and `jax.grad` of its sum) on the Franka with
the tolerances the JAX package holds its own Pallas kernel to; the metrics
tail is held to blast as well; the MPPI stage is held to the JAX `_mppi_loop`
traced directly as jnp on the UR10e, with the same numpy noise injected into
both. The CUDA kernels themselves are held against these plain versions on
the card by `chip_smoke.py`.
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
from curobo_tpu.cost import terms as jterms
from curobo_tpu.geom import types as jgt
from curobo_tpu.geom import world as jwm
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.robot.kinematics import compute_kinematics as jfk
from curobo_tpu.rollout.robot_rollout import Goal as JGoal
from curobo_tpu.rollout.robot_rollout import RobotRolloutConfig as JRolloutConfig
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu_torch.cost import terms as tterms
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.ops import ik_kernels as ikk

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")


def _scene(mod, ball):
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        mod.SphereObstacle(name="ball", pose=ball + [1, 0, 0, 0], radius=0.1),
    )


def _ik_rollout(mod_cfg, mod_terms, **kw):
    """IK's collision config: scene activation 0, weight 500."""
    return mod_cfg(
        collision_cost=mod_terms.CollisionCostConfig(weight=500.0, activation_distance=0.0), **kw
    )


def _goals(kj, rng, n, span):
    qg = rng.uniform(-span, span, (n, kj.n_dof)).astype(np.float32)
    st = jfk(kj.params, jnp.asarray(qg))
    pos, quat = st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0]
    goal7 = np.concatenate([np.asarray(pos), np.asarray(quat)], axis=-1)
    return JGoal.from_pose(JPose(pos, quat)), goal7


@pytest.fixture(scope="module", params=["ik", "null_space"])
def franka_case(request):
    """N = 256 Franka configurations through blast (cost, gradient, metrics)
    and through the plain version, for IK's rollout config and for one with
    the null-space term on."""
    from curobo_tpu.ops.blast import BlastRollout

    kw = {} if request.param == "ik" else {"null_space_weight": 0.3}
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "franka.yml"))
    wj = jwm.compile_scene(_scene(jgt, [0.3, 0.3, 0.5]))
    blast = BlastRollout(kj.params, _ik_rollout(JRolloutConfig, jterms, **kw))
    rng = np.random.RandomState(0)
    N = 256
    q = rng.uniform(-1.3, 1.3, (N, 7)).astype(np.float32)
    q[:8, 0] = 2.95  # a few configurations outside the joint limits
    goal, goal7 = _goals(kj, rng, N, 1.0)
    res = blast.evaluate_config(wj, goal, jnp.asarray(q))
    gb = jax.grad(lambda x: jnp.sum(blast.evaluate_config(wj, goal, x).cost))(jnp.asarray(q))

    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    wt = ct.compile_scene(_scene(tgt, [0.3, 0.3, 0.5]), device="cpu")
    ikc = ikk.IKCost(kt.params, _ik_rollout(ct.RobotRolloutConfig, tterms, **kw))
    return dict(res=res, gb=np.asarray(gb), ikc=ikc, wt=wt, q=torch.as_tensor(q),
                goal7=torch.as_tensor(goal7))


def test_cost_and_grad_match_blast(franka_case):
    f = franka_case
    c, g = f["ikc"](f["goal7"], f["q"], f["wt"])
    cb = np.asarray(f["res"].cost)
    # sums over 694 pair terms and 61 sphere terms run in another order than
    # in XLA: median and 99th percentile of the relative error
    rel_c = np.abs(c.numpy() - cb) / (np.abs(cb) + 1e-2)
    assert np.median(rel_c) < 1e-4
    assert np.percentile(rel_c, 99) < 1e-2
    rel_g = np.abs(g.numpy() - f["gb"]) / (np.abs(f["gb"]) + 1.0)
    assert np.median(rel_g) < 1e-4
    assert np.percentile(rel_g, 99) < 1e-2


def test_cost_only_matches_cost_with_grad(franka_case):
    f = franka_case
    c_fwd = f["ikc"].cost_only(f["goal7"], f["q"], f["wt"])
    c_grad, _ = f["ikc"](f["goal7"], f["q"], f["wt"])
    np.testing.assert_allclose(c_fwd.numpy(), c_grad.numpy(), rtol=1e-5)


def test_metrics_tail_matches_blast(franka_case):
    f = franka_case
    tab, wtabs = f["ikc"].tables, ikk.pack_world_arrays(f["wt"])
    c, pe2, re2, sv, mc = ikk._eval_plain(tab, wtabs, f["goal7"], f["q"], with_metrics=True)
    c, pe, re, fe = ikk._finish_metrics_plain(tab, c, f["q"], pe2, re2, sv, mc)
    res = f["res"]
    np.testing.assert_allclose(pe.numpy(), np.asarray(res.pos_err), atol=1e-5)
    np.testing.assert_allclose(re.numpy(), np.asarray(res.rot_err), atol=2e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(res.cost), rtol=1e-4, atol=1e-3)
    assert np.mean((fe.numpy() > 0.5) == np.asarray(res.feasible)) == 1.0
    assert 0.0 < fe.mean().item() < 1.0  # both outcomes occur in the sample


def test_robot_tables_fold_constant_links():
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    tab = ikk.build_ik_tables(kt.params, ct.IKConfig().rollout)
    assert (tab.L, tab.S, tab.P, tab.D) == (15, 65, 694, 7)
    kinds = tab.link_i[:, 0].tolist()
    assert kinds == [0] + [1] * 7 + [0] * 7  # locked finger joints are constants
    # the locked prismatic fingers keep their 0.04 m offset in the folded p
    p = kt.params
    for i in (12, 13):
        folded = p.fixed_pos[i] + p.fixed_rot[i] @ (p.joint_axis[i] * 0.04)
        np.testing.assert_allclose(tab.link_f[i, 11:14].numpy(), folded.numpy(), atol=1e-7)
    lo, hi = p.dof_clip_bounds()
    assert np.array_equal(tab.dof_f[:, 2].numpy(), lo) and np.array_equal(tab.dof_f[:, 3].numpy(), hi)
    assert int((tab.sph_f[:, 3] >= 0).sum()) == 61


# ---------------------------------------------------------------------------
# What the warp kernels read from the host: per-sphere pair lists, per-link
# sphere lists, and the world rows as the kernels compact them
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def franka_tables():
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    return kt, ikk.build_ik_tables(kt.params, ct.IKConfig().rollout)


def test_sphere_pair_lists_hold_each_live_pair_once_per_end(franka_tables):
    _, tab = franka_tables
    off, pj, pm = tab.sph_pair_off.numpy(), tab.sph_pair_j.numpy(), tab.sph_pair_m.numpy()
    pairs = {(int(a), int(b)): (k, float(m))
             for k, ((a, b), m) in enumerate(zip(tab.pair_i.numpy(), tab.pair_m.numpy()))}
    assert len(pairs) == tab.P and off[0] == 0 and off[-1] == 2 * tab.P
    low, high = {}, {}
    for s in range(tab.S):
        keys = [(min(s, int(t)), max(s, int(t))) for t in pj[off[s]:off[s + 1]]]
        idx = [pairs[key][0] for key in keys]
        assert idx == sorted(idx)  # in pair order
        for key, t, m in zip(keys, pj[off[s]:off[s + 1]], pm[off[s]:off[s + 1]]):
            assert pairs[key][1] == float(m)
            # the hinge cost is counted at the lower-index end only
            side = low if s < t else high
            side[key] = side.get(key, 0) + 1
    assert low == {k: 1 for k in pairs} and high == {k: 1 for k in pairs}


def test_link_sphere_lists_partition_the_live_spheres(franka_tables):
    _, tab = franka_tables
    off, ls = tab.link_sph_off.numpy(), tab.link_sph.numpy()
    live = np.nonzero(tab.sph_f[:, 3].numpy() >= 0)[0]
    assert sorted(ls.tolist()) == live.tolist() and off[-1] == len(live)
    links = tab.sph_link.numpy()
    for l in range(tab.L):
        seg = ls[off[l]:off[l + 1]]
        assert np.all(links[seg] == l) and np.all(np.diff(seg) > 0)


def test_pair_lists_reproduce_the_self_collision_cost_and_cotangents(franka_tables):
    """A vectorised index_add over the per-sphere lists (what the lanes sum)
    against autograd of the pair hinge as `ik_cost_grad_plain` computes it."""
    kt, tab = franka_tables
    _, _, _, _, sc_w, sc_act, _, _ = tab.cfg_host
    rng = np.random.RandomState(5)
    q = torch.as_tensor(rng.uniform(-2.0, 2.0, (64, 7)).astype(np.float32))
    R, p = ikk._fk_plain(tab, q)
    sl = tab.sph_link.long()
    centres = ((R[:, sl] @ tab.sph_f[:, 0:3, None])[..., 0] + p[:, sl]).detach().requires_grad_(True)
    dd = centres[:, tab.pair_i[:, 0].long()] - centres[:, tab.pair_i[:, 1].long()]
    dist = torch.sqrt((dd * dd).sum(dim=-1) + 1e-12)
    cost = sc_w * (tab.pair_m + sc_act - dist).clamp_min(0.0).sum(dim=-1)
    (g_ref,) = torch.autograd.grad(cost.sum(), centres)
    c_ref = cost.detach()
    assert float(c_ref.min()) == 0.0 and float(c_ref.max()) > 0.0  # both hinge branches occur

    c = centres.detach()
    off = tab.sph_pair_off.long()
    src = torch.repeat_interleave(torch.arange(tab.S), off[1:] - off[:-1])
    dst = tab.sph_pair_j.long()
    dd = c[:, src] - c[:, dst]
    dist = torch.sqrt((dd * dd).sum(dim=-1) + 1e-12)
    h = tab.sph_pair_m + sc_act - dist
    active = (h > 0).to(c.dtype)
    cost_l = sc_w * (h.clamp_min(0.0) * (src < dst).to(c.dtype)).sum(dim=-1)
    cot = (active * (-sc_w / dist))[..., None] * dd
    g_l = torch.zeros_like(c).index_add_(1, src, cot)
    np.testing.assert_allclose(cost_l.numpy(), c_ref.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g_l.numpy(), g_ref.numpy(), rtol=1e-6, atol=1e-6)


def test_compacted_world_rows_keep_the_first_strict_minimum():
    """The kernels copy a table's enabled rows into shared memory in table
    order (a ballot and prefix count per 32 rows) and scan them with a strict
    `<`. Scanning the compacted rows must pick the same row as scanning the
    full table with disabled rows at 1e6, ties included."""
    rng = np.random.RandomState(6)
    K = 40
    cub = np.zeros((K, 16), np.float32)
    cub[:, 0:9] = np.eye(3, dtype=np.float32).reshape(9)
    cub[:, 9:12] = rng.uniform(-0.5, 0.5, (K, 3))
    cub[:, 12:15] = rng.uniform(0.05, 0.2, (K, 3))
    cub[:, 15] = (rng.uniform(size=K) < 0.4).astype(np.float32)
    cub[[3, 11, 33]] = cub[5]  # exact duplicates: ties between rows
    cub[[3, 5, 11, 33], 15] = [1.0, 0.0, 1.0, 1.0]
    empty = [np.zeros((1, w), np.float32) for w in (5, 8, 15)]
    pts = torch.as_tensor(rng.uniform(-0.7, 0.7, (500, 3)).astype(np.float32))
    per_row = torch.stack([
        ikk._scene_msdf_plain(tuple(torch.as_tensor(t) for t in [cub[r:r + 1]] + empty), pts)
        for r in range(K)
    ], dim=-1)  # (points, K); a disabled row gives 1e6

    def first_strict_min(d, rows):
        best = torch.full(d.shape[:1], ikk.BIG)
        arg = torch.full(d.shape[:1], -1, dtype=torch.long)
        for r in rows:
            better = d[:, r] < best
            best = torch.where(better, d[:, r], best)
            arg = torch.where(better, torch.full_like(arg, r), arg)
        return best, arg

    enabled = np.nonzero(cub[:, 15] > 0.5)[0]
    compacted = cub[enabled]  # the kernels' shared copy
    assert np.array_equal(compacted, np.concatenate([cub[r:r + 1] for r in range(K) if cub[r, 15] > 0.5]))
    full_min, full_arg = first_strict_min(per_row, range(K))
    comp_min, comp_arg = first_strict_min(per_row[:, enabled], range(len(enabled)))
    assert torch.equal(full_min, comp_min)
    assert torch.equal(full_arg, torch.as_tensor(enabled)[comp_arg])
    assert bool((full_arg == 3).any())  # a tie went to the earliest enabled duplicate
    full = ikk._scene_msdf_plain(tuple(torch.as_tensor(t) for t in [cub] + empty), pts)
    assert torch.equal(full, full_min)


@pytest.fixture(scope="module")
def ur10e_case():
    from curobo_tpu.ops.pallas_ik import BLK, LANE, SUB, PallasIKCost, pack_world_arrays

    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "ur10e.yml"))
    wj = jwm.compile_scene(_scene(jgt, [0.35, 0.2, 0.45]))
    pik = PallasIKCost(kj.params, _ik_rollout(JRolloutConfig, jterms), wj)
    rng = np.random.RandomState(3)
    N, D = BLK, kj.n_dof
    q0 = rng.uniform(-1.5, 1.5, (N, D)).astype(np.float32)
    _, goal7 = _goals(kj, rng, N, 1.5)
    blk = lambda a: jnp.moveaxis(jnp.asarray(a).reshape(SUB, LANE, a.shape[-1]), -1, 0)
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    wt = ct.compile_scene(_scene(tgt, [0.35, 0.2, 0.45]), device="cpu")
    ikc = ikk.IKCost(kt.params, _ik_rollout(ct.RobotRolloutConfig, tterms))
    return dict(pik=pik, refs=pack_world_arrays(wj), goal_blk=blk(goal7), q_blk=blk(q0),
                ikc=ikc, wt=wt, q0=torch.as_tensor(q0), goal7=torch.as_tensor(goal7), N=N, D=D,
                shape=(SUB, LANE))


def test_mppi_stage_matches_jax_loop_with_the_same_noise(ur10e_case):
    u = ur10e_case
    pik, N, D = u["pik"], u["N"], u["D"]
    iters, particles = 2, 4
    noise = np.random.RandomState(11).normal(size=(iters, particles, N, D)).astype(np.float32)
    # the JAX loop draws one (D, SUB, LANE) sample per particle, in order
    stream = jnp.asarray(
        np.moveaxis(noise.reshape(iters * particles, *u["shape"], D), -1, 1)
    )

    def normal_fn(i, shape):
        return i + 1, stream[i]

    def run(q_blk):
        cost_fn, _, _, _ = pik._cost_fns(u["refs"], u["goal_blk"], pik._D_pair, pik._margin)
        return pik._mppi_loop(
            cost_fn, pik._clip_q_fn(), q_blk, iters, particles, 0.5, 0.9, 0.01, 0.05, 0.9,
            rng=(jnp.zeros((), jnp.int32), normal_fn),
        )

    xj, cj = jax.jit(run)(u["q_blk"])
    xj = np.moveaxis(np.asarray(xj), 0, -1).reshape(N, D)
    cj = np.asarray(cj).reshape(N)
    solve = u["ikc"].build_mppi_solver(
        n_iters=iters, n_particles=particles, init_std=0.5, std_decay=0.9, min_std=0.01,
        temperature=0.05, step_size=0.9,
    )
    xt, ct_ = solve(u["goal7"], u["q0"], 0, u["wt"], noise=torch.as_tensor(noise))
    # a strict `<` between two particles' costs can flip on a rounding
    # difference, after which the two runs keep another best particle: held
    # loosely; a wrong shift, weight or noise order would move most rows
    rel = np.abs(ct_.numpy() - cj) / (np.abs(cj) + 1e-2)
    assert np.median(rel) < 1e-3
    assert np.mean(np.abs(xt.numpy() - xj).max(axis=-1) < 1e-3) >= 0.95


def test_mppi_stage_descends_and_is_keyed_by_seed(ur10e_case):
    u = ur10e_case
    sl = slice(0, 64)
    solve = u["ikc"].build_mppi_solver(n_iters=3, n_particles=6)
    c0 = u["ikc"].cost_only(u["goal7"][sl], u["q0"][sl], u["wt"])
    x1, c1 = solve(u["goal7"][sl], u["q0"][sl], 5, u["wt"])
    x2, c2 = solve(u["goal7"][sl], u["q0"][sl], 5, u["wt"])
    x3, _ = solve(u["goal7"][sl], u["q0"][sl], 6, u["wt"])
    assert torch.equal(x1, x2) and not torch.equal(x1, x3)
    assert c1.mean() < c0.mean() and float((c1 - c0).max()) <= 1e-5


def test_lbfgs_stage_descends(ur10e_case):
    u = ur10e_case
    sl = slice(0, 64)
    solve = u["ikc"].build_lbfgs_solver(n_iters=10, history=4, n_linesearch=4)
    c0 = u["ikc"].cost_only(u["goal7"][sl], u["q0"][sl], u["wt"])
    _, c1 = solve(u["goal7"][sl], u["q0"][sl], u["wt"])
    assert float(c1.mean()) < 0.2 * float(c0.mean())
    assert float((c1 - c0).max()) <= 1e-5


def test_philox_plain_is_standard_normal_and_counter_based():
    z = ikk.philox_normal_plain(3, 200, 4, 8, 7)
    assert z.shape == (4, 8, 200, 7)
    n = z.numel()
    assert abs(float(z.mean())) < 6.0 / n ** 0.5
    assert abs(float(z.var()) - 1.0) < 0.03
    # keyed by (seed, config, iteration, particle): a sub-batch draws the
    # same numbers, another seed draws others
    assert torch.equal(ikk.philox_normal_plain(3, 50, 4, 8, 7), z[:, :, :50])
    assert not torch.equal(ikk.philox_normal_plain(4, 200, 4, 8, 7), z)
    assert torch.equal(ikk.philox_normal(3, 200, 4, 8, 7, "cpu"), z)


def test_mulhilo_matches_integer_arithmetic():
    rng = np.random.RandomState(0)
    b = rng.randint(0, 2**32, size=256, dtype=np.uint64)
    b[:3] = [0, 2**32 - 1, 2**31]
    for a in (0xD2511F53, 0xCD9E8D57):
        hi, lo = ikk._mulhilo(a, torch.as_tensor(b.astype(np.int64)))
        prod = [a * int(v) for v in b]
        assert hi.tolist() == [p >> 32 for p in prod]
        assert lo.tolist() == [p & 0xFFFFFFFF for p in prod]


def test_wrappers_refuse_what_the_kernels_do_not_take(ur10e_case):
    u = ur10e_case
    tab, wtabs = u["ikc"].tables, ikk.pack_world_arrays(u["wt"])
    g, q = u["goal7"][:4], u["q0"][:4]
    with pytest.raises(ValueError, match="q must have shape"):
        ikk.ik_cost_grad(tab, wtabs, g, q[:, :5])
    with pytest.raises(ValueError, match="goal7 must have shape"):
        ikk.ik_cost_grad(tab, wtabs, g[:, :6], q)
    with pytest.raises(ValueError, match="float32"):
        ikk.ik_cost_grad(tab, wtabs, g, q.double())
    with pytest.raises(ValueError, match="world table"):
        ikk.ik_cost_grad(tab, (wtabs[0][:, :5],) + wtabs[1:], g, q)
    with pytest.raises(ValueError, match="noise must be"):
        ikk.ik_solve(tab, wtabs, g, q, ikk.IKSolveBudget(mppi_iters=2, n_particles=3),
                     noise=torch.zeros(2, 3, 5, u["D"]))
    with pytest.raises(ValueError, match="history"):
        ikk.ik_solve(tab, wtabs, g, q, ikk.IKSolveBudget(history=0))


def test_unsupported_robots_and_configs_are_refused():
    # two tool frames are served (T = 2 tables); more than IK_MAXT are refused
    dual_cfg = ct.RobotModelConfig.from_yaml(ct.robot_config_path("dual_ur10e"))
    dual = ct.build_kinematics_params(dual_cfg, device="cpu")
    assert ikk.IKCost(dual, ct.IKConfig().rollout).tables.tools == dual.tool_frame_idx
    many = dataclasses.replace(
        dual_cfg, tool_frames=["tool0", "tool1", "flange", "flange_1", "wrist_3_link"]
    )
    assert len(many.tool_frames) > ikk.IK_MAXT
    with pytest.raises(NotImplementedError, match="5 tool frames"):
        ikk.IKCost(ct.build_kinematics_params(many, device="cpu"), ct.IKConfig().rollout)
    mimic = ct.Kinematics.from_robot_yaml(ct.robot_config_path("simple_mimic_robot"), device="cpu")
    with pytest.raises(ValueError, match="no collision spheres"):
        ikk.IKCost(mimic.params, ct.IKConfig().rollout)
    ur = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    bad = dataclasses.replace(
        ct.IKConfig().rollout, pose_cost=tterms.PoseCostConfig(position_axis_weight=(1.0, 1.0, 0.0))
    )
    assert not ikk.rollout_config_is_supported(bad)
    with pytest.raises(NotImplementedError, match="per-axis"):
        ikk.IKCost(ur.params, bad)
