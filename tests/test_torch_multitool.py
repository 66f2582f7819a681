"""The IK kernels' plain versions at two tool frames (the dual-arm UR10e)
against the JAX package on the CPU.

`ik_cost_grad_plain` at T = 2 is held to the JAX blast reference
(`BlastRollout.evaluate_config` and `jax.grad` of its sum) with the limits the
JAX package holds its own Pallas kernel to at T = 2
(`tests/test_pallas_ik.py::test_multitool_cost_and_grad_match_blast`); the
metrics tail, which takes each error's largest value over the tools, is held
to blast's. The L-BFGS stage of `ik_solve_plain` at T = 2 is held to the JAX
kernel's own loop (`PallasIKCost._lbfgs_loop`) driven by the blast objective:
tracing the Pallas body of the dual arm on the CPU (pose-only warm-up and
full cost, 566 pairs) takes about three minutes, blast about forty seconds.
The CUDA kernels are held against these plain versions on the card by
`chip_smoke.py` (phase `dual`).
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

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_ROBOTS = os.path.join(ROOT, "curobo_tpu", "content", "robots")


def _scene(mod):
    """The reference bench's table under both arms, and a ball between them."""
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.0, 0.0, -0.1, 1, 0, 0, 0], dims=[4.0, 4.0, 0.2]),
        mod.SphereObstacle(name="ball", pose=[0.3, 0.6, 0.5, 1, 0, 0, 0], radius=0.1),
    )


def _ik_rollout(mod_cfg, mod_terms):
    """IK's collision config: scene activation 0, weight 500."""
    return mod_cfg(
        collision_cost=mod_terms.CollisionCostConfig(weight=500.0, activation_distance=0.0)
    )


def _goals(kj, rng, n):
    """Goals of both tool frames: FK of random configurations -> (JAX Goal
    batch (n, 2), goal7 (n, 14))."""
    qg = rng.uniform(-1.0, 1.0, (n, kj.n_dof)).astype(np.float32)
    st = jfk(kj.params, jnp.asarray(qg))
    goal = JGoal.from_pose(JPose(st.tool_pose.position, st.tool_pose.quaternion))
    goal7 = np.concatenate(
        [np.asarray(st.tool_pose.position), np.asarray(st.tool_pose.quaternion)], axis=-1
    ).reshape(n, 7 * kj.params.n_tools)
    return goal, goal7


@pytest.fixture(scope="module")
def dual():
    from curobo_tpu.ops.blast import BlastRollout

    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "dual_ur10e.yml"))
    wj = jwm.compile_scene(_scene(jgt))
    blast = BlastRollout(kj.params, _ik_rollout(JRolloutConfig, jterms))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("dual_ur10e"), device="cpu")
    wt = ct.compile_scene(_scene(tgt), device="cpu")
    ikc = ikk.IKCost(kt.params, _ik_rollout(ct.RobotRolloutConfig, tterms))
    return dict(kj=kj, wj=wj, blast=blast, kt=kt, wt=wt, ikc=ikc)


@pytest.fixture(scope="module")
def dual_case(dual):
    """N = 256 dual-arm configurations through blast (cost, gradient,
    metrics); a few outside the joint limits."""
    rng = np.random.RandomState(3)
    N, D = 256, dual["kj"].n_dof
    q = rng.uniform(-1.2, 1.2, (N, D)).astype(np.float32)
    q[:8, 0] = 6.5  # outside the UR10e's +-2 pi shoulder limit
    goal, goal7 = _goals(dual["kj"], rng, N)
    blast, wj = dual["blast"], dual["wj"]
    res = blast.evaluate_config(wj, goal, jnp.asarray(q))
    gb = jax.grad(lambda x: jnp.sum(blast.evaluate_config(wj, goal, x).cost))(jnp.asarray(q))
    return dict(res=res, gb=np.asarray(gb), q=torch.as_tensor(q), goal7=torch.as_tensor(goal7))


def test_tables_hold_both_tool_frames(dual):
    tab = dual["ikc"].tables
    p = dual["kt"].params
    assert tab.T == 2 and tab.tools == p.tool_frame_idx
    assert (tab.D, tab.L, tab.P) == (12, 22, 566)
    assert int((tab.sph_f[:, 3] >= 0).sum()) == 40
    # links are numbered parents first: the kernel's one reverse sweep from the
    # last link down reaches both arms' branches under `base_fixture_link`
    assert all(par < i for i, (_, par, _) in enumerate(tab.link_host))
    assert p.tool_ancestor_mask()[:, p.link_index("base_fixture_link")].tolist() == [1.0, 1.0]


def test_cost_and_grad_match_blast_at_two_tools(dual, dual_case):
    f = dual_case
    c, g = dual["ikc"](f["goal7"], f["q"], dual["wt"])
    cb = np.asarray(f["res"].cost)
    # sums over 566 pair terms and 40 sphere terms run in another order than
    # in XLA: median and 99th percentile of the relative error
    rel_c = np.abs(c.numpy() - cb) / (np.abs(cb) + 1e-2)
    assert np.median(rel_c) < 1e-4
    assert np.percentile(rel_c, 99) < 1e-2
    rel_g = np.abs(g.numpy() - f["gb"]) / (np.abs(f["gb"]) + 1.0)
    assert np.median(rel_g) < 1e-4
    assert np.percentile(rel_g, 99) < 1e-2
    c_fwd = dual["ikc"].cost_only(f["goal7"], f["q"], dual["wt"])
    np.testing.assert_allclose(c_fwd.numpy(), c.numpy(), rtol=1e-5)


def test_pose_cost_is_the_sum_over_tools(dual, dual_case):
    """The pose-only objective at T = 2 is the sum of the two one-tool
    objectives (each tool's goal block through the same tables cut to that
    tool), where the joint-limit term, counted once in each, is 0."""
    f = dual_case
    tab, wtabs = dual["ikc"].tables, ikk.pack_world_arrays(dual["wt"])

    def pose_cost(tables, goal7):
        return ikk.ik_cost_grad_plain(tables, wtabs, goal7, f["q"], want_grad=False,
                                      pose_only=True)[0]

    both = pose_cost(tab, f["goal7"])
    parts = [pose_cost(dataclasses.replace(tab, tools=(link,)), f["goal7"][:, 7 * t: 7 * t + 7])
             for t, link in enumerate(tab.tools)]
    inside = slice(8, None)  # rows 0..7 lie outside the joint limits
    np.testing.assert_allclose((parts[0] + parts[1])[inside].numpy(), both[inside].numpy(),
                               rtol=1e-6)
    assert bool((parts[0] > 1e-3).all() and (parts[1] > 1e-3).all())


def test_metrics_tail_takes_the_largest_error_over_tools(dual, dual_case):
    f = dual_case
    tab, wtabs = dual["ikc"].tables, ikk.pack_world_arrays(dual["wt"])
    c, pe2, re2, sv, mc = ikk._eval_plain(tab, wtabs, f["goal7"], f["q"], with_metrics=True)
    c, pe, re, fe = ikk._finish_metrics_plain(tab, c, f["q"], pe2, re2, sv, mc)
    res = f["res"]
    np.testing.assert_allclose(pe.numpy(), np.asarray(res.pos_err), atol=1e-5)
    np.testing.assert_allclose(re.numpy(), np.asarray(res.rot_err), atol=2e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(res.cost), rtol=1e-4, atol=1e-3)
    assert np.mean((fe.numpy() > 0.5) == np.asarray(res.feasible)) == 1.0
    assert 0.0 < fe.mean().item() < 1.0  # both outcomes occur in the sample
    # each tool's own error: the reported one is the larger of the two
    R, p = ikk._fk_plain(tab, f["q"])
    per_tool = torch.stack([
        ikk._pose_error_plain(f["goal7"][:, 7 * t: 7 * t + 7], R[:, link], p[:, link])[0]
        for t, link in enumerate(tab.tools)
    ])
    assert torch.equal(pe2, per_tool.amax(dim=0))
    assert bool((per_tool[0] != per_tool[1]).any())


def test_lbfgs_stage_matches_the_jax_loop_at_two_tools(dual):
    """`ik_solve_plain`'s L-BFGS stage (L-BFGS 3, history 4, line search 2) at
    T = 2 against the JAX kernel's `_lbfgs_loop` over the blast objective, on
    one 1024-configuration block."""
    from curobo_tpu.ops.pallas_ik import BLK, LANE, SUB, PallasIKCost

    kj, wj, blast = dual["kj"], dual["wj"], dual["blast"]
    N, D = BLK, kj.n_dof
    LBFGS, HIST, LS = 3, 4, 2
    rng = np.random.RandomState(4)
    q0 = rng.uniform(-1.5, 1.5, (N, D)).astype(np.float32)
    goal, goal7 = _goals(kj, rng, N)
    pik = PallasIKCost(kj.params, _ik_rollout(JRolloutConfig, jterms), wj,
                       self_collision_mode="matmul")  # only its clip and loop are used

    def from_blk(b):
        return jnp.moveaxis(b, 0, -1).reshape(N, D)

    def cost_fn(qq):
        return blast.evaluate_config(wj, goal, from_blk(qq)).cost.reshape(SUB, LANE)

    def cost_grad(qq):
        g = jax.grad(lambda x: jnp.sum(cost_fn(x)))(qq)
        return cost_fn(qq), g

    @jax.jit
    def run(q_blk):
        x, c = pik._lbfgs_loop(cost_fn, pik._clip_q_fn(), q_blk, LBFGS, HIST, 1.0, LS, 1.5, 0.45,
                               cost_grad=cost_grad)
        return from_blk(x), c.reshape(N)

    xj, cj = (np.asarray(a) for a in run(jnp.moveaxis(jnp.asarray(q0).reshape(SUB, LANE, D), -1, 0)))
    budget = ikk.IKSolveBudget(mppi_iters=0, lbfgs_iters=LBFGS, history=HIST, n_linesearch=LS)
    xt, ctt, pet, ret, fet = ikk.ik_solve_plain(
        dual["ikc"].tables, ikk.pack_world_arrays(dual["wt"]), torch.as_tensor(goal7),
        torch.as_tensor(q0), budget,
    )
    # held as the single-tool loops are: a strict `<` in the line search can
    # flip on a rounding difference and the two runs then part
    agree = np.abs(xt.numpy() - xj).max(axis=-1) < 1e-3
    assert agree.mean() >= 0.95
    c_at_j = np.asarray(blast.evaluate_config(wj, goal, jnp.asarray(xt.numpy())).cost)
    rel = np.abs(ctt.numpy() - c_at_j) / (np.abs(c_at_j) + 1e-2)
    assert np.median(rel) < 1e-3
    rel_best = np.abs(ctt.numpy() - cj) / (np.abs(cj) + 1e-2)
    assert np.median(rel_best) < 1e-3
    c0 = dual["ikc"].cost_only(torch.as_tensor(goal7), torch.as_tensor(q0), dual["wt"])
    assert float(ctt.mean()) < 0.5 * float(c0.mean())  # three iterations took cost away


def test_tool_count_limit_matches_the_kernel_source():
    with open(os.path.join(ROOT, "curobo_tpu_torch", "ops", "csrc", "ik_device.cuh")) as f:
        src = f.read()
    assert int(re.search(r"#define IK_MAXT (\d+)", src).group(1)) == ikk.IK_MAXT >= 4
