"""The slice as a whole on the CPU: the PyTorch `IKSolver.solve_pose` against
the JAX `IKSolver._solve_impl_pallas`, which is given (through its
`solve_kernel=` argument) the same composition of stages as the body of the
fused Pallas solver, traced directly as jnp on the UR10e: pose-only warm-up 4
(history 6) -> L-BFGS 3 (history 4, line search 2) -> metrics. One jitted
function serves the loop check on a 1024-configuration block and the solver
check. Then the PyTorch solver alone on the Franka, and the refusals.
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
from curobo_tpu.opt.lbfgs import LBFGSConfig as JLBFGSConfig
from curobo_tpu.opt.mppi import MPPIConfig as JMPPIConfig
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.robot.kinematics import compute_kinematics as jfk
from curobo_tpu.rollout.robot_rollout import Goal as JGoal
from curobo_tpu.solver.ik import IKConfig as JIKConfig
from curobo_tpu.solver.ik import IKSolver as JIKSolver
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.ops import ik_kernels as ikk
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig
from curobo_tpu_torch.opt.mppi import MPPIConfig

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")
WARMUP, WARMUP_HIST, LBFGS, HIST, LS = 4, 6, 3, 4, 2


def _scene(mod):
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        mod.SphereObstacle(name="ball", pose=[0.35, 0.2, 0.45, 1, 0, 0, 0], radius=0.08),
    )


@pytest.fixture(scope="module")
def ur10e():
    """Both packages' UR10e + world, and the JAX stage composition, compiled
    once: solve_blocks(goal7 (N, 7), q0 (N, D)) -> (x, cost, pe, re, fe)."""
    from curobo_tpu.ops.pallas_ik import BLK, LANE, SUB, PallasIKCost, pack_world_arrays

    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "ur10e.yml"))
    wj = jwm.compile_scene(_scene(jgt))
    jcfg = JIKConfig(
        n_seeds=8, warmup_iters=WARMUP, use_particle_stage=False,
        lbfgs=JLBFGSConfig(history=HIST, n_iters=LBFGS), kernel_linesearch=LS,
    )
    pik = PallasIKCost(kj.params, jcfg.rollout, wj)
    refs = pack_world_arrays(wj)
    D = kj.n_dof

    @jax.jit
    def block(goal_blk, q_blk):
        cost_fn, cost_grad, pose_cost_fn, metrics_fn = pik._cost_fns(
            refs, goal_blk, pik._D_pair, pik._margin
        )
        clip_q = pik._clip_q_fn()
        x, _ = pik._lbfgs_loop(pose_cost_fn, clip_q, q_blk, WARMUP, WARMUP_HIST, 1.0, LS, 1.5, 0.45)
        bx, _ = pik._lbfgs_loop(cost_fn, clip_q, x, LBFGS, HIST, 1.0, LS, 1.5, 0.45,
                                cost_grad=cost_grad)
        return (bx,) + tuple(metrics_fn(bx))

    def solve_blocks(goal7, q0, seed=None, world=None):
        N = q0.shape[0]
        assert N <= BLK
        qp = jnp.zeros((BLK, D), jnp.float32).at[:N].set(q0)
        gp = jnp.zeros((BLK, 7), jnp.float32).at[:N].set(goal7).at[N:, 3].set(1.0)
        q_blk = jnp.moveaxis(qp.reshape(SUB, LANE, D), -1, 0)
        g_blk = jnp.moveaxis(gp.reshape(SUB, LANE, 7), -1, 0)
        x, c, pe, re, fe = block(g_blk, q_blk)
        flat = lambda a: a.reshape(BLK)[:N]
        return jnp.moveaxis(x, 0, -1).reshape(BLK, D)[:N], flat(c), flat(pe), flat(re), flat(fe)

    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    wt = ct.compile_scene(_scene(tgt), device="cpu")
    tcfg = ct.IKConfig(
        n_seeds=8, warmup_iters=WARMUP, use_particle_stage=False,
        lbfgs=LBFGSConfig(history=HIST, n_iters=LBFGS), kernel_linesearch=LS,
    )
    return dict(kj=kj, wj=wj, jcfg=jcfg, kt=kt, wt=wt, tcfg=tcfg, solve_blocks=solve_blocks,
                BLK=BLK, D=D)


def test_warmup_and_lbfgs_loops_match_jax_on_a_block(ur10e):
    u = ur10e
    N, D = u["BLK"], u["D"]
    rng = np.random.RandomState(3)
    q0 = rng.uniform(-1.5, 1.5, (N, D)).astype(np.float32)
    qg = rng.uniform(-1.5, 1.5, (N, D)).astype(np.float32)
    st = jfk(u["kj"].params, jnp.asarray(qg))
    goal7 = np.concatenate(
        [np.asarray(st.tool_pose.position[:, 0]), np.asarray(st.tool_pose.quaternion[:, 0])], -1
    )
    xj, cj, pej, rej, fej = (np.asarray(a) for a in u["solve_blocks"](jnp.asarray(goal7), jnp.asarray(q0)))

    ikc = ikk.IKCost(u["kt"].params, u["tcfg"].rollout)
    budget = ikk.IKSolveBudget(mppi_iters=0, lbfgs_iters=LBFGS, history=HIST, n_linesearch=LS,
                               warmup_iters=WARMUP, warmup_history=WARMUP_HIST)
    xt, ct_, pet, ret, fet = ikk.ik_solve_plain(
        ikc.tables, ikk.pack_world_arrays(u["wt"]), torch.as_tensor(goal7), torch.as_tensor(q0), budget
    )
    # the loops are held loosely: a strict `<` in the line search can flip on
    # a rounding difference and the two runs then part; a wrong history slot
    # or step rule would move most configurations, not 5 %
    rel = np.abs(ct_.numpy() - cj) / (np.abs(cj) + 1e-2)
    assert np.median(rel) < 1e-3
    agree = np.abs(xt.numpy() - xj).max(axis=-1) < 1e-3
    assert agree.mean() >= 0.95
    np.testing.assert_allclose(pet.numpy()[agree], pej[agree], atol=2e-3)
    assert np.mean((fet.numpy() > 0.5)[agree] == (fej > 0.5)[agree]) >= 0.99
    # the stages did work: seven iterations took most of the cost away
    c0 = ikc.cost_only(torch.as_tensor(goal7), torch.as_tensor(q0), u["wt"])
    assert float(ct_.mean()) < 0.3 * float(c0.mean())


def test_solve_pose_matches_jax_solver(ur10e):
    u = ur10e
    B, S, D = 8, 8, u["D"]
    rng = np.random.RandomState(5)
    qg = rng.uniform(-1.2, 1.2, (B, D)).astype(np.float32)
    st = jfk(u["kj"].params, jnp.asarray(qg))
    pos, quat = np.asarray(st.tool_pose.position[:, 0]), np.asarray(st.tool_pose.quaternion[:, 0])

    js = JIKSolver(u["kj"].params, u["jcfg"])
    seeds_j = js.generate_seeds(B)
    rj = js._solve_impl_pallas(
        u["wj"].anonymized(), JGoal.from_pose(JPose(jnp.asarray(pos), jnp.asarray(quat))),
        seeds_j, jax.random.PRNGKey(0), solve_kernel=u["solve_blocks"],
    )
    ts = ct.IKSolver(u["kt"].params, u["tcfg"], device="cpu")
    seeds_t = ts.generate_seeds(B)
    rt = ts.solve_pose(u["wt"], ct.Pose(torch.as_tensor(pos), torch.as_tensor(quat)))

    assert np.array_equal(seeds_t.numpy(), np.asarray(seeds_j))  # Halton seeds, bit for bit
    assert rt.seed_solutions.shape == (B, S, D) and rt.solution.shape == (B, D)
    ss_j, ss_t = np.asarray(rj.seed_success), rt.seed_success.numpy()
    assert (ss_j == ss_t).mean() >= 0.95
    # per-problem success: equal wherever both packages' best seeds converge
    # with a margin (half the thresholds), where no rounding can flip it
    clear_j = (np.asarray(rj.position_error) < 0.0025) & (np.asarray(rj.rotation_error) < 0.025)
    clear_t = (rt.position_error.numpy() < 0.0025) & (rt.rotation_error.numpy() < 0.025)
    both = clear_j & clear_t & np.asarray(rj.success) & rt.success.numpy()
    assert np.array_equal(np.asarray(rj.success)[both], rt.success.numpy()[both])
    assert abs(float(ss_j.mean()) - float(ss_t.mean())) <= 0.05
    ok = rt.success.numpy()
    assert (rt.position_error.numpy()[ok] < 0.005).all()
    # the selected solution is one of the seeds, and FK of it reaches the goal
    fk = u["kt"].compute_kinematics(rt.solution).tool_pose.position[:, 0].numpy()
    assert (np.linalg.norm(fk - pos, axis=-1)[ok] < 0.005 + 1e-5).all()


@pytest.fixture(scope="module")
def franka():
    kin = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    world = ct.compile_scene(
        tgt.Scene().add(tgt.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2])),
        device="cpu",
    )
    cfg = ct.IKConfig(
        n_seeds=8, warmup_iters=24, use_particle_stage=False,
        mppi=MPPIConfig(n_particles=4, n_iters=1, init_std=0.6),
        lbfgs=LBFGSConfig(history=10, n_iters=6), kernel_linesearch=4,
    )
    return kin, world, ct.IKSolver(kin.params, cfg, device="cpu")


def test_franka_solve_reaches_collision_free_goals(franka):
    kin, world, solver = franka
    q_goal, ok = ct.RobotSceneCollision(kin.params).sample(world, 4)
    assert bool(ok.all())
    st = kin.compute_kinematics(q_goal)
    goals = ct.Pose(st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0])
    # seed 0 is the provided state: start one seed near each goal's own
    # configuration, the rest are the Halton seeds
    res = solver.solve_pose(world, goals, seed_state=q_goal + 0.2)
    assert bool(res.success.all())
    assert float(res.position_error.max()) < 0.005
    assert bool(ct.RobotSceneCollision(kin.params).validate(world, res.solution).all())
    assert res.seed_success.shape == (4, 8)


def test_unreachable_goal_fails_without_nan(franka):
    kin, world, solver = franka
    far = ct.Pose(torch.tensor([[3.0, 0.0, 0.5]]), torch.tensor([[1.0, 0.0, 0.0, 0.0]]))
    res = solver.solve_pose(world, far)
    assert not bool(res.success.any())
    for name in ("solution", "position_error", "rotation_error", "cost", "seed_solutions"):
        assert torch.isfinite(getattr(res, name)).all(), name


def test_particle_stage_runs_through_the_solver(franka):
    kin, world, _ = franka
    cfg = ct.IKConfig(
        n_seeds=4, warmup_iters=4, mppi=MPPIConfig(n_particles=4, n_iters=2, init_std=0.3),
        lbfgs=LBFGSConfig(history=4, n_iters=2), kernel_linesearch=2,
    )
    solver = ct.IKSolver(kin.params, cfg, device="cpu")
    goal = ct.Pose(torch.tensor([[0.4, 0.1, 0.4]]), torch.tensor([[0.0, 1.0, 0.0, 0.0]]))
    a = solver.solve_pose(world, goal, seed=1)
    b = solver.solve_pose(world, goal, seed=1)
    c = solver.solve_pose(world, goal, seed=2)
    assert torch.equal(a.seed_solutions, b.seed_solutions)
    assert not torch.equal(a.seed_solutions, c.seed_solutions)
    noise = torch.zeros(2, 4, 4, 7)
    assert torch.isfinite(solver.solve_pose(world, goal, noise=noise).cost).all()


@pytest.mark.parametrize("case", ["goal_set", "tool_weight", "goal_cspace", "voxel_world", "use_lm_seed"])
def test_what_the_kernel_route_does_not_serve_raises(franka, case):
    """Goal sets, per-tool weights, c-space goals and worlds with a voxel
    grid leave the kernel route for the generic one, as in the JAX package
    (and give finite results). The LM seed stage is served: it refines the
    seeds and the kernel route runs after it."""
    kin, world, solver = franka
    pos, quat = torch.zeros(2, 3) + 0.3, torch.tensor([[0.0, 1.0, 0, 0]] * 2)
    goal = ct.Goal.from_pose(ct.Pose(pos, quat))
    if case == "voxel_world":
        voxel = ct.compile_scene(tgt.Scene().add(tgt.VoxelGridObstacle(
            name="esdf", pose=[0.4, 0, 0.4, 1, 0, 0, 0], dims=[0.4, 0.4, 0.4], voxel_size=0.1)),
            device="cpu")
        solver._solve_impl_kernel = None  # the kernel route must not run
        try:
            res = solver.solve_pose(voxel, ct.Pose(pos, quat))
        finally:
            del solver._solve_impl_kernel
        assert res.solution.shape == (2, 7)
        for name in ("solution", "position_error", "rotation_error", "cost", "seed_solutions"):
            assert torch.isfinite(getattr(res, name)).all(), name
        return
    if case == "use_lm_seed":
        lm = ct.IKSolver(kin.params, dataclasses.replace(solver.cfg, use_lm_seed=True, lm_seed_iters=3),
                         device="cpu")
        assert lm._seed_ik is not None and lm._use_kernel(goal)
        res = lm.solve_pose(world, ct.Pose(pos, quat))
        assert res.solution.shape == (2, 7)
        for name in ("solution", "position_error", "rotation_error", "cost", "seed_solutions"):
            assert torch.isfinite(getattr(res, name)).all(), name
        return
    if case == "goal_set":
        goal = ct.Goal.from_pose(ct.Pose(pos[:, None, None].expand(2, 3, 1, 3).contiguous(),
                                         quat[:, None, None].expand(2, 3, 1, 4).contiguous()))
    elif case == "tool_weight":
        goal = dataclasses.replace(goal, tool_weight=torch.ones(1, 6))
    else:
        goal = dataclasses.replace(goal, goal_cspace=kin.params.retract_config.expand(2, 7))
    assert solver._use_kernel(ct.Goal.from_pose(ct.Pose(pos, quat)))
    assert not solver._use_kernel(goal)
    res = solver.solve_pose(world, goal)
    assert res.solution.shape == (2, 7)
    for name in ("solution", "position_error", "rotation_error", "cost", "seed_solutions"):
        assert torch.isfinite(getattr(res, name)).all(), name


def test_kernel_supported_goal_never_takes_the_generic_route(franka, monkeypatch):
    kin, world, solver = franka

    def refuse(*a, **k):
        raise AssertionError("the generic route ran")

    monkeypatch.setattr(solver, "_solve_impl", refuse)
    goal = ct.Pose(torch.tensor([[0.4, 0.1, 0.4]]), torch.tensor([[0.0, 1.0, 0.0, 0.0]]))
    assert torch.isfinite(solver.solve_pose(world, goal).cost).all()
    generic = ct.IKSolver(kin.params, dataclasses.replace(solver.cfg, use_pallas=False), device="cpu")
    assert generic._solve_kernel is None and not generic._use_kernel(ct.Goal.from_pose(goal))
    monkeypatch.setattr(generic, "_solve_impl_kernel", refuse)
    assert torch.isfinite(generic.solve_pose(world, goal).cost).all()


def test_goal_set_solve_matches_jax_generic_route(ur10e):
    """Goal-set IK (G = 3) on the UR10e: the PyTorch generic route against the
    JAX `IKSolver._solve_impl` (its RobotRollout objective: blast does not take
    goal sets) with the JAX MPPI signs injected. Success equal on >= 95 % of
    the seeds; where both converge with a margin, the same problems succeed.
    (The seeds' solutions are not held to 1e-3: over 25 L-BFGS iterations a
    line-search tie parts the two runs on about a sixth of them.)"""
    u = ur10e
    B, G, S, D = 8, 3, 6, u["D"]
    jcfg = JIKConfig(n_seeds=S, mppi=JMPPIConfig(n_particles=6, n_iters=2, init_std=0.3),
                     lbfgs=JLBFGSConfig(history=6, n_iters=25))
    tcfg = ct.IKConfig(n_seeds=S, mppi=MPPIConfig(n_particles=6, n_iters=2, init_std=0.3),
                       lbfgs=LBFGSConfig(history=6, n_iters=25))
    rng = np.random.RandomState(8)
    qg = rng.uniform(-1.2, 1.2, (B, G, D)).astype(np.float32)
    st = jfk(u["kj"].params, jnp.asarray(qg))
    pos = np.asarray(st.tool_pose.position[:, :, :1])  # (B, G, 1, 3)
    quat = np.asarray(st.tool_pose.quaternion[:, :, :1])
    js = JIKSolver(u["kj"].params, jcfg)
    key = jax.random.PRNGKey(1)
    seeds = js.generate_seeds(B)
    rj = jax.jit(js._solve_impl)(u["wj"].anonymized(),
                                  JGoal.from_pose(JPose(jnp.asarray(pos), jnp.asarray(quat))),
                                  seeds, key)
    signs = np.array(jax.random.rademacher(key, (B, S, D), dtype=jnp.float32))
    ts = ct.IKSolver(u["kt"].params, tcfg, device="cpu")
    goal = ct.Goal.from_pose(ct.Pose(torch.as_tensor(pos), torch.as_tensor(quat)))
    assert not ts._use_kernel(goal)
    rt = ts._solve_impl(u["wt"], goal, ts.generate_seeds(B), 0, signs=torch.as_tensor(signs))
    ss_j, ss_t = np.asarray(rj.seed_success), rt.seed_success.numpy()
    assert (ss_j == ss_t).mean() >= 0.95
    clear_j = (np.asarray(rj.position_error) < 0.0025) & (np.asarray(rj.rotation_error) < 0.025)
    clear_t = (rt.position_error.numpy() < 0.0025) & (rt.rotation_error.numpy() < 0.025)
    both = clear_j & clear_t
    assert np.array_equal(np.asarray(rj.success)[both], rt.success.numpy()[both])
    assert rt.success.numpy().sum() >= B // 2  # the route solves goal sets
    # a solved problem reaches one of its goals
    fk = u["kt"].compute_kinematics(rt.solution).tool_pose.position[:, 0].numpy()
    near = np.linalg.norm(fk[:, None] - pos[:, :, 0], axis=-1).min(axis=1)
    assert (near[rt.success.numpy()] < 0.005 + 1e-5).all()


def test_solver_without_device_raises_where_there_is_no_card(franka):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    kin, _, _ = franka
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.IKSolver(kin.params)


def test_solver_checks_its_arguments(franka):
    kin, world, solver = franka
    with pytest.raises(ValueError, match="batched"):
        solver.solve_pose(world, ct.Pose(torch.zeros(3), torch.tensor([1.0, 0, 0, 0])))
    with pytest.raises(ValueError, match="seed_state"):
        solver.solve_pose(
            world, ct.Pose(torch.zeros(1, 3), torch.tensor([[1.0, 0, 0, 0]])),
            seed_state=torch.zeros(1, 6),
        )
    assert solver.generate_seeds(3).shape == (3, 8, 7)
    assert solver.generate_seeds(2, n=40).shape == (2, 40, 7)
