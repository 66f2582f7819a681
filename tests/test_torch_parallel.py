"""The one-card device mesh of the PyTorch package (`parallel/mesh.py`) on the
CPU: meshes of a repeated device, the placement of problem slices, and
`solve_ik_sharded` on a ``["cpu"] * 4`` mesh at (dp, sp) in {(1, 2), (2, 2),
(4, 1)} bit-equal to the unsharded solve over the same seeds on the
deterministic path (the kernel route's plain version and the generic route,
no particle stage), as `tests/test_sharding.py` holds the JAX layer; a batch
or a seed count that the mesh does not divide raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu_torch.geom import types as gt
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig, LineSearchConfig
from curobo_tpu_torch.parallel import mesh as mesh_mod
from curobo_tpu_torch.rollout.robot_rollout import Goal

CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module")
def setup():
    kin = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    world = ct.compile_scene(gt.Scene().add(
        gt.Cuboid(name="table", pose=[0.4, 0.0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2])), device="cpu")
    rng = np.random.RandomState(0)
    q = torch.as_tensor(kin.params.retract_config.numpy() + rng.uniform(-0.3, 0.3, (4, 7)),
                        dtype=torch.float32)
    st = kin.compute_kinematics(q)
    goal = Goal.from_pose(ct.Pose(st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0]))
    return kin, world, goal


def _solver(kin, route):
    """A small budget without the particle stage, the deterministic path: the
    kernel route's plain version, or the generic route (``use_pallas=False``)."""
    cfg = ct.IKConfig(
        n_seeds=8, warmup_iters=32, use_particle_stage=False, kernel_linesearch=4,
        use_pallas=route == "kernel",
        lbfgs=LBFGSConfig(history=6, n_iters=12,
                          line_search=LineSearchConfig(scales=(0.05, 0.2, 0.5, 0.8, 1.0, 1.4))))
    return ct.IKSolver(kin.params, cfg, device="cpu")


@pytest.mark.parametrize("route", ["kernel", "generic"])
@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2), (4, 1)])
def test_sharded_solve_is_bit_equal_to_unsharded(setup, route, dp, sp):
    kin, world, goal = setup
    solver = _solver(kin, route)
    seeds = solver.generate_seeds(goal.batch)
    ref = solver._solve_seeds(world, goal, seeds, 0)
    mesh = mesh_mod.make_mesh_2d(dp, sp, CPU4[: dp * sp])
    res = mesh_mod.solve_ik_sharded(solver, world, goal, seeds, torch.Generator().manual_seed(0), mesh)
    assert bool(ref.success.all())  # reachable goals: every winner is a converged seed
    for f in dataclasses.fields(ref):
        a, b = getattr(res, f.name), getattr(ref, f.name)
        assert a.shape == b.shape and a.device == torch.device("cpu"), f.name
        assert torch.equal(a, b), (f.name, (a.float() - b.float()).abs().max())


def test_failed_problem_takes_the_least_position_error(setup):
    """A problem that no seed solves: the JAX rule picks, over the seed
    blocks, the block winner of least position error (1e6 + error)."""
    kin, world, goal = setup
    far = Goal.from_pose(ct.Pose(torch.tensor([[3.0, 0.0, 0.5]] * 2), torch.tensor([[1.0, 0, 0, 0]] * 2)))
    solver = _solver(kin, "kernel")
    seeds = solver.generate_seeds(2)
    res = mesh_mod.solve_ik_sharded(solver, world, far, seeds, None,
                                    mesh_mod.make_mesh_2d(1, 2, CPU4[:2]))
    assert not bool(res.success.any())
    blocks = [solver._solve_seeds(world, far, seeds[:, 4 * j:4 * j + 4], j) for j in range(2)]
    best = torch.stack([b.position_error for b in blocks]).argmin(dim=0)
    for i in range(2):
        assert torch.equal(res.solution[i], blocks[int(best[i])].solution[i])


def test_shape_validation(setup):
    kin, world, goal = setup
    solver = _solver(kin, "kernel")
    seeds = solver.generate_seeds(goal.batch)
    for dp, sp in ((4, 1), (1, 4)):
        bad_seeds = seeds[:3] if dp == 4 else seeds[:, :3]
        bad_goal = dataclasses.replace(goal, goal_pos=goal.goal_pos[: bad_seeds.shape[0]],
                                       goal_quat=goal.goal_quat[: bad_seeds.shape[0]])
        with pytest.raises(ValueError, match="must divide"):
            mesh_mod.solve_ik_sharded(solver, world, bad_goal, bad_seeds, None,
                                      mesh_mod.make_mesh_2d(dp, sp, CPU4))
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh_mod.make_mesh_2d(2, 2, CPU4[:3])


def test_meshes_and_placement():
    m1 = mesh_mod.make_mesh(CPU4)
    assert m1.shape == {"dp": 4} and m1.size == 4 and m1.devices[0] == torch.device("cpu")
    m2 = mesh_mod.make_mesh_2d(2, 2, [["cpu", "cpu"], ["cpu", "cpu"]])
    assert m2.shape == {"dp": 2, "sp": 2}
    tree = {"x": torch.arange(8.0).reshape(4, 2), "odd": torch.arange(3.0), "s": torch.tensor(1.0),
            "name": "keep"}
    parts = mesh_mod.shard_problems(tree, m1)
    assert len(parts) == 4 and parts[0]["name"] == "keep"
    assert torch.equal(torch.cat([p["x"] for p in parts]), tree["x"])
    assert all(torch.equal(p["odd"], tree["odd"]) and torch.equal(p["s"], tree["s"]) for p in parts)
    # over a 2-D mesh: slices along dp, repeated along sp
    parts2 = mesh_mod.shard_problems(tree, m2)
    assert [p["x"].shape[0] for p in parts2] == [2] * 4
    assert torch.equal(parts2[0]["x"], parts2[1]["x"]) and torch.equal(parts2[2]["x"], tree["x"][2:])
    assert all(torch.equal(r["x"], tree["x"]) for r in mesh_mod.replicate(tree, m2))
    assert all(torch.equal(a["x"], b["x"]) for a, b in zip(mesh_mod.global_problems(tree, m1), parts))
    if not torch.cuda.is_available():  # a mesh of the card raises without one
        for call in (lambda: mesh_mod.make_mesh(["cuda:0"] * 2), mesh_mod.make_mesh,
                     lambda: mesh_mod.make_mesh_2d(1, 1)):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
