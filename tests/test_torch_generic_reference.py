"""The JAX package's own CPU result on the problems of the `generic` phase of
`chip_smoke.py`, which sets that phase's success gate (this result less 0.1):

- goal-set IK: 32 goals of 4 poses each, FK of the first 128 collision-free
  Halton configurations of the Franka over one table cuboid
  (`RobotSceneCollision.sample`), the default `IKConfig()` with 32 seeds;
- `plan_cspace` on every 6th problem of `content/problems/franka_motion.json`
  (15 problems: 7 tabletop, 7 shelf, 1 cubby) with the default
  `MotionPlanConfig()`, from the problem's start to its stored goal
  configuration `q_goal_oracle` (an IK solution of its goal pose, 7e-7 m
  off); on the JAX side its trajectory solve over `RobotRollout` (see
  `jax_cspace_reference`).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_generic_reference.py [ik] [cspace]

prints one JSON line (minutes on a CPU: the JAX objectives compile for the
Franka). The tests below only check the problem builders, which
`chip_smoke.py` repeats on the card.
"""

import json
import os
import time

import numpy as np
import torch

import curobo_tpu_torch as ct
from curobo_tpu_torch.geom import types as tgt

N_GOALS, GOAL_SET = 32, 4
CSPACE_EVERY = 6
IK_CHUNK = 4


def table_scene(mod=tgt):
    return mod.Scene().add(
        mod.Cuboid(name="table", pose=[0.4, 0.0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2])
    )


def goal_set_problems(kin, world):
    """(position (32, 4, 1, 3), quaternion (32, 4, 1, 4)) numpy: FK of the
    first 128 collision-free Halton configurations."""
    q, ok = ct.RobotSceneCollision(kin.params).sample(world, N_GOALS * GOAL_SET)
    assert bool(ok.all()), "too few collision-free configurations"
    tp = kin.compute_kinematics(q).tool_pose
    pos = tp.position[:, 0].reshape(N_GOALS, GOAL_SET, 1, 3)
    quat = tp.quaternion[:, 0].reshape(N_GOALS, GOAL_SET, 1, 4)
    return pos.cpu().numpy(), quat.cpu().numpy()


def cspace_problems(suite):
    return suite["problems"][::CSPACE_EVERY]


def _suite():
    with open(ct.content_path("problems", "franka_motion.json")) as fh:
        return json.load(fh)


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from curobo_tpu.robot.kinematics import Kinematics as JKin

    robots = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")
    return jax, JKin.from_robot_yaml(os.path.join(robots, "franka.yml"))


def jax_ik_reference() -> dict:
    jax, kj = _jax()
    import jax.numpy as jnp

    from curobo_tpu.geom import types as jgt
    from curobo_tpu.geom import world as jwm
    from curobo_tpu.solver.ik import IKSolver as JIKSolver
    from curobo_tpu.types.pose import Pose as JPose

    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    pos, quat = goal_set_problems(kt, ct.compile_scene(table_scene(), device="cpu"))
    ik = JIKSolver(kj.params)
    wj = jwm.compile_scene(table_scene(jgt))
    t0 = time.perf_counter()
    # in chunks of IK_CHUNK goals: the whole batch's XLA program takes tens
    # of GB on a CPU; each goal's solve is its own (seeds and signs per goal)
    ok = []
    for i in range(0, N_GOALS, IK_CHUNK):
        sl = slice(i, i + IK_CHUNK)
        res = ik.solve_pose(wj, JPose(jnp.asarray(pos[sl]), jnp.asarray(quat[sl])),
                            key=jax.random.PRNGKey(i))
        ok.append(np.asarray(res.success))
    return dict(ik_goal_set_success=float(np.concatenate(ok).mean()),
                ik_goal_set_seconds=time.perf_counter() - t0)


def jax_cspace_reference() -> dict:
    """`MotionPlanner.plan_cspace`'s trajectory solve (`TrajOptSolver.
    solve_cspace`, whose success the plan returns) with the default
    `MotionPlanConfig()`, on the JAX package's `RobotRollout` objective: the
    goal carries neutral per-tool criteria (weights 1, tolerances 0, which
    leave the objective unchanged), so `_traj_rollout` does not take blast,
    whose Franka trajectory program grew past 24 GB while compiling on a
    CPU. Blast and RobotRollout agree (`tests/test_torch_rollout.py`)."""
    jax, kj = _jax()
    import jax.numpy as jnp

    from curobo_tpu.geom import types as jgt
    from curobo_tpu.geom import world as jwm
    from curobo_tpu.motion.planner import MotionPlanConfig as JPlanConfig
    from curobo_tpu.robot.kinematics import compute_kinematics as jfk
    from curobo_tpu.rollout.robot_rollout import Goal as JGoal
    from curobo_tpu.solver.trajopt import TrajOptSolver as JTrajOpt
    from curobo_tpu.types.pose import Pose as JPose
    from curobo_tpu.types.tool_pose import ToolPoseCriteria as JCriteria

    suite = _suite()
    trajopt = JTrajOpt(kj.params, JPlanConfig().trajopt)
    rows = []
    t0 = time.perf_counter()
    for p in cspace_problems(suite):
        w = jwm.compile_scene(jgt.Scene().add(*[jgt.Cuboid(**o) for o in p["world"]["cuboids"]]),
                              capacities={"cuboid": suite["cuboid_capacity"]})
        q_goal = jnp.asarray([p["q_goal_oracle"]])
        tp = jfk(kj.params, q_goal).tool_pose
        goal = JGoal.from_pose(JPose(tp.position[:, 0], tp.quaternion[:, 0]),
                               criteria=[JCriteria()])
        goal = goal.__class__(**{**goal.__dict__, "goal_cspace": q_goal})
        r = trajopt._solve(w, goal, jnp.asarray([p["q_start"]]), q_goal[:, None],
                           jax.random.PRNGKey(0))
        rows.append(dict(scenario=p["scenario"], success=bool(r.success[0]),
                         motion_time=float(r.motion_time[0])))
    return dict(plan_cspace_success=float(np.mean([r["success"] for r in rows])),
                plan_cspace_seconds=time.perf_counter() - t0, plan_cspace_rows=rows)


def test_goal_set_problems_are_collision_free_fk_goals():
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    pos, quat = goal_set_problems(kt, ct.compile_scene(table_scene(), device="cpu"))
    assert pos.shape == (N_GOALS, GOAL_SET, 1, 3) and quat.shape == (N_GOALS, GOAL_SET, 1, 4)
    np.testing.assert_allclose(np.linalg.norm(quat, axis=-1), 1.0, atol=1e-5)
    assert len({tuple(np.round(p, 6)) for p in pos.reshape(-1, 3)}) == N_GOALS * GOAL_SET


def test_cspace_problems_span_the_scenarios_and_hold_ik_goals():
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    probs = cspace_problems(_suite())
    assert len(probs) == 15 and {p["scenario"] for p in probs} == {"tabletop", "shelf", "cubby"}
    q = torch.tensor([p["q_goal_oracle"] for p in probs])
    goal = torch.tensor([p["goal_pose"][:3] for p in probs])
    err = (kt.compute_kinematics(q).tool_pose.position[:, 0] - goal).norm(dim=-1)
    assert float(err.max()) < 1e-5


if __name__ == "__main__":
    import sys

    parts = sys.argv[1:] or ["ik", "cspace"]
    out = dict(reference="JAX package on the CPU")
    if "ik" in parts:
        out.update(jax_ik_reference())
    if "cspace" in parts:
        out.update(jax_cspace_reference())
    print(json.dumps(out), flush=True)
