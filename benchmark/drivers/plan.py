"""Motion generation: one `MotionPlanner.plan_pose` at a time (B = 1) over
the problems of the configuration's suite, each ending with the
interpolated trajectory on the host.

The problems come in whole permutations drawn from the seed, so that each
appears equally often; each plan's own seed (its IK sampling) follows from
its problem and permutation, so that every run plans the same set in
another order. Traffic keys: `permutations` (made at set-up), `check_plans`
(plans judged by the reference, drawn from the seed), `trace_calls`.
Configuration keys: `robot`, `suite` (problems with their worlds),
`n_problems` (a prefix of the suite, where given), `planner` (the
`MotionPlanConfig` fields that differ from its defaults), `limits.plan`.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.harness import Check
from benchmark.reference import checks, goals
from benchmark.reference.robot import Robot


def plan_order(seed: int, n: int, permutations: int):
    """The problems in whole permutations drawn from the seed, and each
    plan's own seed (its IK sampling): the k-th permutation plans problem p
    with seed k * n + p whatever the run's seed, so that every run holds the
    same plans, and so the same retries, in another order."""
    rng = goals.rng_of(seed, 0)
    order = np.concatenate([rng.permutation(n) for _ in range(permutations)])
    return order, np.repeat(np.arange(permutations), n) * n + order


def suite_worlds(suite: Dict) -> List[List[Dict]]:
    return [[dict(type="cuboid", **o) for o in p["world"]["cuboids"]] for p in suite["problems"]]


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        import curobo_tpu_torch as ct
        from curobo_tpu_torch.util.config_io import dataclass_from_dict

        self.ct, self.device, self.seed = ct, device, seed
        self.config, self.traffic = config, traffic
        self.robot_path = common.data_path(config, "robot")
        with open(common.data_path(config, "suite")) as fh:
            self.suite = json.load(fh)
        self.problems = self.suite["problems"][: int(config.get("n_problems", len(self.suite["problems"])))]
        self.obstacles = suite_worlds(self.suite)
        self.cfg = dataclass_from_dict(ct.MotionPlanConfig, config.get("planner", {}))
        kin = ct.Kinematics.from_robot_yaml(self.robot_path, device=device)
        cap = {"cuboid": int(self.suite["cuboid_capacity"])}
        self.worlds = [ct.compile_scene(common.program_scene(w), capacities=cap, device=device)
                       for w in self.obstacles[: len(self.problems)]]
        f32 = dict(dtype=torch.float32, device=device)
        self.goal = torch.tensor([p["goal_pose"] for p in self.problems], **f32)
        self.start = torch.tensor([p["q_start"] for p in self.problems], **f32)
        self.joint_names = kin.joint_names
        self.planner = ct.MotionPlanner(kin.params, self.cfg, device=device)
        self.order, self.plan_seeds = plan_order(seed, len(self.problems), int(traffic["permutations"]))
        self.records: List[Dict] = []
        self.i = 0

    def _plan(self, p: int, seed: int, goal=None):
        ct = self.ct
        g = self.goal[p:p + 1] if goal is None else goal
        res = self.planner.plan_pose(
            self.worlds[p], ct.Pose(g[:, :3], g[:, 3:]),
            ct.JointState.from_position(self.start[p:p + 1], self.joint_names), seed=int(seed))
        return res, res.trajectory.position.cpu()

    def warmup(self):
        """Both attempts' shapes: two first-attempt plans and one unreachable
        goal, which retries with more IK seeds, more trajectory seeds and
        PRM."""
        for p in range(2):
            self._plan(p, 1000 + p)
        far = self.goal[:1].clone()
        far[0, :3] = 2.5
        self._plan(0, 999, goal=far)
        if self.planner.last_attempts != self.cfg.max_attempts:
            raise RuntimeError("the warm-up's unreachable goal did not take every attempt")

    def call(self):
        k = self.i % len(self.order)
        self.i += 1
        p = int(self.order[k])
        res, traj = self._plan(p, self.plan_seeds[k])
        self.records.append(dict(problem=p, attempts=self.planner.last_attempts, res=res,
                                 interp_start=traj[0, 0]))

    def attempted_failed(self):
        ok = sum(bool(r["res"].success[0]) if "res" in r else r["success"] for r in self.records)
        return len(self.records), len(self.records) - ok

    def release(self):
        for r in self.records:
            res, st = r["res"], r["res"].solver_trajectory
            r.update(success=bool(res.success[0]), pe=float(res.position_error[0]),
                     re=float(res.rotation_error[0]),
                     **{k: getattr(st, k)[0].cpu() for k in ("position", "velocity", "acceleration", "jerk")})
            del r["res"]
        self.planner = self.worlds = None

    def numbers(self, control: bool = False) -> Dict:
        dev = self.device
        robot = Robot(self.robot_path, device=dev)
        pick = common.sample(goals.rng_of(self.seed, 1), len(self.records),
                             int(self.traffic["check_plans"]))
        recs = [self.records[i] for i in pick]
        world_of = [r["problem"] for r in recs]
        stack = lambda k: torch.stack([r[k] for r in recs]).to(dev).double()
        pos = stack("position")
        goal = self.goal.double().to(dev)[world_of]
        gp, gq = goal[:, :3], goal[:, 3:]
        lim = dict(velocity=robot.velocity, acceleration=robot.acceleration, jerk=robot.jerk)
        derivs = {k: (stack(k), lim[k]) for k in lim}
        thr = common.thresholds(self.cfg.trajopt)
        success = torch.tensor([r["success"] for r in recs], device=dev)
        pe = torch.tensor([r["pe"] for r in recs], device=dev)
        re = torch.tensor([r["re"] for r in recs], device=dev)
        interp = torch.stack([r["interp_start"] for r in recs]).to(dev)
        if control:
            pos, pe, re, success, derivs = checks.trajectory_control(
                robot, self.obstacles, world_of, pos, gp, gq, thr, derivs)
            interp = interp.to(torch.bfloat16)
        out = checks.trajectory_numbers(robot, self.obstacles, world_of, self.start.double().to(dev)[world_of],
                                        pos, gp, gq, pe, re, success, thr, derivs, extra_start=interp)
        if control:
            out["unsolved_share"] = 1.0 - float(success.float().mean())
        else:
            n, failed = len(self.records), sum(not r["success"] for r in self.records)
            out["unsolved_share"] = failed / max(n, 1)
        return out

    def check(self, control: bool = False) -> List[Check]:
        lim = self.config["limits"]["plan"]
        out = self.numbers(control)
        return [Check(k, out[k], float(lim[k])) for k in ("answer_gap", "unsolved_share")]
