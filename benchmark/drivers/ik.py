"""Collision-free IK: batches of goals through `IKSolver.solve_pose`, one call
at a time, each ending with the solutions and their metrics on the host.

Traffic keys: `batch` (goals a call), `pool_batches` (distinct batches made
at set-up and cycled; the solver keeps nothing between calls),
`check_calls` (calls whose answers the reference judges, drawn from the
seed), `trace_calls`. Configuration keys: `robot`, `scene`, `ik` (the
`IKConfig` fields that differ from its defaults), `limits.ik`.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.drivers import common
from benchmark.harness import Check
from benchmark.reference import checks, goals
from benchmark.reference.robot import Robot


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        import curobo_tpu_torch as ct
        from curobo_tpu_torch.util.config_io import dataclass_from_dict

        self.ct, self.device, self.seed = ct, device, seed
        self.config, self.traffic = config, traffic
        self.obstacles = config["scene"]
        path = common.data_path(config, "robot")
        self.cfg = dataclass_from_dict(ct.IKConfig, config.get("ik", {}))
        B, n = int(traffic["batch"]), int(traffic["pool_batches"])
        # goals: tool poses of collision-free configurations, made by the reference
        ref = Robot(path)
        q = goals.collision_free(ref, self.obstacles, B * n, goals.rng_of(seed, 0))
        pos, quat = ref.tool_pose(q)
        self.goal_pos = pos.float().reshape(n, B, 3).to(device)
        self.goal_quat = quat.float().reshape(n, B, 4).to(device)
        kin = ct.Kinematics.from_robot_yaml(path, device=device)
        self.world = ct.compile_scene(common.program_scene(self.obstacles), device=device)
        self.solver = ct.IKSolver(kin.params, self.cfg, device=device)
        self.robot_path = path
        self.records: List = []
        self.i = 0

    def warmup(self):
        for _ in range(2):
            self.call()
        self.records, self.i = [], 0

    def call(self):
        k = self.i % self.goal_pos.shape[0]
        self.i += 1
        res = self.solver.solve_pose(self.world, self.ct.Pose(self.goal_pos[k], self.goal_quat[k]))
        out = torch.cat([res.solution, res.success[:, None].float(), res.position_error[:, None],
                         res.rotation_error[:, None]], dim=1).cpu()
        self.records.append((k, out))

    def attempted_failed(self):
        n = sum(r.shape[0] for _, r in self.records)
        solved = sum(int(r[:, -3].sum()) for _, r in self.records)
        return n, n - solved

    def release(self):
        self.solver = self.world = None
        self.goal_pos, self.goal_quat = self.goal_pos.cpu(), self.goal_quat.cpu()

    def answers(self):
        """The judged sample: goal positions, quaternions and answer rows."""
        pick = common.sample(goals.rng_of(self.seed, 1), len(self.records),
                             int(self.traffic["check_calls"]))
        ks = [self.records[i][0] for i in pick]
        rows = torch.cat([self.records[i][1] for i in pick])
        return torch.cat([self.goal_pos[k] for k in ks]), torch.cat([self.goal_quat[k] for k in ks]), rows

    def numbers(self, control: bool = False) -> Dict:
        dev = self.device
        robot = Robot(self.robot_path, device=dev)
        gp, gq, rows = self.answers()
        gp, gq, rows = gp.to(dev).double(), gq.to(dev).double(), rows.to(dev).double()
        D = robot.n_dof
        q, success, pe, re = rows[:, :D], rows[:, D] > 0.5, rows[:, D + 1], rows[:, D + 2]
        thr = common.thresholds(self.cfg)
        if control:
            q, pe, re, success = checks.ik_control(robot, self.obstacles, q, gp, gq, thr)
        out = checks.ik_numbers(robot, self.obstacles, q, gp, gq, pe, re, success, thr)
        if control:
            out["unsolved_share"] = 1.0 - out["solved_share"]
        else:
            n, failed = self.attempted_failed()
            out["unsolved_share"] = failed / max(n, 1)
        return out

    def check(self, control: bool = False) -> List[Check]:
        lim = self.config["limits"]["ik"]
        out = self.numbers(control)
        return [Check(k, out[k], float(lim[k])) for k in ("answer_gap", "unsolved_share")]
