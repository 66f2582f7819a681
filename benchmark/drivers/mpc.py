"""Model-predictive control: episodes of blocking `MPCSolver.step` calls
(B = 1), each ending with the command on the host; the command is fed back
as the next measured joint state.

An episode starts at the retract configuration; its goal is the tool pose
of the retract plus a seeded offset on each joint (a magnitude drawn from
`offset_rad`, a random sign, clamped to the limits), worked out by the
reference. One obstacle (`moving.name`) moves by `moving.step` a tick from
its pose in the configuration's `mpc_scene`. Traffic keys: `episode_ticks`,
`pool_episodes` (goals made at set-up, cycled), `offset_rad`, `moving`,
`check_ticks` (ticks judged by the reference, drawn from the seed),
`trace_calls`. Configuration keys: `robot`, `mpc` (the task YAML, which
must load equal to the default `MPCConfig()` unless `mpc_overrides` is
given), `mpc_scene`, `limits.mpc`.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import torch

from benchmark.drivers import common
from benchmark.harness import Check
from benchmark.reference import checks, goals
from benchmark.reference.robot import Robot, pose_errors


def tick_worlds(config: Dict, traffic: Dict) -> List[List[Dict]]:
    """The world specification of each tick of an episode."""
    mv = traffic["moving"]
    out = []
    for t in range(int(traffic["episode_ticks"])):
        w = copy.deepcopy(config["mpc_scene"])
        for o in w:
            if o["name"] == mv["name"]:
                o["pose"] = [o["pose"][i] + t * mv["step"][i] for i in range(3)] + o["pose"][3:]
        out.append(w)
    return out


def episode_goals(ref: Robot, traffic: Dict, seed: int) -> torch.Tensor:
    """The goal configurations (pool_episodes, D) of the episodes: the
    retract plus a seeded offset on each joint, clamped to the limits."""
    rng = goals.rng_of(seed, 0)
    n, D = int(traffic["pool_episodes"]), ref.n_dof
    lo, hi = traffic["offset_rad"]
    off = rng.uniform(lo, hi, (n, D)) * rng.choice([-1.0, 1.0], (n, D))
    return torch.minimum(torch.maximum(ref.retract + torch.as_tensor(off), ref.lower), ref.upper)


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        import curobo_tpu_torch as ct
        from curobo_tpu_torch.util.config_io import dataclass_from_dict

        self.ct, self.device, self.seed = ct, device, seed
        self.config, self.traffic = config, traffic
        self.robot_path = common.data_path(config, "robot")
        cfg = ct.MPCConfig.from_yaml(common.data_path(config, "mpc"))
        if "mpc_overrides" in config:
            cfg = dataclass_from_dict(cfg, config["mpc_overrides"])
        elif cfg != ct.MPCConfig():
            raise ValueError("the MPC task YAML does not load equal to the default MPCConfig()")
        self.cfg = cfg
        self.ticks = int(traffic["episode_ticks"])
        self.obstacles = tick_worlds(config, traffic)
        kin = ct.Kinematics.from_robot_yaml(self.robot_path, device=device)
        self.worlds = [ct.compile_scene(common.program_scene(w), device=device) for w in self.obstacles]
        ref = Robot(self.robot_path)
        n = int(traffic["pool_episodes"])
        pos, quat = ref.tool_pose(episode_goals(ref, traffic, seed))
        self.goal_pos, self.goal_quat = pos.float(), quat.float()
        self.goals = [ct.Goal.from_pose(ct.Pose(pos[i:i + 1].float().to(device),
                                                quat[i:i + 1].float().to(device))) for i in range(n)]
        self.q0 = ref.retract.float()[None].to(device)
        self.joint_names = kin.joint_names
        self.solver = ct.MPCSolver(kin.params, cfg, device=device)
        self.records: List[Dict] = []
        self.episode, self.tick = -1, self.ticks

    def before_call(self):
        """A new episode where the last one ended: the state at the retract,
        held (not timed: the tick's latency is `step` alone)."""
        if self.tick < self.ticks:
            return
        self.episode += 1
        self.tick = 0
        self.state = self.solver.setup(self.q0)
        self.js = self.ct.JointState.from_position(self.q0, self.joint_names)

    def call(self):
        e = self.episode % len(self.goals)
        q_meas = self.js.position
        res, self.state = self.solver.step(self.worlds[self.tick], self.goals[e], self.state, self.js)
        cmd = res.command
        torch.cat([cmd.position, cmd.velocity], dim=-1).cpu()
        self.js = self.ct.JointState(position=cmd.position, velocity=cmd.velocity,
                                     acceleration=cmd.acceleration, joint_names=self.joint_names)
        self.records.append(dict(episode=self.episode, goal=e, tick=self.tick, q=q_meas, res=res))
        self.tick += 1

    def warmup(self):
        for _ in range(3):
            self.before_call()
            self.call()
        self.records, self.episode, self.tick = [], -1, self.ticks

    def attempted_failed(self):
        bad = sum(not (bool(r["res"].feasible[0]) if "res" in r else r["feasible"]) for r in self.records)
        return len(self.records), bad

    def release(self):
        for r in self.records:
            res = r.pop("res")
            r.update(feasible=bool(res.feasible[0]), pe=float(res.pos_err[0]), re=float(res.rot_err[0]),
                     plan=res.plan.position[0].cpu(), command=res.command.position[0].cpu(),
                     q=r["q"][0].cpu())
        self.solver = self.worlds = self.goals = self.state = self.js = None

    def progress(self, robot: Robot, pos: torch.Tensor, goal_idx: List[int], claimed: torch.Tensor) -> float:
        """Median over the ticks that claim a feasible plan of the tool's
        distance to the goal at the plan's end over its distance at the
        plan's start: 1 for a plan that holds still."""
        dev = robot.device
        pos = pos[claimed]
        if not pos.shape[0]:
            return float("nan")
        e = [g for g, c in zip(goal_idx, claimed.tolist()) if c]
        gp, gq = self.goal_pos[e].to(dev).double(), self.goal_quat[e].to(dev).double()
        pe_end, _ = pose_errors(*robot.tool_pose(pos[:, -1]), gp, gq)
        pe_0, _ = pose_errors(*robot.tool_pose(pos[:, 0]), gp, gq)
        return float(torch.median(pe_end / pe_0.clamp_min(1e-9)))

    def numbers(self, control: bool = False) -> Dict:
        dev = self.device
        robot = Robot(self.robot_path, device=dev)
        pick = common.sample(goals.rng_of(self.seed, 1), len(self.records),
                             int(self.traffic["check_ticks"]))
        recs = [self.records[i] for i in pick]
        world_of = [r["tick"] for r in recs]
        pos = torch.stack([r["plan"] for r in recs]).to(dev).double()
        command = torch.stack([r["command"] for r in recs]).to(dev).double()
        q_start = torch.stack([r["q"] for r in recs]).to(dev).double()
        e = [r["goal"] for r in recs]
        gp, gq = self.goal_pos[e].to(dev).double(), self.goal_quat[e].to(dev).double()
        thr = dict(position=float("inf"), rotation=float("inf"))  # a tick claims no pose
        feasible = torch.tensor([r["feasible"] for r in recs], device=dev)
        pe = torch.tensor([r["pe"] for r in recs], device=dev)
        re = torch.tensor([r["re"] for r in recs], device=dev)
        if control:
            pos, pe, re, feasible, _ = checks.trajectory_control(robot, self.obstacles, world_of, pos,
                                                                 gp, gq, thr)
            command = command.to(torch.bfloat16).double()
        out = checks.trajectory_numbers(robot, self.obstacles, world_of, q_start, pos, gp, gq, pe, re,
                                        feasible, thr, command=command)
        out["plan_progress"] = self.progress(robot, pos, e, feasible.bool())
        return out

    def check(self, control: bool = False) -> List[Check]:
        lim = self.config["limits"]["mpc"]
        out = self.numbers(control)
        return [Check(k, out[k], float(lim[k])) for k in ("answer_gap", "plan_progress")]
