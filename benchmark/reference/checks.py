"""What decides `correct`: the plain reference judges the answers that the
timed path returned, layer by layer, in float64.

Each answer is judged by what it says:
- the pose errors it reports against the reference's forward kinematics of
  the configuration (or terminal waypoint) it returns;
- where it reports success (IK, plans) or feasibility (MPC ticks), the
  reference's own verdict: tool pose within the position and rotation
  thresholds, no sphere inside an obstacle and no self-collision pair closer
  than its margin at any returned configuration or waypoint, joint values
  within the limits (the program's 1e-4 rad tolerance), and for plans the
  velocities, accelerations and jerks within the configuration's limits;
- for trajectories, their start at the start state (an MPC tick that claims
  no feasible plan returns a braking plan, which starts a step on), and an
  MPC command equal to the second waypoint of its plan.

`answer_gap` is the largest of these gaps and excesses over the answers
judged (metres, radians, or shares of a limit). The control takes the
program's place with the reference computed in bfloat16: its answers are the
same configurations and waypoints rounded to bfloat16, its pose errors and
verdicts worked out in bfloat16.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference import scene
from benchmark.reference.robot import F64, Robot, pose_errors

CHUNK = 4096


def _chunks(n: int, size: int = CHUNK):
    for i in range(0, n, size):
        yield slice(i, min(n, i + size))


def configuration_report(robot: Robot, obstacles: List[Dict], q: torch.Tensor,
                         goal_pos: torch.Tensor, goal_quat: torch.Tensor, dtype=F64) -> Dict:
    """Per configuration (N, D): the tool's pose errors against its goal, the
    least clearance to the obstacles, the least self-collision slack and the
    joint-limit excess, computed in `dtype`, returned in float64."""
    out = {k: [] for k in ("pe", "re", "clear", "slack", "limit")}
    for s in _chunks(q.shape[0]):
        qs = q[s].to(dtype)
        pos, quat = robot.tool_pose(qs, dtype=dtype)
        pe, re = pose_errors(pos, quat, goal_pos[s].to(dtype), goal_quat[s].to(dtype))
        c = robot.spheres(qs, dtype=dtype)
        out["pe"].append(pe.double())
        out["re"].append(re.double())
        out["clear"].append(scene.clearance(c, robot.sphere_radius.to(dtype), obstacles).double())
        out["slack"].append(robot.self_slack(c).double())
        out["limit"].append(robot.limit_excess(qs.double()))
    return {k: torch.cat(v) for k, v in out.items()}


def verdict(rep: Dict, thr: Dict) -> torch.Tensor:
    """Success by the reference's criteria on a report."""
    return ((rep["pe"] <= thr["position"]) & (rep["re"] <= thr["rotation"])
            & (rep["clear"] >= 0) & (rep["slack"] >= 0) & (rep["limit"] <= 0))


def claim_excess(rep: Dict, thr: Dict) -> torch.Tensor:
    """How far each configuration misses the success criteria (<= 0 where it
    meets them)."""
    return torch.stack([rep["pe"] - thr["position"], rep["re"] - thr["rotation"], -rep["clear"],
                        -rep["slack"], rep["limit"]]).amax(0)


def _max(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


# ---------------------------------------------------------------------------
# IK answers
# ---------------------------------------------------------------------------
def ik_control(robot, obstacles, q, goal_pos, goal_quat, thr):
    """The control's answers: the configurations in bfloat16, with pose
    errors and success worked out in bfloat16."""
    qc = q.to(torch.bfloat16).double()
    rep = configuration_report(robot, obstacles, qc, goal_pos, goal_quat, dtype=torch.bfloat16)
    return qc, rep["pe"], rep["re"], verdict(rep, thr)


def ik_numbers(robot: Robot, obstacles: List[Dict], q, goal_pos, goal_quat, pe, re, success,
               thr: Dict) -> Dict:
    """The gaps of IK answers: reported pose errors against the reference's,
    and the reference's verdict on each reported success."""
    rep = configuration_report(robot, obstacles, q, goal_pos, goal_quat)
    gap = torch.maximum((pe.double() - rep["pe"]).abs(), (re.double() - rep["re"]).abs())
    claim = claim_excess(rep, thr)[success.bool()]
    return dict(answer_gap=max(_max(gap), _max(claim.clamp_min(0))),
                pose_gap=_max(gap), claim_excess=_max(claim),
                solved_share=float(success.float().mean()) if success.numel() else 0.0)


# ---------------------------------------------------------------------------
# Trajectories (plans and MPC ticks)
# ---------------------------------------------------------------------------
def trajectory_numbers(robot: Robot, worlds: List[List[Dict]], world_of: List[int],
                       q_start, pos, goal_pos, goal_quat, pe, re, claimed,
                       thr: Dict, derivs: Optional[Dict] = None, extra_start=None,
                       command=None) -> Dict:
    """Gaps of trajectory answers (n trajectories of H waypoints, (n, H, D)):
    the start against the start state (and `extra_start`, another (n, D)
    start of the same answer; for MPC ticks, those that claim a feasible
    plan), the reported terminal pose errors against the
    reference's forward kinematics of the last waypoint, an MPC command
    against the plan's second waypoint, and where `claimed` the reference's
    verdict on every waypoint (obstacles of `worlds[world_of[i]]`) and on the
    `derivs` (name -> ((n, H, D) values, (D,) limit))."""
    n, H, D = pos.shape
    pos = pos.double()
    claimed = claimed.bool()
    start_gap = (pos[:, 0] - q_start.double()).abs().amax(-1)
    if extra_start is not None:
        start_gap = torch.maximum(start_gap, (extra_start.double() - q_start.double()).abs().amax(-1))
    if command is not None:
        # a tick that claims no feasible plan brakes: its plan starts a step on
        start_gap = torch.where(claimed, start_gap, torch.zeros_like(start_gap))
        start_gap = torch.maximum(start_gap, (command.double() - pos[:, 1]).abs().amax(-1))
    # terminal pose
    end = configuration_report(robot, [], pos[:, -1], goal_pos, goal_quat)
    pose_gap = torch.maximum((pe.double() - end["pe"]).abs(), (re.double() - end["re"]).abs())
    pose_gap = torch.where(claimed, pose_gap, torch.zeros_like(pose_gap))
    excess = torch.maximum(end["pe"] - thr["position"], end["re"] - thr["rotation"])
    # every waypoint, grouped by world
    wp_excess = torch.full((n,), -1.0, dtype=F64, device=pos.device)
    for w in sorted(set(world_of)):
        rows = torch.tensor([i for i, k in enumerate(world_of) if k == w], device=pos.device)
        flat = pos[rows].reshape(-1, D)
        for s in _chunks(flat.shape[0]):
            c = robot.spheres(flat[s])
            e = torch.stack([-scene.clearance(c, robot.sphere_radius, worlds[w]),
                             -robot.self_slack(c), robot.limit_excess(flat[s])]).amax(0)
            idx = rows[torch.div(torch.arange(s.start, s.stop, device=pos.device), H,
                                 rounding_mode="floor")]
            wp_excess = wp_excess.scatter_reduce(0, idx, e, reduce="amax")
    excess = torch.maximum(excess, wp_excess)
    for values, limit in (derivs or {}).values():
        ratio = (values.double().abs() / limit.double()).amax(dim=(-1, -2)) - 1.0
        excess = torch.maximum(excess, ratio)
    claim = excess[claimed]
    return dict(answer_gap=max(_max(start_gap), _max(pose_gap), _max(claim.clamp_min(0))),
                start_gap=_max(start_gap), pose_gap=_max(pose_gap), claim_excess=_max(claim))


def trajectory_control(robot: Robot, worlds, world_of, pos, goal_pos, goal_quat, thr,
                       derivs=None):
    """The control's trajectory answers: waypoints (and derivatives) in
    bfloat16, terminal pose errors and the verdict worked out in bfloat16."""
    n, H, D = pos.shape
    bf = torch.bfloat16
    pc = pos.to(bf).double()
    end = configuration_report(robot, [], pc[:, -1], goal_pos, goal_quat, dtype=bf)
    ok = (end["pe"] <= thr["position"]) & (end["re"] <= thr["rotation"])
    for i in range(n):
        rep = configuration_report(robot, worlds[world_of[i]], pc[i],
                                   goal_pos[i:i + 1].expand(H, 3), goal_quat[i:i + 1].expand(H, 4),
                                   dtype=bf)
        ok[i] &= bool((rep["clear"] >= 0).all() & (rep["slack"] >= 0).all() & (rep["limit"] <= 0).all())
    dc = {}
    for name, (values, limit) in (derivs or {}).items():
        v = values.to(bf).double()
        dc[name] = (v, limit)
        ok &= (v.abs() / limit.double()).amax(dim=(-1, -2)) <= 1.0
    return pc, end["pe"], end["re"], ok, dc
