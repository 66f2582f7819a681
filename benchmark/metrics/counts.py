"""Operations and bytes that the kernels' work requires, and the chip's peaks.

Every count is a function of a configuration file alone: the robot's shapes
(links, revolute joints, sphere slots, live spheres, live self-collision
pairs, dof, tool frames) as the reference reads them from the robot YAML, the
obstacles the configuration places, and the solver budgets it states. No
table the program built is read, so the count stays the same whatever
implements the work. Float operations follow the per-evaluation model of the
IK and trajectory objectives (forward kinematics, pose error, bounds, sphere
centres, pair distances, scene distances; with the gradient the reverse sweep);
the hinge and argmin branches that depend on the data are left out, so the
count is a lower one. Bytes count each input read once and each output
written once, in float32 words.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

from benchmark.drivers.common import data_path

# Published peaks of one NVIDIA H100 SXM at its 700 W limit: float32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67.0e12
PEAK_BYTES = 3.35e12
WORD = 4


@dataclasses.dataclass(frozen=True)
class Shapes:
    L: int  # links
    n_rev: int  # revolute joints driven by the dof
    S: int  # sphere slots, the disabled attachment slots included
    n_live: int  # enabled spheres
    P: int  # live self-collision pairs
    D: int  # dof
    T: int  # tool frames


@dataclasses.dataclass(frozen=True)
class World:
    cuboids: int = 0
    spheres: int = 0
    capsules: int = 0
    cylinders: int = 0

    @staticmethod
    def of(obstacles: List[Dict]) -> "World":
        n = lambda t: sum(1 for o in obstacles if o["type"] == t)
        return World(n("cuboid"), n("sphere"), n("capsule"), n("cylinder"))

    def row_words(self) -> int:
        # pose (rotation 9, centre 3) and size words of each obstacle row, plus its flag
        return self.cuboids * 16 + self.spheres * 5 + self.capsules * 8 + self.cylinders * 15


@functools.lru_cache(maxsize=None)
def robot_shapes(robot_yaml: str) -> Shapes:
    from benchmark.reference.robot import Robot

    r = Robot(robot_yaml)
    n_rev = sum(1 for k, d in zip(r.kind, r.dof) if k == 1 and d >= 0)
    return Shapes(L=len(r.link_names), n_rev=n_rev, S=r.n_sphere_slots,
                  n_live=len(r.sphere_radius), P=len(r.pair_margin), D=r.n_dof, T=len(r.tools))


def _scene_ops(w: World) -> int:
    return w.cuboids * 45 + w.spheres * 12 + w.capsules * 32 + w.cylinders * 50


# ---------------------------------------------------------------------------
# IK: one evaluation and one `ik_solve` per configuration
# ---------------------------------------------------------------------------
def ik_eval_flops(s: Shapes, w: World, grad: bool, pose_only: bool) -> float:
    fk = s.L * (45 + 18) + s.n_rev * (30 + 45)  # compose R, p; Rodrigues + fixed @ joint
    f = fk + 120 * s.T + 8 * s.D
    if grad:
        f += s.L * 30 + 40 * s.T  # reverse sweep, each tool's force and torque
    if pose_only:
        return float(f)
    f += s.S * 18 + s.P * 12 + s.n_live * (_scene_ops(w) + 4)
    if grad:
        f += s.S * 15  # sphere cotangents into link forces and torques
    return float(f)


def ik_solve_flops(s: Shapes, w: World, b: Dict) -> float:
    """Operations of one configuration's solve under budget `b` (keys
    warmup_iters, mppi_iters, n_particles, lbfgs_iters, n_linesearch)."""
    e = lambda grad, pose: ik_eval_flops(s, w, grad, pose)
    f = 0.0
    if b["warmup_iters"] > 0:
        f += e(True, True) + b["warmup_iters"] * (b["n_linesearch"] * e(False, True) + e(True, True))
    if b["mppi_iters"] > 0:
        f += (2 + b["mppi_iters"] * b["n_particles"]) * e(False, False)
    f += e(True, False) + b["lbfgs_iters"] * (b["n_linesearch"] * e(False, False) + e(True, False))
    return f + e(False, False)


def ik_solve_bytes(s: Shapes, w: World, N: int) -> float:
    robot = s.L * 20 + s.S * 5 + s.P * 3 + s.D * 6 + 8
    per_config = 7 * s.T + s.D + s.D + 4  # goal and seed in; solution and four metrics out
    return float(WORD * (robot + w.row_words() + N * per_config))


def ik_budget(ik: Dict) -> Dict:
    """The `ik_solve` budget of an IK solver configuration as the
    configuration file states it (defaults of the solver for absent keys)."""
    mppi = ik.get("mppi", {})
    return dict(
        warmup_iters=ik.get("warmup_iters", 0),
        mppi_iters=mppi.get("n_iters", 8) if ik.get("use_particle_stage", True) else 0,
        n_particles=mppi.get("n_particles", 32),
        lbfgs_iters=ik.get("lbfgs", {}).get("n_iters", 40),
        n_linesearch=ik.get("kernel_linesearch", 6),
    )


# ---------------------------------------------------------------------------
# Trajectories: one evaluation and one `traj_solve` per trajectory
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Spline:
    H: int  # steps
    n_ctrl: int  # control points
    n_free: int  # free (optimised) control points
    K: int  # swept samples per step


def traj_eval_flops(s: Shapes, sp: Spline, w: World, grad: bool) -> float:
    fk = s.L * (45 + 18) + s.n_rev * (30 + 45)
    spline = 4 * 2 * sp.n_ctrl * s.D
    scene = s.n_live * sp.K * (_scene_ops(w) + 10)
    step = spline + fk + s.S * 18 + s.P * 12 + scene + 30 * s.D
    f = sp.H * step + 120
    if grad:
        f += sp.H * (s.L * 30 + s.S * 15 + s.n_live * sp.K * 12) + 40
        f += sp.H * 4 * 2 * sp.n_free * s.D
    return float(f)


def traj_solve_flops(s: Shapes, sp: Spline, w: World, b: Dict) -> float:
    """Operations of one trajectory's solve under budget `b` (keys
    mppi_iters, n_particles, lbfgs_iters, n_linesearch)."""
    e = lambda grad: traj_eval_flops(s, sp, w, grad)
    f = 0.0
    if b["mppi_iters"] > 0:
        f += (2 + b["mppi_iters"] * b["n_particles"]) * e(False)
    f += e(True) + b["lbfgs_iters"] * (b["n_linesearch"] * e(False) + e(True))
    return f + e(False)


def traj_solve_bytes(s: Shapes, sp: Spline, w: World, NP: int) -> float:
    robot = s.L * 20 + s.S * 5 + s.P * 3 + s.D * 9 + 8
    basis = 4 * sp.H * sp.n_ctrl
    per_traj = 7 + sp.n_free * s.D + 2 * s.D + 1 + sp.n_free * s.D + 5
    return float(WORD * (robot + basis + w.row_words() + NP * per_traj))


def least_ms(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations over
    the float32 peak and the bytes over the memory bandwidth."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3


# ---------------------------------------------------------------------------
# The work of the cells' calls, from their configuration and what the calls
# were (problem, attempts), launch by launch: (kernel, operations, bytes)
# ---------------------------------------------------------------------------
def ik_launch(config: Dict, ik: Dict, N: int, obstacles: List[Dict]):
    s = robot_shapes(data_path(config, "robot"))
    w = World.of(obstacles)
    return ("ik_solve_kernel", N * ik_solve_flops(s, w, ik_budget(ik)), ik_solve_bytes(s, w, N))


def _trajopt_spline(config: Dict) -> Spline:
    t = config["planner"]["trajopt"]
    b = t["bspline"]
    pins = 6 if t.get("pin_goal", True) else 3
    return Spline(H=b["horizon"], n_ctrl=b["n_control"], n_free=b["n_control"] - pins,
                  K=config["counts"]["sweep_steps"])


def plan_launches(config: Dict, obstacles: List[Dict], attempts: int):
    """The kernels' work of one plan (B = 1) of `attempts` attempts: each
    attempt one `ik_solve` over the IK seeds (the retry's scaled), two
    `traj_solve` rounds over the trajectory seeds and one metrics
    evaluation of the best trajectory."""
    pl = config["planner"]
    s = robot_shapes(data_path(config, "robot"))
    w = World.of(obstacles)
    sp = _trajopt_spline(config)
    t = pl["trajopt"]
    tb = dict(mppi_iters=0, n_particles=0, lbfgs_iters=t["lbfgs"]["n_iters"],
              n_linesearch=config["counts"]["traj_linesearch"])
    out = []
    for a in range(attempts):
        n_ik = pl["ik"]["n_seeds"] * (1 if a == 0 else pl["retry_ik_seed_scale"])
        NP = pl["n_trajopt_seeds"] if a == 0 else max(pl["n_trajopt_seeds_retry"], pl["n_trajopt_seeds"])
        out.append(ik_launch(config, pl["ik"], n_ik, obstacles))
        for _ in range(t.get("finetune_attempts", 1) + 1):
            out.append(("traj_solve_kernel", NP * traj_solve_flops(s, sp, w, tb),
                        traj_solve_bytes(s, sp, w, NP)))
        out.append(("traj_cost_grad_kernel", traj_eval_flops(s, sp, w, False),
                    traj_solve_bytes(s, sp, w, 1)))
    return out


def mpc_launch(config: Dict, obstacles: List[Dict]):
    """The kernel's work of one MPC tick (B = 1): one `traj_solve`."""
    import yaml

    with open(data_path(config, "mpc")) as fh:
        m = yaml.safe_load(fh)
    s = robot_shapes(data_path(config, "robot"))
    w = World.of(obstacles)
    b = m["bspline"]
    sp = Spline(H=b["horizon"], n_ctrl=b["n_control"], n_free=b["n_control"] - 3,
                K=config["counts"]["sweep_steps"])
    tb = dict(mppi_iters=m["mppi"]["n_iters"] if m.get("use_particle_stage", True) else 0,
              n_particles=m["mppi"]["n_particles"],
              lbfgs_iters=m["lbfgs"]["n_iters"] if m.get("use_gradient_stage", True) else 0,
              n_linesearch=config["counts"]["traj_linesearch"])
    return ("traj_solve_kernel", traj_solve_flops(s, sp, w, tb), traj_solve_bytes(s, sp, w, 1))


def call_launches(run) -> List:
    """Every kernel launch the traced calls of a run require, by the cell's
    driver."""
    kind = run.traffic["driver"]
    cfg = run.config
    if kind == "ik":
        B, S = int(run.traffic["batch"]), int(cfg["ik"].get("n_seeds", 32))
        return [ik_launch(cfg, cfg["ik"], B * S, cfg["scene"])] * run.calls
    if kind == "plan":
        return [l for r in run.cell.records
                for l in plan_launches(cfg, run.cell.obstacles[r["problem"]], r["attempts"])]
    if kind == "mpc":
        return [mpc_launch(cfg, run.cell.obstacles[r["tick"]]) for r in run.cell.records]
    return []


def roofline_pct(run, kernel: str):
    """The least time of the kernel's launches over their device time, in %;
    None where the trace holds no launch of it or another number of
    launches than the calls require."""
    if run.events is None:
        return None
    durs = run.events.kernel_us(kernel)
    need = [l for l in call_launches(run) if l[0] == kernel]
    if not durs or len(durs) != len(need):
        return None
    least = sum(least_ms(f, b) for _, f, b in need)
    return least / (sum(durs) / 1e3) * 100.0


def step_mfu_pct(run):
    """The operations every kernel launch of the traced calls requires, over
    the traced window's length at the float32 peak, in %."""
    if run.events is None or run.events.window_s <= 0 or not run.events.device:
        return None
    flops = sum(f for _, f, _ in call_launches(run))
    return flops / (run.events.window_s * PEAK_F32_FLOPS) * 100.0 if flops > 0 else None

