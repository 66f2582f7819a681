#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (needs one CUDA device)
    python3 chip_smoke.py --quick    # build + kernel comparisons only
    python3 chip_smoke.py --g1       # phase `g1` alone
    python3 chip_smoke.py --retarget # phase `retarget` alone
    python3 chip_smoke.py --torque   # phase `torque` alone
    python3 chip_smoke.py --voxel    # phase `voxel` alone
    python3 chip_smoke.py --perception  # phase `perception` alone
    python3 chip_smoke.py --urdf     # phase `urdf` alone

Builds the CUDA kernels from the sources in this checkout and holds each
kernel against its plain PyTorch version on the card at the shapes of its
path: the IK kernels at 3200 Franka configurations (100 goals x 32 seeds), the
trajectory kernels at 1024 Franka trajectories (spline 5, 16, 32) in the
motion suite's worlds and at 256 trajectories of a 64-step horizon (whose step
state lives in global memory), and all four in a world of 4096 cuboid rows
(whose rows live in global memory). Two launches of each solver kernel on the
same inputs must give the same bits. Then it drives the two main paths through
the public entry points and checks the results: collision-free IK
(`Kinematics.from_robot_yaml` -> `compile_scene` -> `IKSolver.solve_pose`,
phase `solve`) and motion generation (`MotionPlanner.plan_pose` over the 90
problems of `content/problems/franka_motion.json`, phase `plan`), times the
kernels at the paths' shapes, and traces two plans with `torch.profiler`
(phase `profile`). It holds `traj_solve` at MPC's shape against its plain
version (phase `compare_mpc_kernel`), drives MPC through `MPCSolver.run_ticks`
and `step` on the reference bench's 50-tick episode and a tracking episode
(phase `mpc`: one `traj_solve` launch a tick, tick time, busy share, feasible
rate), and runs the generic route on the card: goal-set IK and `plan_cspace`
(phase `generic`, gated by the JAX package's CPU result on the same problems).
Phase `dual` holds both IK kernels at two tool frames (the dual-arm UR10e,
3200 configurations) against their plain versions and solves the reference
bench's 100 dual-arm goals x 32 seeds through `IKSolver.solve_pose` with the LM
seed stage (`bench.py:bench_dual_ur10e_cfik`'s budget): time per solve, the LM
stage and the kernel apart, success (fails under 0.95), one `ik_solve` a solve.
Phase `g1` solves `bench.py:bench_g1_cfik`'s protocol on the Unitree G1 (49
dof, 4 tool frames, 162 111 self-collision pairs, 100 goals, LM pool 128 -> 16
seeds) through `IKSolver.solve_pose` on the generic route, which the robot's
shapes choose (no IK kernel takes it, none may launch; its self-collision sum
must run the pair kernels): time per solve, the LM and L-BFGS stages apart,
success (fails under 0.95), peak memory, busy share; then `ik_g1.yml` with
the support polygon on (3 of 3 goals) and one solve of the default
`IKConfig()`. Phase `sc_kernels` holds the three self-collision pair kernels
(`ops/csrc/self_collision.cu`) against their plain versions at the G1 line
search (4800 x 162 111 pairs, the G1 solve's seeds), the retarget robot's
global and local frames and the Franka (3200 x 694), with two launches giving
the same bits (the gradient gated over its nonzero entries and by its largest
error), and times each beside its plain version and its bound. Phase
`retarget` drives `MotionRetargeter` on `unitree_g1_29dof_retarget.yml` (35
dof, 14 tool frames, 55 414 pairs): a 120-frame clip at B = 1, 64 clips of
30 frames at once, the default MPC mode (which raises in the MPPI bank's
Halton sampler, as the reference's does: 245 dimensions of its 62), and the
protocol of `examples/humanoid_retargeting.py` on `unitree_g1.yml` (gated at
position error p90 < 20 mm and by the example's own limits).
Phase `torque` plans the first 20 suite problems with the torque-limited
config of `bench_motion.py --use-dynamics` (RNEA torque term, weight 100, a 3
kg payload; success gated at 0.95), whose trajectory optimisation takes the
generic route (one `ik_solve` an attempt, no trajectory kernel), holds the
RNEA on the card against the CPU and estimates the RNEA's share of a plan.
Phase `voxel` solves 100 goals x 32 seeds in a 96 x 96 x 80 ESDF of the
table and the perception example's box (generic route; gated at the cuboid
twin's success less 0.05), runs 20 MPC ticks while the box moves through
`update_voxel_data` (feasible >= 0.9), holds the IK and trajectory kernels at
an attached payload's tables and plans 10 suite problems holding it, and
checks `evaluate_config_env` over two stacked worlds against the
single-world calls.
Phase `perception` runs `examples/perception_to_planning.py`'s pipeline at
full size (a 320 x 240 depth frame -> `FilterDepth` -> `Mapper.integrate`
into 96 x 96 x 80 voxels -> `get_voxel_grid` -> `compile_scene` ->
`IKSolver.solve_pose`, 100 goals x 32 seeds on the generic route, gated at
the numpy-exact ESDF's success less 0.05, the map held against the CPU's),
the reference bench's perception protocol (two 480 x 640 RGB-D cameras with
8 feature channels into the block-sparse pool, ms a frame pair beside
cuRobo's quoted 2 ms, no dropped block; the dense 128^3 grid and its ESDF),
mesh and point-cloud obstacles (the native bake held against the numpy one,
then IK around them), `SDFPoseDetector` and `RobotSegmenter`.
Phase `urdf` (a) writes `franka.yml`'s links as URDF text, loads it with
`RobotModelConfig.from_urdf` and the YAML's spheres, ignore matrix, buffers,
retract and locks (the tables must equal the YAML model's, compared by link
name) and solves 100 goals x 32 seeds at the bench budget on the kernel
route, bit-equal to the YAML robot's solve; (b) runs `RobotBuilder` on that
URDF and on the demo arm of `examples/build_robot_model.py` (the card's
config must equal the CPU's), solves 100 x 32 on the built Franka beside the
plain version on the same seeds, and holds `RobotDebugger`'s report of
`franka.yml` to the CPU's (`sc_pair_viol` must launch); (c) runs every
method of the optimizer registry on `examples/custom_optimization.py`'s
objective (each must lower the cost; the deterministic ones agree with the
CPU's run within 1 %; L-BFGS within the example's 20 mm; the pair kernels must
launch; the objective's self-collision term and its gradient at the start, at
every method's end and on 256 configurations drawn within the limits agree
with the CPU's, and a pair left out of the sum shows);
(d) solves the 100 x 32 with `solve_ik_sharded` on a 2 x 2 mesh of the card,
bit-equal to the unsharded solve; (e) exports a suite plan with
`export_plan_usd`, equal to the CPU's export within 1e-5.
The traces and the compiler's `-Xptxas -v` logs are written to
`chiprun_out/`. Every line of output is one JSON object, except the line with
the card's name and power limit. Exits non-zero on the first failed phase, and
when there is no CUDA device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; a CUDA device is required\n")
    sys.exit(2)

import curobo_tpu_torch as ct
from curobo_tpu_torch.geom import types as gt
from curobo_tpu_torch.geom import world as twm
from curobo_tpu_torch.ops import build as kbuild
from curobo_tpu_torch.geom.self_collision import self_collision_distance
from curobo_tpu_torch.ops import ik_kernels as ikk
from curobo_tpu_torch.ops import self_collision_kernels as sck
from curobo_tpu_torch.ops import traj_kernels as tk
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig, LineSearchConfig
from curobo_tpu_torch.opt.mppi import MPPIConfig, smooth_sample_transform
from curobo_tpu_torch.transition.bspline import BSplineConfig, BSplineTransition
from curobo_tpu_torch.geom import mesh as gmesh
from curobo_tpu_torch.perception import block_sparse as bsp
from curobo_tpu_torch.perception import mapper as mpr
from curobo_tpu_torch.perception.pose_estimation import PoseEstimationConfig, SDFPoseDetector
from curobo_tpu_torch.cost import terms as cost_terms
from curobo_tpu_torch.opt import factory as opt_factory
from curobo_tpu_torch.parallel import mesh as pmesh
from curobo_tpu_torch.robot.builder import RobotBuilder
from curobo_tpu_torch.robot.debugger import RobotDebugger
from curobo_tpu_torch.rollout.robot_rollout import Goal, RobotRollout, RobotRolloutConfig
from curobo_tpu_torch.util import usd_export
from curobo_tpu_torch.util.config_io import load_yaml

DEV = torch.device("cuda", 0)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
N_GOALS, N_SEEDS = 100, 32
N_TRAJ = 1024  # trajectories of the trajectory-kernel comparisons

# Published peaks of one H100 SXM: float32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67.0e12
PEAK_BYTES = 3.35e12
N_SM = 132

IK_WARPS = 4  # configurations per block of the IK kernels (IK_WARPS, ops/csrc/ik_kernels.cu)
# Cuboid rows of the large-world check: more than a block's shared memory
# holds beside the tables, so the launches compact them into global memory.
BIG_WORLD_CUBOIDS = 4096

# Kernel times of the previous design (one thread per evaluation), quoted from
# PERF.md (PR 2: NVIDIA H100 80GB HBM3, 700 W) and printed on a line of their
# own, labelled as quoted; this run measures none of them.
PR2_QUOTED_MS = dict(ik_solve_bench_n3200=9.368, ik_solve_default_n3200=110.209,
                     ik_solve_default_n32=150.9, traj_solve_np4=246.19,
                     traj_cost_grad_np1=0.876, ik_cost_grad_n3200=0.371)

# Limits of the comparisons. Cost and gradient: sums over 694 pair terms and
# 61 sphere terms run in another order in the kernel than in PyTorch, and the
# kernel's rotation gradient is taken on SO(3) while autograd goes through the
# quaternion, so single configurations near a kink may differ more than the
# bulk: median and 99th percentile of the relative error.
COST_MED, COST_P99 = 1e-4, 1e-2
# Solver loops: a strict `<` in the line search can flip on a rounding
# difference, after which the two runs part; a wrong history slot or step rule
# would move most configurations, not a few percent.
LOOP_COST_MED, LOOP_X_FRAC, LOOP_X_TOL = 1e-3, 0.95, 1e-3


# every line emit() prints also goes to chiprun_out/chip_smoke.jsonl: the
# output is longer than what a remote run returns of it
LOG_LINES = []
# the agreement numbers that `compare_summary` repeats near the end, per case
BRIEF_KEYS = dict(cost_rel_median="c_med", cost_rel_p99="c_p99", grad_rel_median="g_med",
                  grad_rel_p99="g_p99", x_agree_frac="x_ok", feasible_agree_frac="feas_ok",
                  conv_frac_kernel="conv_k", conv_frac_plain="conv_p")


def emit(obj):
    line = json.dumps(obj)
    LOG_LINES.append(line)
    print(line, flush=True)


def brief_cases(obj, out):
    """Every comparison case inside obj (a dict labelled by `case` or
    `world`), with its agreement numbers to four significant digits."""
    if isinstance(obj, dict):
        label = obj.get("case", obj.get("world"))
        if isinstance(label, str):
            out.append(dict(case=label, **{b: float(f"{obj[k]:.4g}")
                                           for k, b in BRIEF_KEYS.items() if k in obj}))
        for v in obj.values():
            if isinstance(v, (dict, list)):
                brief_cases(v, out)
    elif isinstance(obj, list):
        for v in obj:
            brief_cases(v, out)
    return out


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def event_samples(fn, reps, warm=1):
    """CUDA-event milliseconds of `reps` calls of `fn` after `warm` warm-up
    calls, and the last call's result."""
    out = None
    for _ in range(warm):
        out = fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return ts, out


def time_ms(fn, reps, warm=1):
    """Median milliseconds of `fn` by CUDA events, after warm-up."""
    return statistics.median(event_samples(fn, reps, warm)[0])


# ---------------------------------------------------------------------------
# Problem set-up (the reference bench's protocol: goals are FK of
# collision-free Halton configurations, one table cuboid)
# ---------------------------------------------------------------------------
def table_scene():
    return gt.Scene().add(
        gt.Cuboid(name="table", pose=[0.4, 0.0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2])
    )


def mixed_scene():
    return gt.Scene().add(
        gt.Cuboid(name="table", pose=[0.4, 0.0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        gt.SphereObstacle(name="ball", pose=[0.3, 0.3, 0.5, 1, 0, 0, 0], radius=0.1),
        gt.Capsule(name="bar", pose=[0.5, -0.3, 0.4, 0.9239, 0.3827, 0, 0], radius=0.05,
                   base=[0, 0, -0.2], tip=[0, 0, 0.2]),
        gt.Cylinder(name="post", pose=[-0.3, 0.4, 0.3, 0.9659, 0, 0.2588, 0], radius=0.08,
                    height=0.6),
    )


def bench_ik_config():
    """The reference bench's budget: 32 seeds, warm-up 32, no MPPI, L-BFGS 6
    with history 10, line search 4."""
    return ct.IKConfig(
        n_seeds=N_SEEDS,
        warmup_iters=32,
        use_particle_stage=False,
        mppi=MPPIConfig(n_particles=16, n_iters=1, init_std=0.6),
        lbfgs=LBFGSConfig(
            history=10, n_iters=6,
            line_search=LineSearchConfig(scales=(0.05, 0.2, 0.5, 0.8, 1.0, 1.4)),
        ),
        kernel_linesearch=4,
    )


def make_goals(kin, world):
    rsc = ct.RobotSceneCollision(kin.params)
    q_goal, ok = rsc.sample(world, N_GOALS)
    if not bool(ok.all()):
        fail(f"only {int(ok.sum())} of {N_GOALS} collision-free goal configurations found")
    st = kin.compute_kinematics(q_goal)
    return ct.Pose(st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0])


def budget_of(cfg: ct.IKConfig) -> ikk.IKSolveBudget:
    return ikk.IKSolveBudget(
        mppi_iters=cfg.mppi.n_iters if cfg.use_particle_stage else 0,
        n_particles=cfg.mppi.n_particles, init_std=cfg.mppi.init_std,
        std_decay=cfg.mppi.std_decay, min_std=cfg.mppi.min_std,
        temperature=cfg.mppi.temperature, step_size=cfg.mppi.step_size,
        lbfgs_iters=cfg.lbfgs.n_iters, history=cfg.lbfgs.history,
        max_step=cfg.lbfgs.max_step, n_linesearch=cfg.kernel_linesearch,
        ls_base=cfg.kernel_ls_base, ls_ratio=cfg.kernel_ls_ratio,
        warmup_iters=cfg.warmup_iters,
    )


# ---------------------------------------------------------------------------
# Operation counts for the bound (float operations the algorithm needs on these
# inputs; the hinge and argmin branches that depend on the data are left out,
# so the bound is a lower one)
# ---------------------------------------------------------------------------
def eval_flops(tab: ikk.IKTables, world_tabs, grad: bool, pose_only: bool) -> float:
    n_rev = sum(1 for kind, _, _ in tab.link_host if kind == 1)
    fk = tab.L * (45 + 18) + n_rev * (30 + 45)  # compose R, p; Rodrigues + fixed @ joint
    pose = 120 * tab.T  # per tool frame
    bounds = 8 * tab.D
    f = fk + pose + bounds
    if grad:
        f += tab.L * 30 + 40 * tab.T  # reverse sweep + each tool's force/torque
    if pose_only:
        return float(f)
    n_live = int((tab.sph_f[:, 3] >= 0).sum())
    kc, ks, kp, ky = (int((t[:, -1] > 0.5).sum()) for t in world_tabs)
    f += tab.S * 18 + tab.P * 12 + n_live * (kc * 45 + ks * 12 + kp * 32 + ky * 50 + 4)
    if grad:
        f += tab.S * 15  # sphere cotangents -> link force and torque
    return float(f)


def solve_flops(tab, world_tabs, b: ikk.IKSolveBudget) -> float:
    e = lambda grad, pose: eval_flops(tab, world_tabs, grad, pose)
    f = 0.0
    if b.warmup_iters > 0:
        f += e(True, True) + b.warmup_iters * (b.n_linesearch * e(False, True) + e(True, True))
    if b.mppi_iters > 0:
        f += (2 + b.mppi_iters * b.n_particles) * e(False, False)
    f += e(True, False) + b.lbfgs_iters * (b.n_linesearch * e(False, False) + e(True, False))
    return f + e(False, False)


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sm_floor_ms(flops: float, blocks: int) -> float:
    """The float32 floor on the SMs a launch of `blocks` blocks can fill (one
    block per SM at most): its operations over that share of the peak."""
    return flops / (PEAK_F32_FLOPS * min(blocks, N_SM) / N_SM) * 1e3


def ptxas_summary(log: str) -> dict:
    """Registers, stack and spills per function from `nvcc -Xptxas -v`. ptxas
    compiles the functions a kernel calls once for each kernel's register cap,
    so a called function is keyed "kernel:function"."""
    out, entry, fn = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            fn = m.group(1) if m.group(1) == entry else f"{entry}:{m.group(1)}"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn is not None:
            out.setdefault(fn, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                          spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def ptxas_of(summary: dict, kernel: str) -> dict:
    """One kernel's entry, the spill stores of everything it runs (its own
    copies of the functions it calls included) and the most spill stores of
    any function of its library."""
    mine = {fn: v for fn, v in summary.items() if fn.split(":")[0].find(kernel) >= 0}
    entry = next((v for fn, v in mine.items() if ":" not in fn), {})
    return dict(entry, spill_stores_with_callees=sum(v.get("spill_stores", 0) for v in mine.values()),
                library_max_spill_stores=max((v.get("spill_stores", 0) for v in summary.values()),
                                             default=0))


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------
def rel_stats(a, b, floor):
    rel = (a - b).abs() / (b.abs() + floor)
    return float(rel.median()), float(torch.quantile(rel.flatten().float(), 0.99))


def compare_cost_grad(tab, world_tabs, goal7, q, label):
    c_k, g_k = ikk.ik_cost_grad(tab, world_tabs, goal7, q, True)
    c_f, _ = ikk.ik_cost_grad(tab, world_tabs, goal7, q, False)
    torch.cuda.synchronize()
    c_p, g_p = ikk.ik_cost_grad_plain(tab, world_tabs, goal7, q, True)
    if not (torch.isfinite(c_k).all() and torch.isfinite(g_k).all()):
        fail(f"ik_cost_grad[{label}] returned non-finite values")
    c_med, c_p99 = rel_stats(c_k, c_p, 1e-2)
    g_med, g_p99 = rel_stats(g_k, g_p, 1.0)
    fwd = float((c_f - c_k).abs().max())
    out = dict(world=label, cost_rel_median=c_med, cost_rel_p99=c_p99,
               grad_rel_median=g_med, grad_rel_p99=g_p99, fwd_vs_grad_max_abs=fwd,
               max_abs_err=float((c_k - c_p).abs().max()))
    if not (c_med < COST_MED and c_p99 < COST_P99 and g_med < COST_MED and g_p99 < COST_P99):
        fail(f"ik_cost_grad[{label}] disagrees with its plain version: {out}")
    if fwd > 1e-3 * float(c_k.abs().max()):
        fail(f"ik_cost_grad[{label}] cost-only and cost+grad entries disagree: {out}")
    return out


def compare_solve(tab, world_tabs, goal7, x0, budget, label, seed=0, noise=None,
                  plain_noise=None, strict=True):
    out_k = ikk.ik_solve(tab, world_tabs, goal7, x0, budget, seed, noise)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = ikk.ik_solve_plain(tab, world_tabs, goal7, x0, budget, seed,
                               noise if plain_noise is None else plain_noise)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for t in out_k:
        if not torch.isfinite(t).all():
            fail(f"ik_solve[{label}] returned non-finite values")
    xk, ck, pek, rek, fek = out_k
    xp, cp, pep, rep, fep = out_p
    rel_c = (ck - cp).abs() / (cp.abs() + 1e-2)
    dx = (xk - xp).abs().amax(dim=-1)
    conv = lambda pe, re, fe: (pe <= 0.005) & (re <= 0.05) & (fe > 0.5)
    res = dict(
        case=label, cost_rel_median=float(rel_c.median()),
        x_agree_frac=float((dx < LOOP_X_TOL).float().mean()),
        feasible_agree_frac=float(((fek > 0.5) == (fep > 0.5)).float().mean()),
        conv_frac_kernel=float(conv(pek, rek, fek).float().mean()),
        conv_frac_plain=float(conv(pep, rep, fep).float().mean()),
        max_abs_err_cost=float((ck - cp).abs().max()),
        max_abs_err_x=float(dx.max()), plain_ms=plain_s * 1e3,
    )
    if not strict:
        # the pose error of the converged configurations (the planner hands
        # several of them on as trajectory ends): mean and 98th percentile, mm
        for who, pe, re, fe in (("kernel", pek, rek, fek), ("plain", pep, rep, fep)):
            e = pe[conv(pe, re, fe)].double() * 1e3
            res[f"conv_pos_err_mm_mean_{who}"] = float(e.mean()) if e.numel() else -1.0
            res[f"conv_pos_err_mm_p98_{who}"] = float(torch.quantile(e, 0.98)) if e.numel() else -1.0
    if strict:
        if not (res["cost_rel_median"] < LOOP_COST_MED and res["x_agree_frac"] >= LOOP_X_FRAC):
            fail(f"ik_solve[{label}] disagrees with its plain version: {res}")
    elif abs(res["conv_frac_kernel"] - res["conv_frac_plain"]) > 0.02:
        fail(f"ik_solve[{label}] converges on another share than its plain version: {res}")
    return res, out_k


# ---------------------------------------------------------------------------
# Trajectory kernels: inputs from the motion suite, comparisons
# ---------------------------------------------------------------------------
def motion_suite():
    with open(ct.content_path("problems", "franka_motion.json")) as fh:
        return json.load(fh)


def motion_world(spec, cap):
    return ct.compile_scene(
        gt.Scene().add(*[gt.Cuboid(**o) for o in spec["cuboids"]]), capacities={"cuboid": cap}
    )


def traj_inputs(tr, problems, n, gen, pin, start_noise=0.05, end_noise=0.05, knot_noise=0.05):
    """n trajectories around the suite's start and goal configurations (goal
    pose = the problem's; the oracle goal configuration reaches it), straight
    seeds with knot noise, dt in [0.02, 0.1] -> (goal7, x, q_start, q_end, dt)
    on the card."""
    idx = [i % len(problems) for i in range(n)]
    f32 = dict(dtype=torch.float32)
    qs = torch.tensor([problems[i]["q_start"] for i in idx], **f32)
    qe = torch.tensor([problems[i]["q_goal_oracle"] for i in idx], **f32)
    goal7 = torch.tensor([problems[i]["goal_pose"] for i in idx], **f32)
    qs = qs + start_noise * torch.randn(qs.shape, generator=gen)
    qe = qe + end_noise * torch.randn(qe.shape, generator=gen)
    free = tr.linear_seed(qs, qe, q_goal_pinned=pin)
    free = free + knot_noise * torch.randn(free.shape, generator=gen)
    dt = 0.02 + 0.08 * torch.rand((n,), generator=gen)
    return tuple(t.to(DEV).contiguous() for t in (goal7, free.reshape(n, -1), qs, qe, dt))


def chunked(fn, args, chunk=256):
    """fn over row chunks of the (NP, ...) tensors in args (None passes
    through); tuple outputs are concatenated per position."""
    NP = args[0].shape[0]
    parts = []
    for i in range(0, NP, chunk):
        parts.append(fn(*(None if a is None else a[i:i + chunk] for a in args)))
    if isinstance(parts[0], tuple):
        return tuple(None if p[0] is None else torch.cat(list(p), dim=0) for p in zip(*parts))
    return torch.cat(parts, dim=0)


def compare_traj_cost_grad(tt, wt, inputs, label):
    goal7, x, qs, qe, dt = inputs
    qe = qe if tt.pin_goal else None
    args = (goal7, x, qs, qe, dt)
    c_k, g_k = tk.traj_cost_grad(tt, wt, *args, "grad")
    c_f, _ = tk.traj_cost_grad(tt, wt, *args, "cost")
    m_k = tk.traj_cost_grad(tt, wt, *args, "metrics")
    torch.cuda.synchronize()
    c_p, g_p = chunked(lambda *a: tk.traj_cost_grad_plain(tt, wt, *a, "grad"), args)
    m_p = chunked(lambda *a: tk.traj_cost_grad_plain(tt, wt, *a, "metrics"), args)
    for t in (c_k, g_k, *m_k):
        if not torch.isfinite(t).all():
            fail(f"traj_cost_grad[{label}] returned non-finite values")
    c_med, c_p99 = rel_stats(c_k, c_p, 1e-2)
    g_med, g_p99 = rel_stats(g_k, g_p, 1.0)
    pe_med, pe_p99 = rel_stats(m_k[1], m_p[1], 1e-4)
    re_med, re_p99 = rel_stats(m_k[2], m_p[2], 1e-4)
    dt_med, dt_p99 = rel_stats(m_k[4], m_p[4], 1e-4)
    out = dict(case=label, cost_rel_median=c_med, cost_rel_p99=c_p99, grad_rel_median=g_med,
               grad_rel_p99=g_p99, pos_err_rel_median=pe_med, pos_err_rel_p99=pe_p99,
               rot_err_rel_median=re_med, rot_err_rel_p99=re_p99, dt_retimed_rel_median=dt_med,
               dt_retimed_rel_p99=dt_p99,
               feasible_agree_frac=float(((m_k[3] > 0.5) == (m_p[3] > 0.5)).float().mean()),
               feasible_frac=float((m_k[3] > 0.5).float().mean()),
               cost_modes_max_rel=float(((c_f - c_k).abs().max() + (m_k[0] - c_k).abs().max())
                                        / c_k.abs().max()),
               max_abs_err=float((c_k - c_p).abs().max()))
    meds = (c_med, g_med, pe_med, re_med, dt_med)
    p99s = (c_p99, g_p99, pe_p99, re_p99, dt_p99)
    if not (max(meds) < COST_MED and max(p99s) < COST_P99):
        fail(f"traj_cost_grad[{label}] disagrees with its plain version: {out}")
    # feasibility reads a clearance against 0: a step at contact can flip on
    # another summation order, a wrong term would flip many trajectories
    if out["feasible_agree_frac"] < 0.99:
        fail(f"traj_cost_grad[{label}] feasibility disagrees with its plain version: {out}")
    if out["cost_modes_max_rel"] > 1e-5:
        fail(f"traj_cost_grad[{label}] cost, grad and metrics modes disagree: {out}")
    return out


def traj_converged(pe, re, fe):
    return (pe <= 0.005) & (re <= 0.05) & (fe > 0.5)


def compare_traj_solve(tt, wt, inputs, budget, label, seed=0, noise=None, plain_noise=None,
                       eps_smooth=None, strict=True):
    goal7, x, qs, qe, dt = inputs
    qe = qe if tt.pin_goal else None
    out_k = tk.traj_solve(tt, wt, goal7, x, qs, qe, dt, budget, seed, noise, eps_smooth)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = tk.traj_solve_plain(tt, wt, goal7, x, qs, qe, dt, budget, seed,
                                noise if plain_noise is None else plain_noise, eps_smooth)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for t in out_k:
        if not torch.isfinite(t).all():
            fail(f"traj_solve[{label}] returned non-finite values")
    xk, ck, pek, rek, fek, dtk = out_k
    xp, cp, pep, rep, fep, dtp = out_p
    rel_c = (ck - cp).abs() / (cp.abs() + 1e-2)
    dx = (xk - xp).abs().amax(dim=-1)
    res = dict(
        case=label, trajectories=int(x.shape[0]), cost_rel_median=float(rel_c.median()),
        x_agree_frac=float((dx < LOOP_X_TOL).float().mean()),
        feasible_agree_frac=float(((fek > 0.5) == (fep > 0.5)).float().mean()),
        conv_frac_kernel=float(traj_converged(pek, rek, fek).float().mean()),
        conv_frac_plain=float(traj_converged(pep, rep, fep).float().mean()),
        max_abs_err_cost=float((ck - cp).abs().max()),
        max_abs_err_x=float(dx.max()), plain_ms=plain_s * 1e3,
    )
    if strict:
        if not (res["cost_rel_median"] < LOOP_COST_MED and res["x_agree_frac"] >= LOOP_X_FRAC):
            fail(f"traj_solve[{label}] disagrees with its plain version: {res}")
    elif abs(res["conv_frac_kernel"] - res["conv_frac_plain"]) > 0.02:
        fail(f"traj_solve[{label}] converges on another share than its plain version: {res}")
    return res, out_k


def traj_compare(kin, suite):
    """Both trajectory kernels against their plain versions: Franka, the full
    spline (5, 16, 32), N_TRAJ trajectories in the motion suite's worlds
    (16-cuboid capacity); pin_goal and the speed metric on and off."""
    problems = suite["problems"]
    cap = suite["cuboid_capacity"]
    by_scen = {}
    for i, p in enumerate(problems):
        by_scen.setdefault(p["scenario"], []).append(i)
    tcfg = ct.TrajOptConfig()
    tr = BSplineTransition(tcfg.bspline)
    gen = torch.Generator(device="cpu").manual_seed(1)

    def rollout(speed):
        return dataclasses.replace(tcfg.rollout, collision_cost=dataclasses.replace(
            tcfg.rollout.collision_cost, speed_metric=speed))

    cases = [(True, False, "tabletop"), (False, False, "shelf"), (True, True, "cubby"),
             (False, True, "shelf")]
    cg = []
    for k, (pin, speed, scen) in enumerate(cases):
        pi = by_scen[scen][k % len(by_scen[scen])]
        wt = ikk.pack_world_arrays(motion_world(problems[pi]["world"], cap))
        tt = tk.build_traj_tables(kin.params, rollout(speed), tcfg.bspline, pin, DEV)
        inputs = traj_inputs(tr, problems, N_TRAJ, gen, pin)
        cg.append(compare_traj_cost_grad(
            tt, wt, inputs, f"{scen} world, pin_goal={pin}, speed_metric={speed}"))

    # the solver loop at shallow budgets, on the default objective
    tt = tk.build_traj_tables(kin.params, tcfg.rollout, tcfg.bspline, True, DEV)
    wt = ikk.pack_world_arrays(motion_world(problems[by_scen["shelf"][0]]["world"], cap))
    inputs = traj_inputs(tr, problems, N_TRAJ, gen, True)
    shallow = tk.TrajSolveBudget(mppi_iters=0, lbfgs_iters=3, history=4, n_linesearch=2)
    shallow_mppi = dataclasses.replace(shallow, mppi_iters=2, n_particles=4)
    noise = torch.randn((2, 4, N_TRAJ, tt.nfD), generator=gen).to(DEV)
    L = smooth_sample_transform(tt.n_free, kin.n_dof).to(DEV)
    sv = [compare_traj_solve(tt, wt, inputs, shallow, "lbfgs 3")[0],
          compare_traj_solve(tt, wt, inputs, shallow_mppi, "mppi 2x4 + lbfgs 3, injected noise",
                             noise=noise)[0],
          compare_traj_solve(tt, wt, inputs, shallow_mppi,
                             "mppi 2x4 + lbfgs 3, injected noise, eps_smooth", noise=noise,
                             eps_smooth=L)[0]]
    z_k = tk.traj_philox_normal(7, N_TRAJ, 2, 4, tt.nfD, DEV)
    z_p = ikk.philox_normal_plain(7, N_TRAJ, 2, 4, tt.nfD, DEV)
    torch.cuda.synchronize()
    philox = dict(max_abs_vs_plain=float((z_k - z_p).abs().max()), mean=float(z_k.mean()),
                  var=float(z_k.var()), n=int(z_k.numel()))
    if philox["max_abs_vs_plain"] > 1e-3:
        fail(f"traj_philox_normal kernel disagrees with its plain version: {philox}")
    sv.append(compare_traj_solve(tt, wt, inputs, shallow_mppi,
                                 "mppi 2x4 + lbfgs 3, in-kernel philox, eps_smooth", seed=7,
                                 plain_noise=z_k, eps_smooth=L)[0])
    return dict(traj_cost_grad=cg, traj_solve=sv, traj_philox=philox)


def traj_budget_of(tcfg) -> tk.TrajSolveBudget:
    """The `traj_solve` budget `TrajOptSolver` launches with."""
    mp, lb = tcfg.mppi, tcfg.lbfgs
    return tk.TrajSolveBudget(
        mppi_iters=mp.n_iters if tcfg.use_particle_stage else 0, n_particles=mp.n_particles,
        init_std=mp.init_std, std_decay=mp.std_decay, min_std=mp.min_std,
        temperature=mp.temperature, step_size=mp.step_size, lbfgs_iters=lb.n_iters,
        history=lb.history, max_step=lb.max_step,
    )


def compare_traj_full(kin, suite, n_per=128):
    """`traj_solve` at the trajectory optimizer's budget against its plain
    version, held to its outcome: 8 problems of the suite (every scenario), 128
    trajectories each from the problem's start to its goal configuration,
    straight seeds with knot noise."""
    problems = suite["problems"]
    tcfg = ct.TrajOptConfig()
    tr = BSplineTransition(tcfg.bspline)
    tt = tk.build_traj_tables(kin.params, tcfg.rollout, tcfg.bspline, True, DEV)
    budget = traj_budget_of(tcfg)
    gen = torch.Generator(device="cpu").manual_seed(2)
    outs_k, outs_p, plain_s = [], [], 0.0
    for pi in (0, 13, 26, 39, 45, 60, 75, 85)[: len(problems) // 11]:
        wt = ikk.pack_world_arrays(motion_world(problems[pi]["world"], suite["cuboid_capacity"]))
        goal7, x, qs, qe, dt = traj_inputs(tr, [problems[pi]], n_per, gen, True, start_noise=0.0,
                                           end_noise=0.0, knot_noise=0.1)
        outs_k.append(tk.traj_solve(tt, wt, goal7, x, qs, qe, dt, budget))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs_p.append(tk.traj_solve_plain(tt, wt, goal7, x, qs, qe, dt, budget))
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
    cat = lambda outs, i: torch.cat([o[i] for o in outs])
    ck, cp = cat(outs_k, 1), cat(outs_p, 1)
    conv_k = traj_converged(cat(outs_k, 2), cat(outs_k, 3), cat(outs_k, 4))
    conv_p = traj_converged(cat(outs_p, 2), cat(outs_p, 3), cat(outs_p, 4))
    dx = (cat(outs_k, 0) - cat(outs_p, 0)).abs().amax(dim=-1)
    res = dict(case="trajopt budget (L-BFGS 56, history 15, line search 5)", trajectories=int(ck.numel()),
               conv_frac_kernel=float(conv_k.float().mean()),
               conv_frac_plain=float(conv_p.float().mean()),
               cost_rel_median=float(((ck - cp).abs() / (cp.abs() + 1e-2)).median()),
               x_agree_frac=float((dx < LOOP_X_TOL).float().mean()), plain_ms=plain_s * 1e3)
    if abs(res["conv_frac_kernel"] - res["conv_frac_plain"]) > 0.02:
        fail(f"traj_solve converges on another share than its plain version: {res}")
    return res


def traj_compare_long_horizon(kin, suite, n=256):
    """Both trajectory kernels against their plain versions at a 64-step
    horizon (spline 5, 16, 64, pin_goal): a trajectory's step state does not
    fit in shared memory there, so the launch keeps it in global memory."""
    problems = suite["problems"]
    bs = BSplineConfig(degree=5, n_control=16, horizon=64)
    tcfg = ct.TrajOptConfig()
    tt = tk.build_traj_tables(kin.params, tcfg.rollout, bs, True, DEV)
    shelf = next(p for p in problems if p["scenario"] == "shelf")
    wt = ikk.pack_world_arrays(motion_world(shelf["world"], suite["cuboid_capacity"]))
    gen = torch.Generator(device="cpu").manual_seed(5)
    inputs = traj_inputs(BSplineTransition(bs), problems, n, gen, True)
    shallow = tk.TrajSolveBudget(mppi_iters=0, lbfgs_iters=3, history=4, n_linesearch=2)
    lib = tk._lib()
    rb, w, tc = ikk._c_robot(tt.ik), ikk._c_world(wt), tk._c_traj(tt)
    global_words = lib.traj_solve_scratch_words(ctypes.addressof(rb), ctypes.addressof(w),
                                                ctypes.addressof(tc), shallow.history, 1)
    if global_words == 0:
        fail("H=64: the step state was expected to leave shared memory")
    cg = compare_traj_cost_grad(tt, wt, inputs, "H=64, shelf world, pin_goal=True")
    sv, _ = compare_traj_solve(tt, wt, inputs, shallow, "H=64, lbfgs 3")
    return dict(horizon=64, trajectories=n, global_step_words_per_trajectory=global_words,
                traj_cost_grad=cg, traj_solve=sv)


def big_world(wt, n_far=256, cap=BIG_WORLD_CUBOIDS):
    """A world of `cap` cuboid rows: the enabled cuboids of `wt` at rows 8,
    8 + stride, ... (stride a multiple of 16), `n_far` enabled boxes 3-5 m
    away at rows 1, 17, 33, ..., every other row disabled."""
    cub = wt[0]
    en = cub[cub[:, 15] > 0.5]
    big = torch.zeros((cap, 16), dtype=torch.float32, device=DEV)
    big[:, [0, 4, 8]] = 1.0
    far = torch.arange(n_far, device=DEV) * (cap // n_far) + 1
    gen = torch.Generator(device="cpu").manual_seed(6)
    big[far, 9:12] = (3.0 + 2.0 * torch.rand((n_far, 3), generator=gen)).to(DEV)
    big[far, 12:15] = 0.2
    big[far, 15] = 1.0
    stride = (cap // len(en)) // 16 * 16
    big[torch.arange(len(en), device=DEV) * stride + 8] = en
    return (big, *wt[1:])


def compare_big_world(kin, suite, tab, goal7, q, n_ik=256, n_traj=8):
    """The four kernels against their plain versions in a world of
    BIG_WORLD_CUBOIDS cuboid rows (a shelf problem's obstacles among disabled
    rows and distant boxes), which does not fit in a block's shared memory:
    the launches compact its rows into global memory and read them there. The
    trajectories at H = 32 (step state in shared memory) and H = 64 (step
    state in global memory as well)."""
    shelf = next(p for p in suite["problems"] if p["scenario"] == "shelf")
    wt = big_world(ikk.pack_world_arrays(motion_world(shelf["world"], suite["cuboid_capacity"])))
    shallow = ikk.IKSolveBudget(mppi_iters=0, lbfgs_iters=3, history=4, n_linesearch=2,
                                warmup_iters=4, warmup_history=6)
    ik_lib, traj_lib = ikk._lib(), tk._lib()
    rb, w = ikk._c_robot(tab), ikk._c_world(wt)
    if ik_lib.ik_cost_grad_scratch_words(ctypes.addressof(rb), ctypes.addressof(w)) == 0:
        fail("big world: its rows were expected to leave shared memory (ik_cost_grad)")
    out = dict(cuboid_rows=BIG_WORLD_CUBOIDS, enabled=int((wt[0][:, 15] > 0.5).sum()),
               ik_cost_grad=compare_cost_grad(tab, wt, goal7[:n_ik], q[:n_ik], "big world"),
               ik_solve=compare_solve(tab, wt, goal7[:n_ik], q[:n_ik], shallow,
                                      "big world, shallow")[0])
    tcfg = ct.TrajOptConfig()
    gen = torch.Generator(device="cpu").manual_seed(7)
    traj_shallow = tk.TrajSolveBudget(mppi_iters=0, lbfgs_iters=3, history=4, n_linesearch=2)
    for H in (32, 64):
        bs = dataclasses.replace(tcfg.bspline, horizon=H)
        tt = tk.build_traj_tables(kin.params, tcfg.rollout, bs, True, DEV)
        tc = tk._c_traj(tt)
        if traj_lib.traj_solve_scratch_words(ctypes.addressof(rb), ctypes.addressof(w),
                                             ctypes.addressof(tc), traj_shallow.history, 1) == 0:
            fail(f"big world, H={H}: its rows were expected to leave shared memory")
        inputs = traj_inputs(BSplineTransition(bs), [shelf], n_traj, gen, True)
        out[f"traj_cost_grad_h{H}"] = compare_traj_cost_grad(tt, wt, inputs, f"big world, H={H}")
        out[f"traj_solve_h{H}"] = compare_traj_solve(tt, wt, inputs, traj_shallow,
                                                     f"big world, H={H}, lbfgs 3")[0]
    return out


def determinism(tab, wt0, g32, s32, default_b, tt, wt_t, in4, traj_b, du):
    """Two launches of each solver kernel on the same inputs give the same
    bits (the planner's "same seed -> same plan" rests on it); `ik_solve` at
    one tool frame (Franka) and at two (dual UR10e, the bench budget)."""
    a = ikk.ik_solve(tab, wt0, g32, s32, default_b, 5, None)
    b = ikk.ik_solve(tab, wt0, g32, s32, default_b, 5, None)
    c = tk.traj_solve(tt, wt_t, *in4, traj_b)
    d = tk.traj_solve(tt, wt_t, *in4, traj_b)
    dual_b = budget_of(du["cfg"])
    e = ikk.ik_solve(du["tab"], du["wt"], du["goal7"], du["lm_flat"], dual_b, 5, None)
    f = ikk.ik_solve(du["tab"], du["wt"], du["goal7"], du["lm_flat"], dual_b, 5, None)
    torch.cuda.synchronize()
    res = dict(ik_solve_n32_bitwise_equal=all(torch.equal(x, y) for x, y in zip(a, b)),
               traj_solve_np4_bitwise_equal=all(torch.equal(x, y) for x, y in zip(c, d)),
               ik_solve_dual_n3200_bitwise_equal=all(torch.equal(x, y) for x, y in zip(e, f)))
    if not all(res.values()):
        fail(f"two launches on the same inputs differ: {res}")
    return res


def profile_plans(planner, kin, suite, out_dir):
    """`torch.profiler` over two first-attempt plans: the device's busy share
    of each plan's host window, kernel time by name and the longest idle gaps
    between device work."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cap = suite["cuboid_capacity"]
    inputs = [problem_inputs(kin, p, cap) for p in suite["problems"][:2]]
    attempts = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, (world, goal, start) in enumerate(inputs):
            with record_function(f"plan_{i}"):
                res = planner.plan_pose(world, goal, start, seed=i)
                res.trajectory.position.cpu()
            attempts.append(planner.last_attempts)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "plan_trace.json")
    prof.export_chrome_trace(path)
    out = dict(phase="profile", plans=len(inputs), attempts=attempts, trace=path)
    out.update(trace_busy(path, "plan_", len(inputs)))
    return out


def trace_busy(path, prefix, n_windows):
    """Device busy share of the host windows named `prefix*` in a chrome trace
    of `torch.profiler`: device kernel and copy time inside the windows over
    their length, kernel time by name and the longest idle gaps."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    wins = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith(prefix))
    out = dict(device_events=len(dev))
    if not dev or len(wins) != n_windows:
        # no device time in the trace: the CUDA-event counts stand instead
        out["note"] = "the profiler recorded no device time; see the CUDA-event counts"
        return out
    window = busy = 0.0
    n_in = 0
    gaps, by_name = [], {}
    for t0, t1 in wins:
        window += t1 - t0
        prev_end, prev_name = t0, "start of window"
        for a, b, name in dev:
            if b <= t0 or a >= t1:
                continue
            n_in += 1
            a, b = max(a, t0), min(b, t1)
            short = name.split("(")[0][:60]
            by_name[short] = by_name.get(short, 0.0) + (b - a)
            if a > prev_end:
                gaps.append((a - prev_end, prev_name, short))
            if b > prev_end:
                busy += b - max(a, prev_end)
                prev_end, prev_name = b, short
        if t1 > prev_end:
            gaps.append((t1 - prev_end, prev_name, "end of window"))
    gaps.sort(reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out.update(window_ms=window / 1e3, device_events_in_windows=n_in,
               device_busy_ms=busy / 1e3, busy_share=busy / window,
               idle_share=1.0 - busy / window,
               kernel_ms_by_name={k: v / 1e3 for k, v in top},
               longest_idle_gaps=[dict(ms=g / 1e3, after=a, before=b) for g, a, b in gaps[:8]],
               idle_gaps_over_50us=sum(1 for g, _, _ in gaps if g > 50.0),
               idle_ms_in_gaps_over_50us=sum(g for g, _, _ in gaps if g > 50.0) / 1e3)
    return out


def traj_eval_flops(tt: tk.TrajTables, world_tabs, grad: bool) -> float:
    """Float operations of one trajectory evaluation: per step FK, the
    self-collision pairs and the swept scene term (live spheres x K samples x
    enabled obstacles), bounds and smoothness; the terminal pose; with the
    gradient the reverse pass and the knot gradient."""
    tab = tt.ik
    n_rev = sum(1 for kind, _, _ in tab.link_host if kind == 1)
    fk = tab.L * (45 + 18) + n_rev * (30 + 45)
    spline = 4 * 2 * tt.n_ctrl * tt.D
    n_live = int((tab.sph_f[:, 3] >= 0).sum())
    kc, ks, kp, ky = (int((t[:, -1] > 0.5).sum()) for t in world_tabs)
    scene = n_live * tt.K * (kc * 45 + ks * 12 + kp * 32 + ky * 50 + 10)
    step = spline + fk + tab.S * 18 + tab.P * 12 + scene + 30 * tt.D
    f = tt.H * step + 120
    if grad:
        f += tt.H * (tab.L * 30 + tab.S * 15 + n_live * tt.K * 12) + 40
        f += tt.H * 4 * 2 * tt.nfD
    return float(f)


def traj_solve_flops(tt, world_tabs, b: tk.TrajSolveBudget) -> float:
    e = lambda grad: traj_eval_flops(tt, world_tabs, grad)
    f = 0.0
    if b.mppi_iters > 0:
        f += (2 + b.mppi_iters * b.n_particles) * e(False)
    f += e(True) + b.lbfgs_iters * (b.n_linesearch * e(False) + e(True))
    return f + e(False)


def problem_inputs(kin, p, cap):
    world = motion_world(p["world"], cap)
    goal = ct.Pose(torch.tensor([p["goal_pose"][:3]], device=DEV),
                   torch.tensor([p["goal_pose"][3:]], device=DEV))
    start = ct.JointState.from_position(torch.tensor([p["q_start"]], device=DEV), kin.joint_names)
    return world, goal, start


KERNEL_COUNTS = {"ik_solve": ikk.ik_solve, "ik_cost_grad": ikk.ik_cost_grad,
                 "traj_solve": tk.traj_solve, "traj_cost_grad": tk.traj_cost_grad}


def reset_counts():
    """Every kernel's launch count to 0: the IK and trajectory kernels'
    (`counts`) and the pair kernels' (`sc_counts`)."""
    for fn in (*KERNEL_COUNTS.values(), *SC_KERNELS.values()):
        fn.launches = 0


def counts():
    return {k: fn.launches for k, fn in KERNEL_COUNTS.items()}


def plan_phase(kin, suite, t_start, deadline_s=780.0):
    """The main path of motion generation: `MotionPlanner(kin.params)` with the
    default `MotionPlanConfig()`, one plan per problem of the suite (B = 1),
    after a warm-up of two problems and one unreachable goal (the retry path
    with PRM graph seeding). Returns (summary, launches of the main path)."""
    problems, cap = suite["problems"], suite["cuboid_capacity"]
    planner = ct.MotionPlanner(kin.params)
    n_to = planner.cfg.trajopt.finetune_attempts + 1

    def run(p, seed, attribute=False):
        world, goal, start = problem_inputs(kin, p, cap)
        t0 = time.perf_counter()
        res = planner.plan_pose(world, goal, start, seed=seed, attribute=attribute)
        res.trajectory.position.cpu()  # the result on the host ends the plan
        return res, time.perf_counter() - t0, goal, start

    for i in range(2):
        run(problems[i], 1000 + i)
    far = dict(problems[0])
    far["goal_pose"] = [2.5, 2.5, 2.5] + list(far["goal_pose"][3:])
    res_far, _, _, _ = run(far, 999)
    if planner.last_attempts != planner.cfg.max_attempts or bool(res_far.success.any()):
        fail(f"unreachable goal: attempts {planner.last_attempts}, success {res_far.success}")
    if not torch.isfinite(res_far.trajectory.position).all():
        fail("unreachable goal: non-finite trajectory")

    reset_counts()
    rows, cut = [], False
    for i, p in enumerate(problems):
        if i >= 30 and time.perf_counter() - t_start > deadline_s:
            cut = True
            break
        before = counts()
        res, dt_wall, goal, start = run(p, i)
        A = planner.last_attempts
        d = {k: v - before[k] for k, v in counts().items()}
        if d["ik_solve"] != A or d["traj_solve"] != n_to * A or d["traj_cost_grad"] < A:
            fail(f"problem {i}: {A} attempts launched {d}")
        st = res.solver_trajectory
        for name, t in (("trajectory", res.trajectory.position), ("solver position", st.position),
                        ("solver velocity", st.velocity), ("solver jerk", st.jerk),
                        ("position_error", res.position_error), ("motion_time", res.motion_time)):
            if not torch.isfinite(t).all():
                fail(f"problem {i}: {name} has non-finite values")
        ok = bool(res.success[0])
        if ok:
            q0 = start.position[0]
            d0 = max(float((st.position[0, 0] - q0).abs().max()),
                     float((res.trajectory.position[0, 0] - q0).abs().max()))
            if d0 > 1e-5:
                fail(f"problem {i}: the trajectory starts {d0} rad from q_start")
            tp = kin.tool_pose(st.position[:, -1])
            pe = float((tp.position.reshape(-1, 3)[0] - goal.position[0]).norm())
            dot = float((tp.quaternion.reshape(-1, 4)[0] * goal.quaternion[0]).sum().abs())
            re = 2.0 * float(torch.acos(torch.clamp(torch.tensor(dot), max=1.0)))
            if pe > 0.005 + 1e-4 or re > 0.05 + 1e-4:
                fail(f"problem {i}: terminal FK misses the goal by {pe} m, {re} rad")
        q = st.position[0].cpu().numpy()
        rows.append(dict(
            scenario=p["scenario"], success=ok, plan_time=dt_wall, attempts=A,
            position_error=float(res.position_error[0]), rotation_error=float(res.rotation_error[0]),
            motion_time=float(res.motion_time[0]),
            path_length=float(np.linalg.norm(np.diff(q, axis=0), axis=-1).sum()),
            max_jerk=float(st.jerk[0].abs().max()),
        ))
    launches = counts()

    okr = [r for r in rows if r["success"]]
    t = np.asarray([r["plan_time"] for r in rows])
    t1 = [r["plan_time"] for r in rows if r["attempts"] == 1]
    mean_of = lambda k: float(np.mean([r[k] for r in okr])) if okr else -1.0
    p98_of = lambda k: float(np.percentile([r[k] for r in okr], 98)) if okr else -1.0
    summary = dict(
        phase="plan", problems_run=len(rows), problems_in_suite=len(problems),
        cut_by_deadline=cut, success_rate=len(okr) / len(rows),
        plan_time_mean_ms=float(t.mean() * 1e3), plan_time_median_ms=float(np.median(t) * 1e3),
        plan_time_p75_ms=float(np.percentile(t, 75) * 1e3),
        plan_time_p98_ms=float(np.percentile(t, 98) * 1e3),
        plan_time_first_attempt_p98_ms=float(np.percentile(t1, 98) * 1e3) if t1 else -1.0,
        retry_rate=float(np.mean([r["attempts"] > 1 for r in rows])),
        position_error_mm_mean=mean_of("position_error") * 1e3,
        position_error_mm_p98=p98_of("position_error") * 1e3,
        position_error_mm_largest=[dict(problem=i, mm=r["position_error"] * 1e3)
                                   for i, r in sorted(enumerate(rows), key=lambda ir:
                                                      -ir[1]["position_error"])[:5]
                                   if r["success"]],
        motion_time_mean_s=mean_of("motion_time"), motion_time_p98_s=p98_of("motion_time"),
        path_length_mean=mean_of("path_length"), max_jerk_mean=mean_of("max_jerk"),
        max_jerk_p98=p98_of("max_jerk"),
        per_scenario={s: dict(n=sum(r["scenario"] == s for r in rows),
                              success=float(np.mean([r["success"] for r in rows if r["scenario"] == s])))
                      for s in sorted({r["scenario"] for r in rows})},
        launches=launches, attempts=int(sum(r["attempts"] for r in rows)),
    )
    # per-phase attribution: the device synchronised after every phase
    acc = {}
    for i in range(min(6, len(problems))):
        run(problems[i], i, attribute=True)
        for k, v in planner.last_attribution.items():
            acc.setdefault(k, []).append(v)
    summary["attribution_mean_ms"] = {k: float(np.mean(v)) for k, v in sorted(acc.items())}
    if summary["success_rate"] < 0.95:
        fail(f"motion-generation success rate {summary['success_rate']} is under 0.95: {summary}")
    return summary, launches, planner


# ---------------------------------------------------------------------------
# Dual-arm IK (two tool frames): the reference bench `bench.py:bench_dual_ur10e_cfik`
# ---------------------------------------------------------------------------
def dual_scene():
    """`bench.py:250-255`: one table cuboid under both arms."""
    return gt.Scene().add(
        gt.Cuboid(name="table", pose=[0.0, 0.0, -0.1, 1, 0, 0, 0], dims=[4.0, 4.0, 0.2])
    )


def dual_ik_config():
    """`bench.py:271-283`: 32 seeds, LM seed 12, pose-only warm-up 32, no
    MPPI, L-BFGS 24 with history 10, a 6-point kernel line search."""
    return ct.IKConfig(
        n_seeds=N_SEEDS, use_lm_seed=True, lm_seed_iters=12, warmup_iters=32,
        use_particle_stage=False, lbfgs=LBFGSConfig(history=10, n_iters=24), kernel_linesearch=6,
    )


def dual_goals(kin, world):
    """`bench.py:258-269`: FK of collision-free configurations drawn uniformly
    in the joint limits clipped to +-pi (RandomState(11), rejection by
    `RobotSceneCollision.validate`) -> goals batch (100, 2 tools)."""
    p = kin.params
    rsc = ct.RobotSceneCollision(p)
    rng = np.random.RandomState(11)
    lo = np.maximum(p.joint_limits.lower.cpu().numpy(), -np.pi)
    hi = np.minimum(p.joint_limits.upper.cpu().numpy(), np.pi)
    pool, got = [], 0
    while got < N_GOALS:
        cand = rng.uniform(lo, hi, (4 * N_GOALS, p.n_dof)).astype(np.float32)
        ok = rsc.validate(world, torch.as_tensor(cand, device=DEV)).cpu().numpy()
        pool.append(cand[ok])
        got += int(ok.sum())
    q_goal = torch.as_tensor(np.concatenate(pool)[:N_GOALS], device=DEV)
    st = kin.compute_kinematics(q_goal)
    return ct.Pose(st.tool_pose.position, st.tool_pose.quaternion)


def dual_setup():
    """The dual-arm robot, world, goals and solver, and the kernel inputs of
    one solve: the (N, 14) goal block, the Halton seeds and the LM-refined
    seeds the kernel is given (N = 100 goals x 32 seeds)."""
    kin = ct.Kinematics.from_robot_yaml(ct.robot_config_path("dual_ur10e"))
    world = ct.compile_scene(dual_scene())
    goals = dual_goals(kin, world)
    cfg = dual_ik_config()
    solver = ct.IKSolver(kin.params, cfg)
    D, T = kin.n_dof, kin.params.n_tools
    N = N_GOALS * N_SEEDS
    seeds = solver.generate_seeds(N_GOALS, kin.params.retract_config)
    goal_s = ct.Goal.from_pose(goals).tile_seeds(N_SEEDS)
    lm_seeds, _ = solver._lm_warm_start(goal_s, seeds)
    goal7 = torch.cat([goal_s.goal_pos[..., 0, :, :], goal_s.goal_quat[..., 0, :, :]], dim=-1)
    return dict(kin=kin, world=world, goals=goals, cfg=cfg, solver=solver,
                tab=solver._ik_cost.tables, wt=ikk.pack_world_arrays(world),
                goal7=goal7.reshape(N, 7 * T).contiguous(), goal_s=goal_s, seeds=seeds,
                seeds_flat=seeds.reshape(N, D).contiguous(),
                lm_flat=lm_seeds.reshape(N, D).contiguous(), N=N, D=D, T=T)


def dual_phase(du, out_dir):
    """Phase `dual`: `ik_cost_grad` and `ik_solve` at T = 2 against their plain
    versions on 3200 configurations, then the main path
    (`IKSolver.solve_pose` over the 100 goals x 32 seeds at the bench budget):
    time per solve, the LM stage and the kernel apart, success, pose error,
    launches, and a `torch.profiler` trace of one solve and of the LM stage
    alone (busy share, kernels by name). Returns (summary, comparison numbers,
    kernel times)."""
    tab, wt, goal7, N, D = du["tab"], du["wt"], du["goal7"], du["N"], du["D"]
    gen = torch.Generator(device="cpu").manual_seed(5)
    lo, hi = (torch.as_tensor(b, device=DEV) for b in du["kin"].params.dof_clip_bounds(np.pi))
    q_rand = lo + (hi - lo) * torch.rand((N, D), generator=gen).to(DEV)
    cg = [compare_cost_grad(tab, wt, goal7, du["seeds_flat"], "dual/seeds"),
          compare_cost_grad(tab, wt, goal7, du["lm_flat"], "dual/lm-seeds"),
          compare_cost_grad(tab, wt, goal7, q_rand, "dual/random")]
    shallow = ikk.IKSolveBudget(mppi_iters=0, lbfgs_iters=3, history=4, n_linesearch=2,
                                warmup_iters=4, warmup_history=6)
    bench_b = budget_of(du["cfg"])
    sv_shallow, _ = compare_solve(tab, wt, goal7, du["lm_flat"], shallow, "dual/shallow")
    sv_rand, _ = compare_solve(tab, wt, goal7, q_rand, shallow, "dual/shallow/random")
    sv_bench, _ = compare_solve(tab, wt, goal7, du["lm_flat"], bench_b, "dual/bench-budget",
                                strict=False)

    ms_cg = time_ms(lambda: ikk.ik_cost_grad(tab, wt, goal7, du["seeds_flat"], True), reps=20, warm=2)
    plain_cg = time_ms(lambda: ikk.ik_cost_grad_plain(tab, wt, goal7, du["seeds_flat"], True), reps=5)
    ms_sv = time_ms(lambda: ikk.ik_solve(tab, wt, goal7, du["lm_flat"], bench_b, 0, None), reps=10)

    # ---- the main path: IKSolver.solve_pose, 100 goals x 32 seeds ------------------------
    slv, world, goals, kin = du["solver"], du["world"], du["goals"], du["kin"]
    seed_state = kin.params.retract_config
    res = slv.solve_pose(world, goals, seed_state=seed_state)  # warm-up solve
    torch.cuda.synchronize()
    reps = 10
    reset_counts()
    times = []
    for i in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        res = slv.solve_pose(world, goals, seed=i, seed_state=seed_state)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    launches = counts()
    if launches["ik_solve"] != reps or launches["ik_cost_grad"] != 0:
        fail(f"dual: {reps} solves launched {launches} (one ik_solve each, no ik_cost_grad)")
    # the LM stage and the kernel apart, the device synchronised between them
    lm_t, k_t = [], []
    for i in range(reps):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        e[0].record()
        lm_seeds, _ = slv._lm_warm_start(du["goal_s"], du["seeds"])
        e[1].record()
        torch.cuda.synchronize()
        e[2].record()
        slv._solve_kernel(goal7, lm_seeds.reshape(N, D).contiguous(), i, world)
        e[3].record()
        torch.cuda.synchronize()
        lm_t.append(e[0].elapsed_time(e[1]))
        k_t.append(e[2].elapsed_time(e[3]))
    # where a solve's time goes: one traced solve, and the LM stage alone
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("dual_solve"):
            slv.solve_pose(world, goals, seed=0, seed_state=seed_state).solution.cpu()
        with record_function("dual_lm"):
            slv._lm_warm_start(du["goal_s"], du["seeds"])[0].cpu()
    path = os.path.join(out_dir, "dual_trace.json")
    prof.export_chrome_trace(path)
    trace = dict(trace=path, solve=trace_busy(path, "dual_solve", 1),
                 lm=trace_busy(path, "dual_lm", 1))
    for name in ("solution", "position_error", "rotation_error", "cost", "seed_solutions"):
        if not torch.isfinite(getattr(res, name)).all():
            fail(f"dual: IKResult.{name} has non-finite values")
    if res.solution.shape != (N_GOALS, D) or res.seed_solutions.shape != (N_GOALS, N_SEEDS, D):
        fail("dual: unexpected result shapes")
    # the repo's own check: FK of a successful solution reaches both tools'
    # goals, and the objective kernel gives the reported cost
    st = kin.compute_kinematics(res.solution)
    fk_err = (st.tool_pose.position - goals.position).norm(dim=-1).amax(dim=-1)
    ok = res.success
    if bool(ok.any()) and float(fk_err[ok].max()) > 0.005 + 1e-4:
        fail(f"dual: FK of a successful solution misses a goal by {float(fk_err[ok].max())}")
    g7 = torch.cat([goals.position, goals.quaternion], dim=-1).reshape(N_GOALS, 7 * du["T"])
    c_chk, _ = slv._ik_cost(g7.contiguous(), res.solution.contiguous(), world)
    torch.cuda.synchronize()
    c_rel = float(((c_chk - res.cost).abs() / (res.cost.abs() + 1e-2)).max())
    if c_rel > 1e-3:
        fail(f"dual: reported cost differs from ik_cost_grad on the solution by {c_rel}")
    sr = float(ok.float().mean())
    pe = res.position_error.double().cpu().numpy()
    summary = dict(
        phase="dual", robot="dual_ur10e", tools=du["T"], dof=D, links=tab.L, spheres=tab.S,
        live_pairs=tab.P, goals=N_GOALS, seeds=N_SEEDS,
        budget="LM seed 12, warm-up 32, no MPPI, L-BFGS 24 x history 10, line search 6",
        success_rate=sr, position_error_mm_p90=float(np.percentile(pe, 90) * 1e3),
        median_rotation_error=float(res.rotation_error.median()),
        ms_per_solve=statistics.median(times), ms_per_solve_min=min(times),
        lm_ms=statistics.median(lm_t), lm_ms_min=min(lm_t),
        kernel_ms=statistics.median(k_t), kernel_ms_min=min(k_t),
        solves=reps, launches_per_solve={k: v / reps for k, v in launches.items()},
        cost_check_rel_max=c_rel, profile=trace, gpu=gpu_line(),
    )
    if sr < 0.95:
        fail(f"dual-arm success rate {sr} is under 0.95: {summary}")
    cmp = dict(ik_cost_grad=cg, ik_solve=[sv_shallow, sv_rand, sv_bench])
    timing = dict(ms_cg=ms_cg, plain_cg=plain_cg, ms_sv=ms_sv, plain_sv=sv_bench["plain_ms"],
                  bench_b=bench_b, launches=launches, sv_bench=sv_bench,
                  max_abs_err_cg=max(c["max_abs_err"] for c in cg),
                  max_abs_err_sv=max(c["max_abs_err_x"] for c in (sv_shallow, sv_rand)))
    return summary, cmp, timing


# ---------------------------------------------------------------------------
# MPC (MPCSolver over traj_solve) and the generic route
# ---------------------------------------------------------------------------
MPC_TICKS, MPC_REPS = 50, 6
# Success gates of phase `generic`, fixed before its first run on the card:
# the JAX package's own CPU result on the same problems
# (`tests/test_torch_generic_reference.py`: 1.0 for both) less 0.1.
GENERIC_GATE = dict(ik_goal_set=0.9, plan_cspace=0.9)


def mpc_scene():
    """The reference bench's MPC world (`bench.py:bench_mpc`): a table and a
    "drone" sphere that moves 4 mm a tick."""
    return gt.Scene().add(
        gt.Cuboid(name="table", pose=[0.4, 0.0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        gt.SphereObstacle(name="drone", pose=[0.5, 0.4, 0.6, 1, 0, 0, 0], radius=0.08),
    )


def mpc_budget(cfg) -> tk.TrajSolveBudget:
    """The `traj_solve` budget `MPCSolver` launches with each tick."""
    mp, lb = cfg.mppi, cfg.lbfgs
    return tk.TrajSolveBudget(
        mppi_iters=mp.n_iters if cfg.use_particle_stage else 0, n_particles=mp.n_particles,
        init_std=mp.init_std, std_decay=mp.std_decay, min_std=mp.min_std,
        temperature=mp.temperature, step_size=mp.step_size,
        lbfgs_iters=lb.n_iters if cfg.use_gradient_stage else 0, history=lb.history,
        max_step=lb.max_step,
    )


def mpc_inputs(kin, cfg, n, gen):
    """n MPC ticks' trajectory inputs near the bench episode's: start around
    the retract configuration, goal around FK(retract + 0.3), the held-position
    warm start with knot noise, dt = control_dt -> (goal7, x, q_start, None, dt)."""
    D = kin.n_dof
    q0 = kin.params.retract_config[None].cpu() + 0.05 * torch.randn((n, D), generator=gen)
    st = kin.compute_kinematics((q0 + 0.3 + 0.05 * torch.randn((n, D), generator=gen)).to(DEV))
    goal7 = torch.cat([st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0]], dim=-1)
    tr = BSplineTransition(cfg.bspline)
    x = tr.linear_seed(q0, q0) + 0.02 * torch.randn((n, cfg.bspline.n_free, D), generator=gen)
    dt = torch.full((n,), cfg.control_dt)
    return (goal7.contiguous(), x.reshape(n, -1).to(DEV).contiguous(), q0.to(DEV).contiguous(),
            None, dt.to(DEV))


def compare_mpc_kernel(kin, n_traj=64):
    """`traj_solve` at MPC's shape (spline (3, 10, 24), no pin, MPPI 64 x 2 with
    the smoothing matrix, L-BFGS history 8) against its plain version on the
    same injected normals: Franka, the MPC world, 64 trajectories, held to the
    strict limits of the shallow solves (LOOP_X_FRAC within LOOP_X_TOL, median
    relative cost error < LOOP_COST_MED) and to equal feasibility, at the full
    MPC budget and at L-BFGS 4. Then the time at the path's NP = 1 (in-kernel
    noise)."""
    cfg = ct.MPCConfig()
    b = mpc_budget(cfg)
    tt = tk.build_traj_tables(kin.params, cfg.rollout, cfg.bspline, False, DEV)
    wt = ikk.pack_world_arrays(ct.compile_scene(mpc_scene(), device=DEV))
    gen = torch.Generator(device="cpu").manual_seed(5)
    inputs = mpc_inputs(kin, cfg, n_traj, gen)
    noise = torch.randn((b.mppi_iters, b.n_particles, n_traj, tt.nfD), generator=gen).to(DEV)
    L = smooth_sample_transform(tt.n_free, kin.n_dof).to(DEV)
    label = f"mpc shape, {n_traj} trajectories, injected noise, eps_smooth"
    res, _ = compare_traj_solve(tt, wt, inputs, b, f"{label}, full budget", noise=noise,
                                eps_smooth=L)
    shallow = dataclasses.replace(b, lbfgs_iters=4)
    res["shallow_lbfgs4"], _ = compare_traj_solve(tt, wt, inputs, shallow,
                                                  f"{label}, L-BFGS 4", noise=noise, eps_smooth=L)
    for r in (res, res["shallow_lbfgs4"]):
        if r["feasible_agree_frac"] != 1.0:
            fail(f"traj_solve[{r['case']}] differs from its plain version in feasibility: {r}")
    in1 = tuple(None if t is None else t[:1] for t in inputs)
    res["ms_np1"] = time_ms(lambda: tk.traj_solve(tt, wt, *in1, b, 3, None, L), reps=20, warm=2)
    res["plain_ms_np1"] = time_ms(lambda: tk.traj_solve_plain(tt, wt, *in1, b, 3, None, L),
                                  reps=1, warm=0)
    f1 = traj_solve_flops(tt, wt, b)
    # bytes: goal, knots, start and dt in; knots and five metrics out
    res["bound_ms_np1"], res["bound_by_np1"] = bound_ms(f1, (7 + 2 * tt.nfD + kin.n_dof + 6) * 4)
    res["sm_floor_ms_np1"] = sm_floor_ms(f1, 1)
    res["shape"] = (f"NP=1 trajectory, spline (3, 10, 24), D={kin.n_dof}, MPPI "
                    f"{b.n_particles} x {b.mppi_iters} + eps_smooth, L-BFGS {b.lbfgs_iters} x line "
                    f"search {b.n_linesearch}, history {b.history}, MPC world")
    return res


def mpc_phase(kin, out_dir):
    """MPC's main path through the public API: the reference bench's episode
    (`bench.py:bench_mpc`): Franka, default `MPCConfig()` (= tasks/mpc.yml),
    B = 1, goal FK(retract + 0.3), `run_ticks` over 50 stacked worlds with the
    drone moving 4 mm a tick, 6 timed repetitions; a blocking `step`; one
    `run_ticks` under `torch.profiler`; then the tracking episode of the JAX
    package's tests (B = 2, 40 `step`s, perfect tracking). Returns (summary,
    launches of the timed episodes)."""
    cfg = ct.MPCConfig.from_yaml(ct.content_path("tasks", "mpc.yml"))
    if cfg != ct.MPCConfig():
        fail("tasks/mpc.yml does not load to the default MPCConfig()")
    solver = ct.MPCSolver(kin.params, cfg, device=DEV)
    world = ct.compile_scene(mpc_scene(), device=DEV)
    q0 = kin.params.retract_config[None]
    st = kin.compute_kinematics(q0 + 0.3)
    goal = solver.make_goal(ct.Pose(st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0]))
    state = solver.setup(q0)
    js = ct.JointState.from_position(q0, kin.joint_names)
    if not solver._use_kernel(goal):
        fail("the MPC bench goal does not take the kernel route")
    worlds = ct.stack_worlds([world.update_obstacle_pose("drone", [0.5, 0.4 - 0.004 * t, 0.6],
                                                         [1, 0, 0, 0]) for t in range(MPC_TICKS)])
    res, _ = solver.run_ticks(worlds, goal, state, js)  # warm-up
    res.command.position.cpu()

    reset_counts()
    times, enqueue = [], []
    for _ in range(MPC_REPS):
        t0 = time.perf_counter()
        res, _ = solver.run_ticks(worlds, goal, state, js)
        t1 = time.perf_counter()
        res.command.position.cpu()  # the commands on the host end the episode
        times.append((time.perf_counter() - t0) / MPC_TICKS)
        enqueue.append((t1 - t0) / MPC_TICKS)
    launches = counts()
    want = dict(ik_solve=0, ik_cost_grad=0, traj_solve=MPC_REPS * MPC_TICKS, traj_cost_grad=0)
    if launches != want:
        fail(f"MPC episodes launched {launches}, expected {want} (one traj_solve a tick)")
    for name in ("position", "velocity", "acceleration"):
        if not torch.isfinite(getattr(res.command, name)).all():
            fail(f"MPC command {name} has non-finite values")
    feasible_rate = float(res.feasible.float().mean())

    # a blocking tick: step() and the command on the host
    res1, state1 = solver.step(world, goal, state, js)
    res1.command.position.cpu()
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        r, _ = solver.step(world, goal, state1, js)
        r.command.position.cpu()
        lat.append((time.perf_counter() - t0) * 1e3)

    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("mpc_ticks"):
            r, _ = solver.run_ticks(worlds, goal, state, js)
            r.command.position.cpu()
    path = os.path.join(out_dir, "mpc_trace.json")
    prof.export_chrome_trace(path)
    busy = trace_busy(path, "mpc_ticks", 1)

    # tracking: B = 2, 40 ticks, perfect tracking (tests/test_solver_mpc.py)
    qb = kin.params.retract_config[None].expand(2, kin.n_dof)
    qg = qb + torch.tensor([0.3, 0.1, -0.2, 0.2, 0.1, -0.1, 0.2], device=DEV)
    stg = kin.compute_kinematics(qg)
    goal2 = solver.make_goal(ct.Pose(stg.tool_pose.position[:, 0], stg.tool_pose.quaternion[:, 0]))
    state2, js2 = solver.setup(qb), ct.JointState.from_position(qb, kin.joint_names)
    errs = []
    for _ in range(40):
        r, state2 = solver.step(world, goal2, state2, js2)
        js2 = ct.JointState(position=r.command.position, velocity=r.command.velocity,
                            acceleration=r.command.acceleration, joint_names=kin.joint_names)
        errs.append(r.pos_err.amax())
    errs = [float(e) for e in errs]
    if not torch.isfinite(js2.position).all():
        fail("MPC tracking: non-finite command")

    tick = [t * 1e3 for t in times]
    summary = dict(
        phase="mpc", ticks=MPC_TICKS, repetitions=MPC_REPS, batch=1,
        tick_ms_median=statistics.median(tick), tick_ms_min=min(tick),
        hz=1e3 / statistics.median(tick), hz_budget=50.0,
        host_enqueue_ms_per_tick_median=statistics.median(enqueue) * 1e3,
        feasible_rate=feasible_rate, step_latency_ms_median=statistics.median(lat),
        step_latency_ms_min=min(lat), traj_solve_launches_per_tick=launches["traj_solve"]
        / (MPC_REPS * MPC_TICKS), launches=launches, profile=dict(trace=path, **busy),
        tracking=dict(batch=2, ticks=40, first_pos_err=errs[0], final_pos_err=errs[-1],
                      pos_err_every_10=errs[::10]),
    )
    if feasible_rate < 0.9:
        fail(f"MPC feasible rate {feasible_rate} is under 0.9: {summary}")
    if not (errs[-1] < 0.05 and errs[-1] < 0.5 * errs[0]):
        fail(f"MPC tracking: final pose error {errs[-1]} (first {errs[0]}): {summary}")
    return summary, launches


def goal_set_problems(kin, world, n_goals=32, g=4):
    """The goal-set IK problems of `tests/test_torch_generic_reference.py`:
    FK of the first n_goals * g collision-free Halton configurations, as
    (n_goals, g, 1) poses."""
    q, ok = ct.RobotSceneCollision(kin.params).sample(world, n_goals * g)
    if not bool(ok.all()):
        fail(f"only {int(ok.sum())} of {n_goals * g} collision-free goal configurations found")
    tp = kin.compute_kinematics(q).tool_pose
    return ct.Pose(tp.position[:, 0].reshape(n_goals, g, 1, 3).contiguous(),
                   tp.quaternion[:, 0].reshape(n_goals, g, 1, 4).contiguous())


def generic_phase(kin, suite):
    """The generic route on the card: goal-set IK (32 goals x 4 poses, the
    default `IKConfig()`, 32 seeds, table world) and `plan_cspace` on every
    6th problem of the motion suite (the goal is the problem's stored IK
    solution `q_goal_oracle`), the default `MotionPlanConfig()`. Neither
    launches an IK or trajectory kernel; their self-collision sums run the
    pair kernels."""
    world = ct.compile_scene(table_scene(), device=DEV)
    goals = goal_set_problems(kin, world)
    solver = ct.IKSolver(kin.params, device=DEV)
    if solver._use_kernel(ct.Goal.from_pose(goals)):
        fail("a goal set took the kernel route")
    res = solver.solve_pose(world, goals)  # warm-up
    reset_counts()
    ms = []
    for i in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        res = solver.solve_pose(world, goals, seed=i)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    ok = res.success
    fk = kin.compute_kinematics(res.solution).tool_pose.position[:, 0]
    near = (fk[:, None] - goals.position[:, :, 0]).norm(dim=-1).amin(dim=1)
    if bool(ok.any()) and float(near[ok].max()) > 0.005 + 1e-4:
        fail(f"goal-set IK: a successful solution is {float(near[ok].max())} m from its goals")
    if not torch.isfinite(res.solution).all():
        fail("goal-set IK: non-finite solution")
    ik = dict(goals=int(goals.position.shape[0]), goal_set=int(goals.position.shape[1]),
              seeds=solver.cfg.n_seeds, success_rate=float(ok.float().mean()),
              ms_per_solve_median=statistics.median(ms), ms_per_solve_min=min(ms),
              median_position_error=float(res.position_error.median()))

    planner = ct.MotionPlanner(kin.params, device=DEV)
    cap = suite["cuboid_capacity"]
    probs = suite["problems"][::6]
    rows = []
    for i, p in enumerate(probs):
        w = motion_world(p["world"], cap)
        start = ct.JointState.from_position(torch.tensor([p["q_start"]], device=DEV), kin.joint_names)
        goal = ct.JointState.from_position(torch.tensor([p["q_goal_oracle"]], device=DEV),
                                           kin.joint_names)
        t0 = time.perf_counter()
        r = planner.plan_cspace(w, goal, start, seed=i)
        r.trajectory.position.cpu()
        dt_wall = time.perf_counter() - t0
        st = r.solver_trajectory
        for name, t in (("trajectory", r.trajectory.position), ("jerk", st.jerk)):
            if not torch.isfinite(t).all():
                fail(f"plan_cspace problem {i}: non-finite {name}")
        d0 = float((st.position[0, 0] - start.position[0]).abs().max())
        d1 = float((st.position[0, -1] - goal.position[0]).abs().max())
        if d0 > 1e-4 or d1 > 1e-4:
            fail(f"plan_cspace problem {i}: the trajectory misses its ends by {d0}, {d1} rad")
        rows.append(dict(scenario=p["scenario"], success=bool(r.success[0]),
                         plan_ms=dt_wall * 1e3, motion_time=float(r.motion_time[0]),
                         max_jerk=float(st.jerk[0].abs().max())))
    launches, pair_launches = counts(), sc_counts()
    if any(launches.values()):
        fail(f"the generic route launched IK or trajectory kernels: {launches}")
    if pair_launches["sc_pair_cost"] < 1 or pair_launches["sc_pair_grad"] < 1:
        fail(f"the generic route's pair sum did not go through the pair kernels: {pair_launches}")
    t = np.asarray([r["plan_ms"] for r in rows])
    okr = [r for r in rows if r["success"]]
    cs = dict(problems=len(rows), success_rate=len(okr) / len(rows),
              plan_ms_mean=float(t.mean()), plan_ms_median=float(np.median(t)),
              plan_ms_p98=float(np.percentile(t, 98)),
              motion_time_mean_s=float(np.mean([r["motion_time"] for r in okr])) if okr else -1.0,
              max_jerk_mean=float(np.mean([r["max_jerk"] for r in okr])) if okr else -1.0,
              per_scenario={s: float(np.mean([r["success"] for r in rows if r["scenario"] == s]))
                            for s in sorted({r["scenario"] for r in rows})})
    out = dict(phase="generic", gates=GENERIC_GATE, ik_goal_set=ik, plan_cspace=cs,
               launches=launches, pair_kernel_launches=pair_launches)
    if ik["success_rate"] < GENERIC_GATE["ik_goal_set"]:
        fail(f"goal-set IK success {ik['success_rate']} under its gate: {out}")
    if cs["success_rate"] < GENERIC_GATE["plan_cspace"]:
        fail(f"plan_cspace success {cs['success_rate']} under its gate: {out}")
    return out


# ---------------------------------------------------------------------------
# The Unitree G1 (49 dof, 4 tool frames, 674 spheres, 162 111 pairs) on the
# generic route: no kernel takes it
# ---------------------------------------------------------------------------
G1_GOALS, G1_REPS = 100, 5
# success gate of phase `g1`, fixed before its first run on the card: the
# reference's published 98.4 % and the JAX package's 99 % (on its own chip)
# less a margin
G1_GATE = 0.95


def g1_scene():
    """`bench.py:bench_g1_cfik`'s world: a 4 x 4 x 0.2 m table at z -0.2."""
    return gt.Scene().add(
        gt.Cuboid(name="table", pose=[0.0, 0.0, -0.2, 1, 0, 0, 0], dims=[4.0, 4.0, 0.2])
    )


def g1_bench_config():
    """`ik_g1.yml` with `bench.py:bench_g1_cfik`'s overrides: 5 mm, no
    support polygon, LM 30, no MPPI, the first 3 line-search scales; it keeps
    16 seeds from an LM pool of 128 and L-BFGS 60 x history 10."""
    cfg = ct.IKConfig.from_yaml(ct.content_path("tasks", "ik_g1.yml"))
    ls = cfg.lbfgs.line_search
    return dataclasses.replace(
        cfg, position_threshold=0.005, lm_seed_iters=30, use_particle_stage=False,
        rollout=dataclasses.replace(cfg.rollout, support_polygon=None),
        lbfgs=dataclasses.replace(cfg.lbfgs, line_search=dataclasses.replace(
            ls, scales=tuple(ls.scales[:3]))),
    )


def g1_goals(kin, world):
    """`bench.py:bench_g1_cfik`'s goals: FK (4 tool frames) of configurations
    drawn uniformly over the full limits, floating base included
    (RandomState(7), 4 B candidates a round), rejected by
    `RobotSceneCollision.validate`."""
    p = kin.params
    rsc = ct.RobotSceneCollision(p)
    rng = np.random.RandomState(7)
    lo, hi = p.joint_limits.lower.cpu().numpy(), p.joint_limits.upper.cpu().numpy()
    pool, got = [], 0
    while got < G1_GOALS:
        cand = rng.uniform(lo, hi, (4 * G1_GOALS, p.n_dof)).astype(np.float32)
        ok = rsc.validate(world, torch.as_tensor(cand, device=DEV)).cpu().numpy()
        pool.append(cand[ok])
        got += int(ok.sum())
    st = kin.compute_kinematics(torch.as_tensor(np.concatenate(pool)[:G1_GOALS], device=DEV))
    return ct.Pose(st.tool_pose.position, st.tool_pose.quaternion)


def g1_balance_goals(kin):
    """The 3 goals of `tests/test_humanoid.py::test_task_config_success_rate`:
    FK of body joints +-0.2 rad about retract (RandomState(5))."""
    p = kin.params
    rng = np.random.RandomState(5)
    body = (np.arange(p.n_dof) >= 6).astype(np.float32)
    retract = p.retract_config.cpu().numpy()
    q_goal = (retract + rng.uniform(-0.2, 0.2, (3, p.n_dof)) * body).astype(np.float32)
    st = kin.compute_kinematics(torch.as_tensor(q_goal, device=DEV))
    return ct.Pose(st.tool_pose.position, st.tool_pose.quaternion)


def g1_small_solve(kin, cfg, goals):
    """One solve of the 3 balance goals from retract in an empty world: the
    result and its host time (device synchronised)."""
    p = kin.params
    solver = ct.IKSolver(p, cfg)
    if solver._use_kernel(ct.Goal.from_pose(goals)):
        fail("g1: a 49-dof robot took the kernel route")
    world = ct.empty_world(device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve_pose(world, goals, seed_state=p.retract_config)
    torch.cuda.synchronize()
    for name in ("solution", "position_error", "rotation_error", "cost"):
        if not torch.isfinite(getattr(res, name)).all():
            fail(f"g1: IKResult.{name} has non-finite values")
    out = dict(goals=int(goals.position.shape[0]), solved=int(res.success.sum()),
               ms=(time.perf_counter() - t0) * 1e3,
               position_error_mm=(res.position_error * 1e3).tolist(),
               rotation_error=res.rotation_error.tolist(),
               thresholds=[cfg.position_threshold, cfg.rotation_threshold])
    return res, out


def g1_balance_check(kin, goals):
    """The shipped `ik_g1.yml` with its defaults (support polygon on, hull
    baked at retract, MPPI 16 x 4, LM 60) on the 3 balance goals: 3 of 3
    within the config's thresholds."""
    from curobo_tpu_torch.cost.support_polygon import configure_rollout

    p = kin.params
    cfg = ct.IKConfig.from_yaml(ct.content_path("tasks", "ik_g1.yml"))
    cfg = dataclasses.replace(cfg, rollout=configure_rollout(cfg.rollout, p, p.retract_config))
    res, out = g1_small_solve(kin, cfg, goals)
    out["hull_vertices"] = len(cfg.rollout.support_hull)
    if out["solved"] != 3 or float(res.position_error.max()) >= cfg.position_threshold:
        fail(f"g1 balance check solved {out['solved']} of 3: {out}")
    return out


def g1_phase(out_dir):
    """Phase `g1`: `bench.py:bench_g1_cfik`'s protocol at full width through
    `IKSolver.solve_pose` on the generic route (the LM seed pool, L-BFGS with a
    strong-Wolfe search over `RobotRollout`, whose self-collision sum runs the
    pair kernels): a warm-up solve, G1_REPS timed solves (device synchronised
    around each, and between the LM and L-BFGS stages), success (fails under
    G1_GATE), the 90th percentile of the position error, peak device memory of
    a solve, a `torch.profiler` trace of one solve (busy share, kernels by
    name); `sc_pair_cost` and `sc_pair_grad` must launch and no IK or
    trajectory kernel may; then the balance check with the support polygon on
    and one solve of the default `IKConfig()`. Returns the summary and the G1
    shape of the pair kernels (the solve's seeds at its line-search scales)."""
    from curobo_tpu_torch.solver import ik as ik_mod

    t_phase = time.perf_counter()
    kin = ct.Kinematics.from_robot_yaml(ct.robot_config_path("unitree_g1"))
    p = kin.params
    world = ct.compile_scene(g1_scene())
    goals = g1_goals(kin, world)
    cfg = g1_bench_config()
    solver = ct.IKSolver(p, cfg)
    if solver._robot_takes_kernel or solver._ik_cost is not None:
        fail("g1: the IK kernels took a robot of 49 dof and 162k pairs")
    seed_state = p.retract_config
    t0 = time.perf_counter()
    res = solver.solve_pose(world, goals, seed_state=seed_state)  # warm-up
    torch.cuda.synchronize()
    emit(dict(phase="g1_warmup", ms=(time.perf_counter() - t0) * 1e3,
              success_rate=float(res.success.float().mean()),
              setup_s=t0 - t_phase))

    # stage timers: the device synchronised before and after each stage
    stage = {"lm": [], "lbfgs": []}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    lm_orig, lb_orig = solver._lm_warm_start, ik_mod.lbfgs_optimize
    solver._lm_warm_start = timed("lm", lm_orig)
    ik_mod.lbfgs_optimize = timed("lbfgs", lb_orig)
    reset_counts()
    times, peak = [], []
    try:
        for i in range(G1_REPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            res = solver.solve_pose(world, goals, seed=i, seed_state=seed_state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            peak.append(torch.cuda.max_memory_allocated() - base)
    finally:
        solver._lm_warm_start, ik_mod.lbfgs_optimize = lm_orig, lb_orig
    launches, pair_launches = counts(), sc_counts()
    if any(launches.values()):
        fail(f"g1: the generic route launched IK or trajectory kernels: {launches}")
    if pair_launches["sc_pair_cost"] < 1 or pair_launches["sc_pair_grad"] < 1:
        fail(f"g1: the pair sum did not go through the pair kernels: {pair_launches}")

    # one traced solve: busy share and device work by name; the trace itself
    # (hundreds of MB) is read and removed
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("g1_solve"):
            solver.solve_pose(world, goals, seed=0, seed_state=seed_state).solution.cpu()
    path = os.path.join(out_dir, "g1_trace.json")
    prof.export_chrome_trace(path)
    trace = trace_busy(path, "g1_solve", 1)
    os.remove(path)

    for name in ("solution", "position_error", "rotation_error", "cost", "seed_solutions"):
        if not torch.isfinite(getattr(res, name)).all():
            fail(f"g1: IKResult.{name} has non-finite values")
    D, S = p.n_dof, cfg.n_seeds
    if res.solution.shape != (G1_GOALS, D) or res.seed_solutions.shape != (G1_GOALS, S, D):
        fail("g1: unexpected result shapes")
    # the repo's own check: FK of a successful solution reaches all four
    # tools' goals, and the solution is collision-free and within its limits
    st = kin.compute_kinematics(res.solution)
    fk_err = (st.tool_pose.position - goals.position).norm(dim=-1).amax(dim=-1)
    ok = res.success
    if bool(ok.any()) and float(fk_err[ok].max()) > cfg.position_threshold + 1e-4:
        fail(f"g1: FK of a successful solution misses a goal by {float(fk_err[ok].max())}")
    valid = ct.RobotSceneCollision(p).validate(world, res.solution)
    if bool((ok & ~valid).any()):
        fail("g1: a successful solution collides or leaves its limits")
    sr = float(ok.float().mean())
    pe = res.position_error.double().cpu().numpy()
    sc = p.self_collision
    summary = dict(
        phase="g1", robot="unitree_g1", dof=D, tools=p.n_tools, links=p.n_links,
        spheres=p.n_spheres, live_pairs=int(torch.isfinite(sc.pair_margin).sum()),
        goals=G1_GOALS, seeds=S, lm_seed_pool=cfg.lm_seed_pool,
        budget=f"LM pool {cfg.lm_seed_pool} x {cfg.lm_seed_iters} iters -> {S} seeds, no MPPI, "
               f"L-BFGS {cfg.lbfgs.n_iters} x history {cfg.lbfgs.history}, strong Wolfe over "
               f"scales {cfg.lbfgs.line_search.scales}; {cfg.position_threshold * 1e3:g} mm",
        route="generic", success_rate=sr, gate=G1_GATE,
        position_error_mm_p90=float(np.percentile(pe, 90) * 1e3),
        median_rotation_error=float(res.rotation_error.median()),
        ms_per_solve_median=statistics.median(times), ms_per_solve_min=min(times),
        ms_per_solve=times, lm_ms=statistics.median(stage["lm"]),
        lbfgs_ms=statistics.median(stage["lbfgs"]), lm_ms_all=stage["lm"],
        lbfgs_ms_all=stage["lbfgs"], peak_memory_bytes_over_a_solve=max(peak),
        kernel_launches=launches, pair_kernel_launches=pair_launches, profile=trace,
        gpu=gpu_line(),
    )
    if sr < G1_GATE:
        fail(f"g1: success rate {sr} is under {G1_GATE}: {summary}")
    small_goals = g1_balance_goals(kin)
    summary["balance_check"] = g1_balance_check(kin, small_goals)
    # the default IKConfig() takes the G1 too (32 seeds, MPPI 32 x 8, L-BFGS
    # 40 over 7 scales): it constructs and solves on the generic route; its
    # success is reported, not gated (its budget is not the G1's)
    summary["default_config"] = g1_small_solve(kin, ct.IKConfig(), small_goals)[1]
    if any(counts().values()):
        fail(f"g1: the generic route launched IK or trajectory kernels: {counts()}")
    summary["phase_seconds"] = time.perf_counter() - t_phase
    # the pair kernels' G1 shape: one line search of the solve's own seeds
    n_scales = len(cfg.lbfgs.line_search.scales)
    return summary, res.seed_solutions.reshape(-1, D).repeat(n_scales, 1)


# ---------------------------------------------------------------------------
# Phase `sc_kernels`: the self-collision pair kernels against their plain
# versions
# ---------------------------------------------------------------------------
SC_KERNELS = {"sc_pair_cost": sck.sc_pair_cost, "sc_pair_grad": sck.sc_pair_grad,
              "sc_pair_viol": sck.sc_pair_viol}
# the largest violation: a max over the same distances, so equal to the
# rounding of the squared distance's three terms
SC_VIOL_ATOL = 1e-6
# the gradient: most spheres are in no active pair and read exact zeros on
# both sides, so its relative statistics are taken where either side is
# nonzero, and its largest absolute difference is held to this share of the
# largest plain entry (sums of the same terms in another float32 order), so
# that one wrong sphere shows
SC_GRAD_MAX_REL = 1e-5
# float operations a pair (distance, hinge and sum; the backward's live test,
# coefficient and three products and sums), the count of the bound; the
# gradient kernel evaluates every pair from both ends (each sphere tile
# gathers its own), so its backward executes about twice 20
SC_OPS_FWD, SC_OPS_BWD, SC_OPS_BWD_GATHER = 12.0, 20.0, 40.0
SC_ACT = 0.02  # the G1 rollout's self-collision activation (ik_g1.yml)


def sc_counts():
    return {k: fn.launches for k, fn in SC_KERNELS.items()}


def best_ms(fn, reps=5):
    """Best of `reps` by CUDA events, after one warm-up call."""
    return min(event_samples(fn, reps)[0])


# cycles of the spin kernel that holds the stream while `device_ms` enqueues
# its calls: about 10 ms at the H100's clocks, more than the host takes to
# enqueue 10 calls
SPIN_CYCLES = 20_000_000


def device_ms(fn, reps=10):
    """Device time of one call of `fn` with the host out of the way: a spin
    kernel holds the stream while the host enqueues `reps` calls, so CUDA
    events around them time the calls' kernels back to back (the device's own
    gaps between launches included), not the host's time between launches,
    which sets `best_ms` of a call that launches little work."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def peak_bytes(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def sc_case(label, sc, spheres, act=SC_ACT, seed=0):
    """One shape: positions (S, 3, N) from `spheres`; `sc_pair_cost`,
    `sc_pair_grad` (under a random upstream gradient in [0.5, 1.5)) and
    `sc_pair_viol` against their plain versions (the chunked forward and
    violation, the autograd scatter backward) and against the plain versions
    that walk the tile tables in the kernels' order (`sc_pair_*_tiled_plain`);
    two launches of each must give the same bits, and so must a launch on a
    view of the positions that is not 16-byte aligned. Then each kernel's time and
    its plain versions' (CUDA events, best of 20 and of 5; the kernels also
    by their device time, enqueued behind a spin kernel), their bounds, a
    model of the bytes a launch stages into shared memory (computed, not
    measured), and the peak memory of a cost and gradient."""
    pt = sck._sphere_major(spheres.detach())
    S, _, N = pt.shape
    tab = sck.pair_tables(sc, S, DEV)
    P = tab.P
    geo = sck.geometry_of(tab, N)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    up = (torch.rand(N, generator=gen) + 0.5).to(DEV)
    c_k, c_k2 = sck.sc_pair_cost(tab, pt, act), sck.sc_pair_cost(tab, pt, act)
    g_k, g_k2 = sck.sc_pair_grad(tab, pt, up, act), sck.sc_pair_grad(tab, pt, up, act)
    v_k, v_k2 = sck.sc_pair_viol(tab, pt), sck.sc_pair_viol(tab, pt)
    # the same positions in a view that starts 4 bytes into its storage: the
    # kernels stage them in 4-byte copies instead of 16-byte ones, to the
    # same bits
    pu = torch.empty(pt.numel() + 1, device=DEV)[1:].view(pt.shape).copy_(pt)
    unaligned = dict(cost=torch.equal(sck.sc_pair_cost(tab, pu, act), c_k),
                     grad=torch.equal(sck.sc_pair_grad(tab, pu, up, act), g_k),
                     viol=torch.equal(sck.sc_pair_viol(tab, pu), v_k))
    torch.cuda.synchronize()
    c_p = sck.sc_pair_cost_plain(tab, pt, act)
    g_p = sck.sc_pair_grad_plain(tab, pt, up, act)
    v_p = sck.sc_pair_viol_plain(tab, pt)
    c_t = sck.sc_pair_cost_tiled_plain(tab, pt, act)
    g_t = sck.sc_pair_grad_tiled_plain(tab, pt, up, act)
    v_t = sck.sc_pair_viol_tiled_plain(tab, pt)
    for name, t in (("sc_pair_cost", c_k), ("sc_pair_grad", g_k), ("sc_pair_viol", v_k)):
        if not torch.isfinite(t).all():
            fail(f"{name}[{label}] returned non-finite values")
    c_med, c_p99 = rel_stats(c_k, c_p, 1e-2)
    ct_med, ct_p99 = rel_stats(c_k, c_t, 1e-2)
    g, gt = grad_agreement(g_k, g_p), grad_agreement(g_k, g_t)
    out = dict(case=label, candidates=N, spheres=S, live_pairs=P, activation=act,
               live_tiles=tab.L, tile_fill=P / (tab.L * sck.SC_TS ** 2),
               geometry=dataclasses.asdict(geo),
               colliding_candidates=int((v_p > 0).sum()),
               cost_rel_median=c_med, cost_rel_p99=c_p99,
               cost_vs_plain_tiled_rel_median=ct_med, cost_vs_plain_tiled_rel_p99=ct_p99,
               grad_nonzero_share=g["nonzero_share"], grad_rel_median=g["rel_median"],
               grad_rel_p99=g["rel_p99"], grad_max_abs_err_over_max=g["max_abs_err_over_max"],
               grad_max_abs_plain=g["max_abs_plain"],
               grad_vs_plain_tiled_rel_median=gt["rel_median"],
               grad_vs_plain_tiled_rel_p99=gt["rel_p99"],
               grad_vs_plain_tiled_max_abs_err_over_max=gt["max_abs_err_over_max"],
               max_abs_err_cost=float((c_k - c_p).abs().max()),
               max_abs_err_grad=float((g_k - g_p).abs().max()),
               max_abs_err_viol=float((v_k - v_p).abs().max()),
               max_abs_err_viol_vs_plain_tiled=float((v_k - v_t).abs().max()),
               bitwise_equal=dict(cost=torch.equal(c_k, c_k2), grad=torch.equal(g_k, g_k2),
                                  viol=torch.equal(v_k, v_k2)),
               unaligned_view_bitwise_equal=unaligned)
    grad_ok = all(d["nonzero_share"] > 0 and d["rel_median"] < COST_MED and d["rel_p99"] < COST_P99
                  and d["max_abs_err_over_max"] <= SC_GRAD_MAX_REL for d in (g, gt))
    cost_ok = max(c_med, ct_med) < COST_MED and max(c_p99, ct_p99) < COST_P99
    if not (cost_ok and grad_ok):
        fail(f"pair kernels [{label}] disagree with their plain versions: {out}")
    if max(out["max_abs_err_viol"], out["max_abs_err_viol_vs_plain_tiled"]) > SC_VIOL_ATOL:
        fail(f"sc_pair_viol [{label}] disagrees with its plain versions: {out}")
    if not all(out["bitwise_equal"].values()):
        fail(f"pair kernels [{label}]: two launches on the same inputs differ: {out}")
    if not all(unaligned.values()):
        fail(f"pair kernels [{label}]: an unaligned view of the positions gives other bits: {out}")

    def kernel_cost_grad():
        xx = pt.clone().requires_grad_(True)
        c = sck._PairHingeSum.apply(xx, tab, act)
        return torch.autograd.grad((c * up).sum(), xx)[0]

    def plain_cost_grad():
        return sck.sc_pair_cost_plain(tab, pt, act), sck.sc_pair_grad_plain(tab, pt, up, act)

    # bytes: positions, the kernel's tables and the upstream gradient read
    # once, the result written once
    pos_bytes = pt.numel() * 4
    blk = sck.SC_TS ** 2 * 4
    fwd_tab = tab.L * (blk + 8)
    E = tab.nb_tile.shape[0]
    grad_tab = E * (blk + 4) + (tab.n_tiles + 1) * 4
    b_c = bound_ms(N * P * SC_OPS_FWD, pos_bytes + fwd_tab + N * 4)
    b_g = bound_ms(N * P * SC_OPS_BWD, 2 * pos_bytes + N * 4 + grad_tab)
    b_v = bound_ms(N * P * SC_OPS_FWD, pos_bytes + fwd_tab + N * 4)
    b_cg = bound_ms(N * P * (SC_OPS_FWD + SC_OPS_BWD), 2 * pos_bytes + N * 8 + fwd_tab + grad_tab)
    # a model, not a reading: what a launch would stage through L2 into
    # shared memory, per block and tile the partner's positions for its cw
    # candidates and a margin block
    per_tile = sck.SC_TS * 3 * geo.cw * 4 + blk
    staged = dict(sc_pair_cost=geo.columns * tab.L * per_tile,
                  sc_pair_grad=geo.columns * E * per_tile)
    out.update(
        # the kernels best of 20: at a few candidates a call is host time,
        # which varies by tens of microseconds between calls
        ms=dict(sc_pair_cost=best_ms(lambda: sck.sc_pair_cost(tab, pt, act), 20),
                sc_pair_grad=best_ms(lambda: sck.sc_pair_grad(tab, pt, up, act), 20),
                sc_pair_viol=best_ms(lambda: sck.sc_pair_viol(tab, pt), 20),
                cost_and_grad=best_ms(kernel_cost_grad, 20)),
        device_ms=dict(sc_pair_cost=device_ms(lambda: sck.sc_pair_cost(tab, pt, act)),
                       sc_pair_grad=device_ms(lambda: sck.sc_pair_grad(tab, pt, up, act)),
                       sc_pair_viol=device_ms(lambda: sck.sc_pair_viol(tab, pt))),
        plain_ms=dict(sc_pair_cost=best_ms(lambda: sck.sc_pair_cost_plain(tab, pt, act)),
                      sc_pair_grad=best_ms(lambda: sck.sc_pair_grad_plain(tab, pt, up, act)),
                      sc_pair_grad_tiled=best_ms(
                          lambda: sck.sc_pair_grad_tiled_plain(tab, pt, up, act)),
                      sc_pair_viol=best_ms(lambda: sck.sc_pair_viol_plain(tab, pt)),
                      cost_and_grad=best_ms(plain_cost_grad)),
        bound_ms=dict(sc_pair_cost=b_c[0], sc_pair_grad=b_g[0], sc_pair_viol=b_v[0],
                      cost_and_grad=b_cg[0]),
        bound_by=dict(sc_pair_cost=b_c[1], sc_pair_grad=b_g[1], sc_pair_viol=b_v[1],
                      cost_and_grad=b_cg[1]),
        # what the gather's recomputation adds: each pair evaluated from both ends
        bound_ms_grad_as_executed=bound_ms(N * P * SC_OPS_BWD_GATHER, 2 * pos_bytes)[0],
        staged_bytes_model=staged,
        peak_bytes=dict(kernel_cost_and_grad=peak_bytes(kernel_cost_grad),
                        plain_cost_and_grad=peak_bytes(plain_cost_grad)),
    )
    return out


def near_retract(params, n, scale, rng):
    """`n` configurations of a floating-base robot: its retract configuration
    with normal offsets of `scale` rad on every joint past the six base dof."""
    body = torch.as_tensor((np.arange(params.n_dof) >= 6).astype(np.float32), device=DEV)
    z = torch.as_tensor(rng.normal(0.0, scale, (n, params.n_dof)).astype(np.float32), device=DEV)
    return params.retract_config + z * body


def sc_shapes(g1_q=None, franka_q=None):
    """The four shapes of phase `sc_kernels` as (label, kinematics,
    configurations): the G1 line search (`g1_q`: 4800 configurations, the G1
    solve's own seeds at its 3 line-search scales), the retarget robot's
    global frame (MPPI: 32 particles x 24 seeds) and one local frame (a line
    search at B = 1: 7 candidates), and the Franka at 3200 configurations
    (`franka_q`, the IK seeds; 694 of its 818 pairs live). Without `g1_q` and
    `franka_q` (timing without a solve, as `tools/torch_sc_kernels_ab.py`
    does) they are 4800 G1 configurations near its retract configuration
    and 3200 Franka configurations over its joint range."""
    kg = ct.Kinematics.from_robot_yaml(ct.robot_config_path("unitree_g1"))
    kr = ct.Kinematics.from_robot_yaml(ct.robot_config_path("unitree_g1_29dof_retarget"))
    kf = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"))
    if g1_q is None or franka_q is None:
        rng = np.random.RandomState(5)
        g1_q = near_retract(kg.params, 4800, 0.3, rng)
        lo, hi = kf.params.dof_clip_bounds(np.pi)
        qf = rng.uniform(lo, hi, (N_GOALS * N_SEEDS, kf.params.n_dof)).astype(np.float32)
        franka_q = torch.as_tensor(qf, device=DEV)
    rng = np.random.RandomState(3)
    return [("g1/line_search", kg, g1_q),
            ("retarget/global_frame", kr, near_retract(kr.params, 32 * 24, 0.3, rng)),
            ("retarget/local_frame", kr, near_retract(kr.params, 7, 0.3, rng)),
            ("franka", kf, franka_q)]


def sc_phase(g1_q, franka_q):
    """Phase `sc_kernels`: the pair kernels at the four shapes of
    `sc_shapes` (at the local frame's 7 candidates the pairs are split over
    blocks)."""
    cases = [sc_case(label, kin.params.self_collision, kin.compute_kinematics(q).spheres)
             for label, kin, q in sc_shapes(g1_q, franka_q)]
    return dict(phase="sc_kernels", limits=dict(
        cost_rel_median=COST_MED, cost_rel_p99=COST_P99, grad_rel_median_nonzero=COST_MED,
        grad_rel_p99_nonzero=COST_P99, grad_max_abs_err_over_max=SC_GRAD_MAX_REL,
        viol_max_abs=SC_VIOL_ATOL), cases=cases, gpu=gpu_line())


def grad_agreement(g, ref):
    """Gradient statistics where either side is nonzero (relative error,
    floor 1: median and 99th percentile), the share of such entries, and the
    largest absolute difference over the largest |ref|."""
    nz = (g != 0) | (ref != 0)
    big = float(ref.abs().max())
    out = dict(nonzero_share=float(nz.float().mean()), max_abs_plain=big,
               max_abs_err_over_max=float((g - ref).abs().max()) / big if big > 0 else float("inf"),
               rel_median=float("inf"), rel_p99=float("inf"))
    if nz.any():
        out["rel_median"], out["rel_p99"] = rel_stats(g[nz], ref[nz], 1.0)
    return out


# ---------------------------------------------------------------------------
# Phase `retarget`: the motion retargeter on the retargeting G1
# ---------------------------------------------------------------------------
RT_FPS = 30.0
RT_FRAMES, RT_CLIPS, RT_CLIP_FRAMES, RT_EXAMPLE_FRAMES = 120, 64, 30, 40
# the reference's error for the default MPC mode on the retarget robot
RT_MPC_ERROR = "halton dim 245 > 62 supported"
# position error p90 over all tools and frames of parts (a) and (b), fixed
# before the first chip run: the JAX package's own limit for a retargeted
# frame (tests/test_humanoid.py:332-357, every tool within 2 cm)
RT_GATE_MM = 20.0
# the protocol of examples/humanoid_retargeting.py: its gates
EX_HAND_MEDIAN_MM, EX_FEET_DRIFT_MM = 30.0, 50.0
# a smooth clip: per joint group the amplitude (rad, m for the base) of a
# sine of 0.25-0.6 Hz at a random phase about retract, the arms abducted by
# 0.5 rad so that the hands swing past the hips, the base walking 0.3 m
RT_AMPLITUDE = {"base_j_x": 0.0, "base_j_y": 0.04, "base_j_z": 0.03, "base_j_xtheta": 0.04,
                "base_j_ytheta": 0.04, "base_j_ztheta": 0.25, "hip_pitch": 0.35,
                "hip_roll": 0.08, "hip_yaw": 0.15, "knee": 0.35, "ankle_pitch": 0.15,
                "ankle_roll": 0.08, "waist_yaw": 0.3, "waist_roll": 0.08, "waist_pitch": 0.1,
                "shoulder_pitch": 0.6, "shoulder_roll": 0.15, "shoulder_yaw": 0.3, "elbow": 0.4,
                "wrist": 0.3}
RT_ARM_ABDUCTION = 0.5


def retarget_clip(p, n_frames, seed):
    """A smooth joint path (n_frames, D) inside the joint limits, made with
    numpy from `seed`: the targets are its FK, so every one is reachable."""
    rng = np.random.RandomState(seed)
    lo, hi = p.joint_limits.lower.cpu().numpy(), p.joint_limits.upper.cpu().numpy()
    amp = np.asarray([next(a for k, a in RT_AMPLITUDE.items() if k in n) for n in p.joint_names])
    off = np.asarray([RT_ARM_ABDUCTION if "left_shoulder_roll" in n else
                      -RT_ARM_ABDUCTION if "right_shoulder_roll" in n else 0.0
                      for n in p.joint_names])
    t = np.arange(n_frames)[:, None] / RT_FPS
    f = rng.uniform(0.25, 0.6, p.n_dof)
    ph = rng.uniform(0.0, 2.0 * np.pi, p.n_dof)
    q = p.retract_config.cpu().numpy() + off + amp * np.sin(2.0 * np.pi * f * t + ph)
    q[:, 0] += 0.3 * t[:, 0] / t[-1, 0]
    return np.clip(q, lo + 0.02, hi - 0.02).astype(np.float32)


def rt_frames(rt, pos, quat):
    """Drive `solve_frame` over goals (F, B, T, 3) / (F, B, T, 4): the
    solutions (F, B, D), each frame's host time (device synchronised), the
    first frame's result."""
    sols, ms, first = [], [], None
    for f in range(pos.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rt.solve_frame(ct.Pose(pos[f], quat[f]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        sols.append(res.joint_state.position)
        first = res if first is None else first
    return torch.stack(sols), ms, first


def rt_summary(kin, sols, pos, ms, first, launches, label):
    """Per part: ms per frame (the global frame apart; median and p90), the
    position error p50 / p90 over all tools and frames (mm), the largest
    self-collision violation of the solutions, and the launches."""
    p = kin.params
    F, B, D = sols.shape
    if not torch.isfinite(sols).all():
        fail(f"retarget {label}: non-finite solutions")
    st = kin.compute_kinematics(sols.reshape(F * B, D))
    err = (st.tool_pose.position.reshape(F, B, -1, 3) - pos).norm(dim=-1) * 1e3
    sv = self_collision_distance(p.self_collision, st.spheres)
    e = err.double().cpu().numpy()
    glob = first.success is not None  # frame 0 was a global IK frame
    later = ms[1:] if glob else ms
    out = dict(part=label, frames=F, batch=B, tools=p.n_tools, dof=D,
               ms_global_frame=ms[0] if glob else None,
               global_frame_success=float(first.success.float().mean()) if glob else None,
               ms_per_frame_median=statistics.median(later),
               ms_per_frame_p90=float(np.percentile(later, 90)),
               position_error_mm_p50=float(np.percentile(e, 50)),
               position_error_mm_p90=float(np.percentile(e, 90)),
               position_error_mm_max=float(e.max()),
               max_self_collision_violation_m=float(sv.max()), launches=launches)
    return out


def retarget_phase():
    """Phase `retarget`: `MotionRetargeter` on `unitree_g1_29dof_retarget.yml`
    (35 dof, 14 tool frames, 400 spheres, 55 414 pairs) in its empty world, at
    full width: (a) one clip of 120 frames at B = 1, frame 0 the global IK
    (24 seeds), the rest local IK with the default `RetargetConfig`; (b) 64
    clips of 30 frames through `solve_frame` with (64, 14) goals; (c) the
    default MPC mode, which must raise where the reference's does (its MPPI
    bank has 7 free knots x 35 dof = 245 Halton dimensions, the sampler 62);
    (d) the protocol of
    `examples/humanoid_retargeting.py` on `unitree_g1.yml` (F = 40, its tool
    weights, its gates). The pair kernels must launch in every part, the IK
    kernels in none."""
    from curobo_tpu_torch.motion.retargeter import MotionRetargeter, RetargetConfig

    t_phase = time.perf_counter()
    kin = ct.Kinematics.from_robot_yaml(ct.robot_config_path("unitree_g1_29dof_retarget"))
    p = kin.params
    parts, per_part = {}, {}

    def run(label, rt, q):  # q (F, B, D): the targets are its FK
        F, B, D = q.shape
        st = kin.compute_kinematics(torch.as_tensor(q, device=DEV).reshape(F * B, D))
        pos = st.tool_pose.position.reshape(F, B, -1, 3)
        quat = st.tool_pose.quaternion.reshape(F, B, -1, 4)
        target_viol = float(self_collision_distance(p.self_collision, st.spheres).max())
        reset_counts()
        sols, ms, first = rt_frames(rt, pos, quat)
        launches = dict(sc_counts(), **counts())
        out = rt_summary(kin, sols, pos, ms, first, launches, label)
        if launches["sc_pair_cost"] < 1 or launches["sc_pair_grad"] < 1:
            fail(f"retarget {label}: the pair kernels did not launch: {launches}")
        if any(counts().values()):
            fail(f"retarget {label}: an IK or trajectory kernel launched: {launches}")
        per_part[label] = launches
        out["targets_max_self_collision_violation_m"] = target_viol
        return out

    clip = retarget_clip(p, RT_FRAMES, 0)
    parts["a_stream"] = run("a_stream", MotionRetargeter(p), clip[:, None])
    clips = np.stack([retarget_clip(p, RT_CLIP_FRAMES, 1 + i) for i in range(RT_CLIPS)], axis=1)
    parts["b_dataset"] = run("b_dataset", MotionRetargeter(p), clips)
    parts["c_mpc"] = mpc_mode_raises(kin, clip)
    parts["d_example"] = example_protocol(per_part)

    summary = dict(phase="retarget", robot="unitree_g1_29dof_retarget", dof=p.n_dof,
                   tools=p.n_tools, spheres=p.n_spheres,
                   live_pairs=int(torch.isfinite(p.self_collision.pair_margin).sum()),
                   gate_position_error_mm_p90=RT_GATE_MM, parts=parts,
                   launches_per_part=per_part, gpu=gpu_line(),
                   phase_seconds=time.perf_counter() - t_phase)
    for k in ("a_stream", "b_dataset"):
        if parts[k]["position_error_mm_p90"] >= RT_GATE_MM:
            fail(f"retarget {k}: position error p90 {parts[k]['position_error_mm_p90']} mm is "
                 f"not under {RT_GATE_MM} mm: {summary}")
    return summary


def mpc_mode_raises(kin, clip):
    """(c) The default MPC mode from frame 1 of the clip, warm-started at its
    frame 0: the reference raises `ValueError("halton dim 245 > 62
    supported")` there (`tests/test_torch_retargeter.py::
    test_default_mpc_mode_raises_like_jax`), and so must the port."""
    from curobo_tpu_torch.motion.retargeter import MotionRetargeter, RetargetConfig

    q = torch.as_tensor(clip[:2], device=DEV)
    st = kin.compute_kinematics(q)
    rt = MotionRetargeter(kin.params, RetargetConfig(mode="mpc"))
    try:
        rt.solve_frame(ct.Pose(st.tool_pose.position[1:], st.tool_pose.quaternion[1:]), q[:1])
    except ValueError as e:
        if str(e) != RT_MPC_ERROR:
            fail(f"retarget c_mpc: raised {e!r}, the reference raises {RT_MPC_ERROR!r}")
        return dict(part="c_mpc", runs=False, error=str(e), as_reference=True)
    fail("retarget c_mpc: the default MPC mode ran where the reference raises")


def example_protocol(per_part):
    """(d) `examples/humanoid_retargeting.py` on the card: `unitree_g1.yml`
    (49 dof, 4 tools, 162 111 pairs), the right hand tracing an 8 cm circle
    over 40 frames while the other tools hold their retract poses, feet
    weighted hard, `solve_sequence` from retract (every frame local IK);
    gates: median right-hand error under 30 mm, feet drift under 50 mm."""
    from curobo_tpu_torch.motion.retargeter import MotionRetargeter, RetargetConfig

    kin = ct.Kinematics.from_robot_yaml(ct.robot_config_path("unitree_g1"))
    p = kin.params
    q0 = p.retract_config
    st0 = kin.compute_kinematics(q0)
    F = RT_EXAMPLE_FRAMES
    t = np.linspace(0, 2 * np.pi, F)
    pos = np.tile(st0.tool_pose.position.cpu().numpy(), (F, 1, 1))
    pos[:, 0, 1] += 0.08 * np.sin(t)
    pos[:, 0, 2] += 0.08 * (1 - np.cos(t))
    quat = np.tile(st0.tool_pose.quaternion.cpu().numpy(), (F, 1, 1))
    goals = ct.Pose(torch.as_tensor(pos, dtype=torch.float32, device=DEV),
                    torch.as_tensor(quat, dtype=torch.float32, device=DEV))
    rt = MotionRetargeter(p, RetargetConfig(
        tool_weights=((80.0, 10.0), (80.0, 10.0), (400.0, 100.0), (400.0, 100.0))))
    ms = []
    solve = rt.solve_frame

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(*a, **k)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return res

    rt.solve_frame = timed
    reset_counts()
    traj = rt.solve_sequence(goals, q0)
    launches = dict(sc_counts(), **counts())
    per_part["d_example"] = launches
    if launches["sc_pair_cost"] < 1 or launches["sc_pair_grad"] < 1 or any(counts().values()):
        fail(f"retarget d_example: launches {launches}")
    if not torch.isfinite(traj.position).all():
        fail("retarget d_example: non-finite trajectory")
    st = kin.compute_kinematics(traj.position)
    err = (st.tool_pose.position[:, 0] - goals.position[:, 0]).norm(dim=-1).cpu().numpy() * 1e3
    feet = float((st.tool_pose.position[:, 2:] - goals.position[:, 2:]).norm(dim=-1).max()) * 1e3
    allerr = (st.tool_pose.position - goals.position).norm(dim=-1).double().cpu().numpy() * 1e3
    out = dict(part="d_example", robot="unitree_g1", frames=F, dof=p.n_dof, tools=p.n_tools,
               ms_per_frame_median=statistics.median(ms),
               ms_per_frame_p90=float(np.percentile(ms, 90)),
               hand_error_mm_median=float(np.median(err)), feet_drift_mm=feet,
               position_error_mm_p50=float(np.percentile(allerr, 50)),
               position_error_mm_p90=float(np.percentile(allerr, 90)),
               max_self_collision_violation_m=float(
                   self_collision_distance(p.self_collision, st.spheres).max()),
               gates=dict(hand_error_mm_median=EX_HAND_MEDIAN_MM, feet_drift_mm=EX_FEET_DRIFT_MM),
               launches=launches)
    if out["hand_error_mm_median"] >= EX_HAND_MEDIAN_MM or feet >= EX_FEET_DRIFT_MM:
        fail(f"retarget d_example misses the example's gates: {out}")
    return out


# ---------------------------------------------------------------------------
# Torque-limited motion generation (`bench_motion.py --use-dynamics`): the
# RNEA torque term with a 3 kg payload, on the generic trajectory route
# ---------------------------------------------------------------------------
TORQUE_PROBLEMS = 20  # `bench.py:777`'s default
TORQUE_WEIGHT, PAYLOAD_KG = 100.0, 3.0  # `bench_motion.py:86-97`
TORQUE_GATE = 0.95
# the card's RNEA against the CPU's on the same inputs, relative to the
# largest |tau| (float32: another order of the same sums)
RNEA_REL = 1e-4
# after 10 problems the phase stops planning once it has run this long, or
# once the whole script has (the run must end within 1200 s)
TORQUE_DEADLINE_S, TORQUE_RUN_DEADLINE_S = 300.0, 560.0


def torque_plan_config():
    """The default `MotionPlanConfig()` with the JAX bench's torque term."""
    base = ct.MotionPlanConfig()
    t = base.trajopt
    return dataclasses.replace(base, trajopt=dataclasses.replace(t, rollout=dataclasses.replace(
        t.rollout, torque_limit_weight=TORQUE_WEIGHT, payload_mass=PAYLOAD_KG)))


def payload_params(params, kg):
    """The params of the torque term: the payload at the last link's CoM."""
    mass = params.link_mass.clone()
    mass[params.n_links - 1] += kg
    return dataclasses.replace(params, link_mass=mass)


def host_ms(fn, reps=10):
    """Median host milliseconds of fn, the device synchronised after each."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def rnea_cost_ms(params, shape):
    """Host ms of one torque term's RNEA, forward and forward + backward, on
    random states of `shape` (..., D) on the card."""
    gen = torch.Generator().manual_seed(5)
    xs = [(torch.randn(shape, generator=gen) * s).to(DEV).requires_grad_(True)
          for s in (1.0, 1.5, 5.0)]

    def fwd():
        with torch.no_grad():
            ct.compute_inverse_dynamics(params, *xs)

    def fwd_bwd():
        tau = ct.compute_inverse_dynamics(params, *xs)
        torch.autograd.grad(tau.square().sum(), xs)

    return host_ms(fwd), host_ms(fwd_bwd)


def rnea_check(kin):
    """`compute_inverse_dynamics` on the card against the CPU on the same 4096
    random Franka states, payload on."""
    gen = torch.Generator().manual_seed(21)
    n, D = 4096, kin.n_dof
    q = torch.rand((n, D), generator=gen) * 2.6 - 1.3
    qd = 1.5 * torch.randn((n, D), generator=gen)
    qdd = 5.0 * torch.randn((n, D), generator=gen)
    p = payload_params(kin.params, PAYLOAD_KG)
    tau = ct.compute_inverse_dynamics(p, q.to(DEV), qd.to(DEV), qdd.to(DEV)).cpu()
    ref = ct.compute_inverse_dynamics(p.to("cpu"), q, qd, qdd)
    if not torch.isfinite(tau).all():
        fail("compute_inverse_dynamics returned non-finite torques on the card")
    rel = float((tau - ref).abs().max() / ref.abs().max())
    out = dict(states=n, max_abs_err=float((tau - ref).abs().max()), rel_to_largest=rel,
               largest_abs_tau=float(ref.abs().max()), limit=RNEA_REL)
    if rel > RNEA_REL:
        fail(f"compute_inverse_dynamics on the card disagrees with the CPU: {out}")
    return out


def torque_phase(kin, suite, out_dir, t_start):
    """`MotionPlanner.plan_pose` with the torque-limited config over the first
    TORQUE_PROBLEMS suite problems (B = 1, one warm-up plan): success (gate
    TORQUE_GATE), plan ms, retry rate, the peak |tau| of each solved
    trajectory with the payload (`bench_motion.py:101-117`), launches (one
    `ik_solve` an attempt, no trajectory kernel: the torque term has no kernel
    route); the RNEA on the card against the CPU; where a plan's time goes
    (the RNEA's calls and their cost at the plan's shapes, and one plan under
    `torch.profiler`)."""
    import curobo_tpu_torch.rollout.robot_rollout as rr_mod
    from torch.profiler import ProfilerActivity, profile, record_function

    t_phase = time.perf_counter()
    rnea = rnea_check(kin)
    problems, cap = suite["problems"][:TORQUE_PROBLEMS], suite["cuboid_capacity"]
    planner = ct.MotionPlanner(kin.params, torque_plan_config())
    if planner.trajopt._solve_kernel is not None:
        fail("the torque-limited trajectory optimiser built a trajectory kernel")
    dyn = payload_params(planner.params, PAYLOAD_KG)
    calls = {}
    rnea_fn = rr_mod.compute_inverse_dynamics

    def counted(params, q, *a, **k):  # the rollout's RNEA calls, by shape
        calls[tuple(q.shape)] = calls.get(tuple(q.shape), 0) + 1
        with record_function("rnea_forward"):
            return rnea_fn(params, q, *a, **k)

    def run(p, seed):
        world, goal, start = problem_inputs(kin, p, cap)
        t0 = time.perf_counter()
        res = planner.plan_pose(world, goal, start, seed=seed)
        res.trajectory.position.cpu()
        return res, time.perf_counter() - t0, start

    rr_mod.compute_inverse_dynamics = counted
    try:
        run(problems[0], 1000)  # warm-up
        reset_counts()
        calls.clear()
        rows, cut = [], False
        for i, p in enumerate(problems):
            now = time.perf_counter()
            if i >= 10 and (now - t_phase > TORQUE_DEADLINE_S
                            or now - t_start > TORQUE_RUN_DEADLINE_S):
                cut = True
                break
            before = counts()
            res, dt_wall, start = run(p, i)
            A = planner.last_attempts
            d = {k: v - before[k] for k, v in counts().items()}
            if d["ik_solve"] != A or d["traj_solve"] or d["traj_cost_grad"] or d["ik_cost_grad"]:
                fail(f"torque problem {i}: {A} attempts launched {d}")
            st = res.solver_trajectory
            for name, t in (("trajectory", res.trajectory.position), ("solver position", st.position),
                            ("solver velocity", st.velocity),
                            ("solver acceleration", st.acceleration),
                            ("position_error", res.position_error)):
                if not torch.isfinite(t).all():
                    fail(f"torque problem {i}: {name} has non-finite values")
            with torch.no_grad():
                tau = ct.compute_inverse_dynamics(dyn, st.position, st.velocity, st.acceleration)
            over = (tau.abs() - dyn.joint_limits.effort).clamp_min(0.0)
            rows.append(dict(success=bool(res.success[0]), plan_ms=dt_wall * 1e3, attempts=A,
                             peak_tau=float(tau.abs().max()), over_effort=float(over.max()),
                             motion_time=float(res.motion_time[0])))
        launches, pair = counts(), sc_counts()
        n_calls = dict(calls)
        t_trace = time.perf_counter()
        # one plan under the profiler: busy share, device time by name, the
        # RNEA forward's host windows
        world, goal, start = problem_inputs(kin, problems[-1], cap)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("torque_plan"):
                planner.plan_pose(world, goal, start, seed=7).trajectory.position.cpu()
    finally:
        rr_mod.compute_inverse_dynamics = rnea_fn
    path = os.path.join(out_dir, "torque_plan_trace.json")
    prof.export_chrome_trace(path)
    trace = trace_busy(path, "torque_plan", 1)
    with open(path) as fh:
        ev = json.load(fh)["traceEvents"]
    fwd_windows = [e["dur"] for e in ev if e.get("ph") == "X" and e.get("name") == "rnea_forward"
                   and e.get("cat") == "user_annotation"]
    trace.update(rnea_forward_calls=len(fwd_windows),
                 rnea_forward_host_ms=sum(fwd_windows) / 1e3)
    os.remove(path)  # tens of MB; the numbers above are what it was kept for
    trace["seconds"] = time.perf_counter() - t_trace  # the traced plan, export and reading

    # the RNEA's share of a plan: its calls at each shape times its cost there
    per_shape = []
    est_ms = 0.0
    for shape, n in sorted(n_calls.items(), key=lambda kv: -kv[1]):
        f_ms, fb_ms = rnea_cost_ms(dyn, shape)
        per_shape.append(dict(shape=list(shape), calls=n, fwd_ms=f_ms, fwd_bwd_ms=fb_ms))
        est_ms += n * fb_ms  # each objective evaluation of the optimisers takes a gradient
    okr = [r for r in rows if r["success"]]
    t = np.asarray([r["plan_ms"] for r in rows])
    peaks = [r["peak_tau"] for r in okr]
    out = dict(
        phase="torque", gpu=gpu_line(), problems_run=len(rows), cut_by_deadline=cut,
        torque_limit_weight=TORQUE_WEIGHT, payload_kg=PAYLOAD_KG,
        success_rate=len(okr) / len(rows), gate=TORQUE_GATE,
        plan_ms_mean=float(t.mean()), plan_ms_median=float(np.median(t)),
        plan_ms_p98=float(np.percentile(t, 98)),
        retry_rate=float(np.mean([r["attempts"] > 1 for r in rows])),
        peak_tau_max=max(peaks) if peaks else -1.0,
        peak_tau_mean=float(np.mean(peaks)) if peaks else -1.0,
        over_effort_max=max(r["over_effort"] for r in okr) if okr else -1.0,
        motion_time_mean_s=float(np.mean([r["motion_time"] for r in okr])) if okr else -1.0,
        launches=launches, pair_kernel_launches=pair, rnea_check=rnea,
        rnea_calls=sum(n_calls.values()), rnea_per_shape=per_shape,
        rnea_fwd_bwd_ms_estimate=est_ms,
        rnea_share_estimate=est_ms / float(t.sum()) if len(t) else -1.0,
        trace=trace, seconds=time.perf_counter() - t_phase)
    if out["success_rate"] < TORQUE_GATE:
        fail(f"torque-limited motion generation success {out['success_rate']} under "
             f"{TORQUE_GATE}: {out}")
    if launches["ik_solve"] < len(rows) or pair["sc_pair_cost"] < 1 or pair["sc_pair_grad"] < 1:
        fail(f"torque phase: the kernels of its path did not launch: {launches} {pair}")
    return out


# ---------------------------------------------------------------------------
# Voxel-grid (ESDF) worlds: IK, MPC over a perception feed, an attached
# payload, per-problem worlds
# ---------------------------------------------------------------------------
# the perception example's grid (`examples/perception_to_planning.py:59-60`),
# centred at (0.4, 0, 0.4): x -0.8..1.6, y -1.2..1.2, z -0.6..1.4 m
VOXEL_SHAPE, VOXEL_CELL, VOXEL_CENTER = (96, 96, 80), 0.025, (0.4, 0.0, 0.4)
TABLE_BOX = ((-0.2, -0.6, -0.2), (1.0, 0.6, 0.0))  # table_scene()'s cuboid
PERCEPTION_BOX = ((0.35, -0.15, 0.3), (0.55, 0.15, 0.6))  # the example's box
VOXEL_REPS, VOXEL_MPC_TICKS, VOXEL_MPC_STEP = 5, 20, 0.01
VOXEL_IK_MARGIN = 0.05  # success at least the cuboid twin's less this
VOXEL_MPC_GATE = 0.9
VOXEL_ENV_CONFIGS = 3200
# the grasped box of `examples/attached_object.py`: 6 x 6 x 12 cm, 10 cm past the hand
ATTACH_HALF, ATTACH_OFFSET, ATTACH_PROBLEMS = (0.03, 0.03, 0.06), (0.0, 0.0, 0.10), 10


def box_sdf(x, boxes):
    """Exact signed distance (numpy) of points x (..., 3) to the union of
    axis-aligned boxes ((lo, hi), ...)."""
    d = np.full(x.shape[:-1], np.inf, dtype=np.float32)
    for lo, hi in boxes:
        c = (np.asarray(lo, np.float32) + np.asarray(hi, np.float32)) / 2
        h = (np.asarray(hi, np.float32) - np.asarray(lo, np.float32)) / 2
        q = np.abs(x - c) - h
        d = np.minimum(d, np.linalg.norm(np.maximum(q, 0), axis=-1) + np.minimum(q.max(-1), 0))
    return d


def voxel_centres():
    dims = np.asarray(VOXEL_SHAPE) * VOXEL_CELL
    axes = [VOXEL_CENTER[k] - dims[k] / 2 + VOXEL_CELL / 2 + VOXEL_CELL * np.arange(VOXEL_SHAPE[k])
            for k in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).astype(np.float32)


def shifted(box, dy):
    (lo, hi) = box
    return ((lo[0], lo[1] + dy, lo[2]), (hi[0], hi[1] + dy, hi[2]))


def voxel_world(data):
    return ct.compile_scene(gt.Scene().add(gt.VoxelGridObstacle(
        name="esdf", pose=list(VOXEL_CENTER) + [1, 0, 0, 0],
        dims=[s * VOXEL_CELL for s in VOXEL_SHAPE], voxel_size=VOXEL_CELL, data=data)))


def cuboid_twin():
    """The voxel world's obstacles as cuboids."""
    (lo, hi) = PERCEPTION_BOX
    centre = [(a + b) / 2 for a, b in zip(lo, hi)]
    return ct.compile_scene(table_scene().add(gt.Cuboid(
        name="box", pose=centre + [1, 0, 0, 0], dims=[b - a for a, b in zip(lo, hi)])))


def voxel_ik(kin, world_v, world_c, goals):
    """(a) 100 goals x 32 seeds, the default `IKConfig()`, on the voxel world
    (the generic route), against the same goals in the cuboid twin on the same
    route (`use_pallas=False`)."""
    solver = ct.IKSolver(kin.params)
    res = solver.solve_pose(world_v, goals)  # warm-up
    reset_counts()
    ms = []
    for i in range(VOXEL_REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        res = solver.solve_pose(world_v, goals, seed=i)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    launches, pair = counts(), sc_counts()
    if any(launches.values()) or pair["sc_pair_cost"] < 1 or pair["sc_pair_grad"] < 1:
        fail(f"voxel IK: launches {launches}, pair kernels {pair}")
    for name in ("solution", "position_error", "cost"):
        if not torch.isfinite(getattr(res, name)).all():
            fail(f"voxel IK: non-finite {name}")
    twin = ct.IKSolver(kin.params, ct.IKConfig(use_pallas=False)).solve_pose(world_c, goals)
    # the voxel SDF against the analytic one at the solutions' live spheres
    # inside the grid (a cell or more from its faces; outside it the grid
    # reads its outside value, 10 m)
    sph = kin.compute_kinematics(res.solution).spheres
    half = torch.tensor([s * VOXEL_CELL / 2 - VOXEL_CELL for s in VOXEL_SHAPE], device=DEV)
    inside = ((sph[..., :3] - torch.tensor(VOXEL_CENTER, device=DEV)).abs() < half).all(dim=-1)
    keep = (sph[..., 3] >= 0) & inside
    d_v = twm.sphere_sdf(world_v, sph[..., :3])[keep]
    d_c = twm.sphere_sdf(world_c, sph[..., :3])[keep]
    gap = (d_v - d_c).abs()
    near = d_c.abs() < 0.1
    ok = res.success
    valid_c = ct.RobotSceneCollision(kin.params).validate(world_c, res.solution)
    out = dict(goals=N_GOALS, seeds=solver.cfg.n_seeds, success_rate=float(ok.float().mean()),
               success_cuboid_twin=float(twin.success.float().mean()),
               ms_per_solve_median=statistics.median(ms), ms_per_solve_min=min(ms),
               median_position_error=float(res.position_error.median()),
               spheres_in_grid=int(keep.sum()), spheres_live=int((sph[..., 3] >= 0).sum()),
               sdf_gap_max_m=float(gap.max()),
               sdf_gap_max_within_10cm_m=float(gap[near].max()) if bool(near.any()) else -1.0,
               solved_and_clear_of_the_cuboids=float((ok & valid_c).float().sum() /
                                                     ok.float().sum().clamp_min(1)),
               launches=launches, pair_kernel_launches=pair)
    if out["success_rate"] < out["success_cuboid_twin"] - VOXEL_IK_MARGIN:
        fail(f"voxel IK success under the cuboid twin's less {VOXEL_IK_MARGIN}: {out}")
    return out


def voxel_mpc(kin, base_data, table_d, x_vox):
    """(b) VOXEL_MPC_TICKS `MPCSolver.step`s on the Franka (default
    `MPCConfig()`, the MPC bench's start and goal) while the box moves 1 cm a
    tick along y, fed through `update_voxel_data` (the perception path)."""
    solver = ct.MPCSolver(kin.params)
    world = voxel_world(base_data)
    q0 = kin.params.retract_config[None]
    st = kin.compute_kinematics(q0 + 0.3)
    goal = solver.make_goal(ct.Pose(st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0]))
    js = ct.JointState.from_position(q0, kin.joint_names)
    solver.step(world, goal, solver.setup(q0), js)  # warm-up
    state = solver.setup(q0)
    reset_counts()
    ticks, feed = [], []
    for t in range(VOXEL_MPC_TICKS):
        t0 = time.perf_counter()
        box = box_sdf(x_vox, (shifted(PERCEPTION_BOX, VOXEL_MPC_STEP * (t + 1)),))
        world = world.update_voxel_data("esdf", torch.from_numpy(np.minimum(table_d, box)).to(DEV))
        t1 = time.perf_counter()
        res, state = solver.step(world, goal, state, js)
        res.command.position.cpu()
        t2 = time.perf_counter()
        if not torch.isfinite(res.command.position).all():
            fail(f"voxel MPC tick {t}: non-finite command")
        js = ct.JointState(position=res.command.position, velocity=res.command.velocity)
        ticks.append(dict(ms=(t2 - t1) * 1e3, feasible=bool(res.feasible[0])))
        feed.append((t1 - t0) * 1e3)
    launches, pair = counts(), sc_counts()
    if any(launches.values()):
        fail(f"voxel MPC launched IK or trajectory kernels: {launches}")
    ms = [r["ms"] for r in ticks]
    out = dict(ticks=len(ticks), tick_ms_median=statistics.median(ms), tick_ms_max=max(ms),
               hz=1e3 / statistics.median(ms), feed_ms_median=statistics.median(feed),
               feasible_rate=float(np.mean([r["feasible"] for r in ticks])), gate=VOXEL_MPC_GATE,
               launches=launches, pair_kernel_launches=pair)
    if out["feasible_rate"] < VOXEL_MPC_GATE:
        fail(f"voxel MPC feasible rate {out['feasible_rate']} under {VOXEL_MPC_GATE}: {out}")
    return out


def attached_payload(kin, suite, goals):
    """(c) the grasped box of `examples/attached_object.py` on the hand: both
    IK kernels and `traj_cost_grad` against their plain versions at the
    payload's tables, then `plan_pose` over the first ATTACH_PROBLEMS suite
    problems on the kernel route (success not gated: the payload makes some
    problems harder)."""
    held = ct.AttachmentManager(kin.params).attach_box(kin.params, ATTACH_HALF, ATTACH_OFFSET)
    planner = ct.MotionPlanner(held)
    tab = planner.ik._ik_cost.tables
    if tab.P <= ct.IKSolver(kin.params)._ik_cost.tables.P:
        fail("the payload's spheres did not reach the IK kernels' pair table")
    N = N_GOALS * N_SEEDS
    gen = torch.Generator().manual_seed(17)
    q = (torch.rand((N, kin.n_dof), generator=gen) * 2.6 - 1.3).to(DEV)
    goal7 = torch.cat([goals.position, goals.quaternion], dim=-1)
    goal7 = goal7[:, None].expand(N_GOALS, N_SEEDS, 7).reshape(N, 7).contiguous()
    wt = ikk.pack_world_arrays(ct.compile_scene(table_scene()))
    cg = compare_cost_grad(tab, wt, goal7, q, "payload/random")
    tcfg = planner.cfg.trajopt
    tt = tk.build_traj_tables(held, tcfg.rollout, tcfg.bspline, tcfg.pin_goal, DEV)
    problems, cap = suite["problems"], suite["cuboid_capacity"]
    wt0 = ikk.pack_world_arrays(motion_world(problems[0]["world"], cap))
    inputs = traj_inputs(BSplineTransition(tcfg.bspline), problems, N_TRAJ, gen, tcfg.pin_goal)
    tg = compare_traj_cost_grad(tt, wt0, inputs, "payload/suite trajectories")
    reset_counts()
    rows = []
    for i, p in enumerate(problems[:ATTACH_PROBLEMS]):
        world, goal, start = problem_inputs(kin, p, cap)
        t0 = time.perf_counter()
        res = planner.plan_pose(world, goal, start, seed=i)
        res.trajectory.position.cpu()
        if not torch.isfinite(res.trajectory.position).all():
            fail(f"payload problem {i}: non-finite trajectory")
        rows.append(dict(success=bool(res.success[0]), ms=(time.perf_counter() - t0) * 1e3,
                         attempts=planner.last_attempts))
    launches, pair = counts(), sc_counts()
    n_att = sum(r["attempts"] for r in rows)
    if launches["ik_solve"] != n_att or launches["traj_solve"] < 2 * n_att:
        fail(f"the payload plans left the kernel route: {launches}, {n_att} attempts")
    return dict(problems=len(rows), success_rate=float(np.mean([r["success"] for r in rows])),
                plan_ms_median=float(np.median([r["ms"] for r in rows])), attempts=n_att,
                live_pairs=tab.P, ik_cost_grad=cg, traj_cost_grad=tg, launches=launches,
                pair_kernel_launches=pair)


def multi_env(kin, data0, data1, goals):
    """(d) `evaluate_config_env` over 2 stacked voxel worlds x
    VOXEL_ENV_CONFIGS configurations, interleaved, against the single-world
    calls on each world's configurations: bit for bit."""
    w0, w1 = voxel_world(data0), voxel_world(data1)
    stack = ct.stack_worlds([w0, w1])
    n = 2 * VOXEL_ENV_CONFIGS
    gen = torch.Generator().manual_seed(23)
    env = torch.randperm(n, generator=gen) % 2
    q = (kin.params.retract_config.cpu() + 0.8 * torch.randn((n, kin.n_dof), generator=gen)).to(DEV)
    g = ct.Goal.from_pose(ct.Pose(goals.position[torch.arange(n) % N_GOALS],
                                  goals.quaternion[torch.arange(n) % N_GOALS]))
    rollout = ct.RobotRollout(kin.params, ct.IKConfig().rollout)
    reset_counts()
    with torch.no_grad():
        res = rollout.evaluate_config_env(stack, env.to(DEV), g, q)
        torch.cuda.synchronize()
        fields = ("cost", "pos_err", "rot_err", "feasible", "in_collision", "self_colliding")
        equal = {}
        for e, w in enumerate((w0, w1)):
            rows = torch.nonzero(env == e)[:, 0].to(DEV)
            gi = dataclasses.replace(g, goal_pos=g.goal_pos[rows], goal_quat=g.goal_quat[rows])
            one = rollout.evaluate_config(w, gi, q[rows])
            for f in fields:
                equal[f"{f}/world{e}"] = bool(torch.equal(getattr(res, f)[rows], getattr(one, f)))
    coll = [float(res.in_collision[env.to(DEV) == e].float().mean()) for e in (0, 1)]
    out = dict(worlds=2, configurations=n, equal=equal, in_collision_share=coll,
               pair_kernel_launches=sc_counts())
    if not all(equal.values()):
        fail(f"evaluate_config_env differs from the single-world calls: {out}")
    if not torch.isfinite(res.cost).all():
        fail("evaluate_config_env: non-finite cost")
    return out


def voxel_phase(kin, suite):
    """Phase `voxel`: (a) IK, (b) MPC, (c) an attached payload, (d)
    multi-environment rollouts; each part fails the run at its gate."""
    t_phase = time.perf_counter()
    x_vox = voxel_centres()
    table_d = box_sdf(x_vox, (TABLE_BOX,))
    data = np.minimum(table_d, box_sdf(x_vox, (PERCEPTION_BOX,)))
    world_v, world_c = voxel_world(data), cuboid_twin()
    goals = make_goals(kin, world_c)
    out = dict(phase="voxel", gpu=gpu_line(), grid=list(VOXEL_SHAPE), cell_m=VOXEL_CELL,
               grid_mb=float(data.nbytes / 1e6))
    out["ik"] = voxel_ik(kin, world_v, world_c, goals)
    out["mpc"] = voxel_mpc(kin, data, table_d, x_vox)
    out["attached"] = attached_payload(kin, suite, goals)
    moved = np.minimum(table_d, box_sdf(x_vox, (shifted(PERCEPTION_BOX, 0.2),)))
    out["multi_env"] = multi_env(kin, data, moved, goals)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Perception: a depth frame -> TSDF -> ESDF -> world -> IK (the perception
# example), the reference bench's perception throughput, mesh and point-cloud
# obstacles, object pose estimation and robot segmentation
# ---------------------------------------------------------------------------
# the example's frame, camera and grid (`examples/perception_to_planning.py`)
PERC_W, PERC_H = 320, 240
PERC_DIMS, PERC_CELL, PERC_ORIGIN = (96, 96, 80), 0.025, (-0.6, -0.6, -0.1)
PERC_CAM_R = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], dtype=np.float64)
PERC_CAM_P = np.array([-1.0, 0.0, 0.5])
PERC_IK_MARGIN = 0.05  # success at least the numpy-exact ESDF twin's less this
PERC_REPS = 5
# the reference bench's perception protocol (`bench.py:493-615`)
BENCH_H, BENCH_W, BENCH_F = 480, 640, 8
BENCH_GROUPS, BENCH_GROUP = 6, 8
BENCH_SPARSE = dict(pool_blocks=4096, table_size=16384, rgb_channels=True, feature_channels=8,
                    discovery_stride=8, max_active_blocks=256)
BENCH_SPHERES = (([0.15, 0.1, 1.25], 0.12), ([-0.2, -0.05, 1.3], 0.09), ([0.0, 0.25, 1.2], 0.07))
CUROBO_FRAME_MS = 2.0  # cuRobo's dual-RGBD feature-TSDF integration, quoted (BASELINE.md:48)
# a card map against the CPU's on the same frame: this share of voxels within
# MAP_ATOL (a voxel centre within an ulp of a pixel edge may read the neighbour)
MAP_SHARE, MAP_ATOL = 0.999, 1e-5
# the pose detector's small offset and limits (`tests/test_pose_estimation.py`)
POSE_BOX_HALF = (0.06, 0.09, 0.12)
POSE_TRUE_P, POSE_YAW = (0.4, 0.1, 0.3), 0.3


def pinhole(W, H, fov_deg):
    f = W / (2 * np.tan(np.radians(fov_deg) / 2))
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], dtype=np.float32)


def rot_quat(R):
    """Rotation matrix -> wxyz quaternion (w >= 0)."""
    w = np.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2
    q = np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                  (R[1, 0] - R[0, 1]) / (4 * w)])
    return (q / np.linalg.norm(q)).astype(np.float32)


def camera_dirs(W, H, K, R):
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u, float)], -1)
    return d @ R.T


def slab_depth(W, H, K, R, o, box):
    """Camera-z depth of an axis-aligned box (lo, hi) by the slab method."""
    dirs = camera_dirs(W, H, K, R)
    lo, hi = np.asarray(box[0]), np.asarray(box[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        t0, t1 = (lo - o) / dirs, (hi - o) / dirs
    tmin, tmax = np.minimum(t0, t1).max(-1), np.maximum(t0, t1).min(-1)
    return np.where((tmax > tmin) & (tmin > 0), tmin, 0.0).astype(np.float32)


def sphere_render(W, H, K, R, o, spheres, wall):
    """Camera-z depth of spheres (S, 4) before a wall at camera z = `wall`."""
    dirs = camera_dirs(W, H, K, R)
    z = np.full((H, W), wall)
    n2 = (dirs * dirs).sum(-1)
    for c, r in zip(spheres[:, :3], spheres[:, 3]):
        if r >= 0:
            oc = o - c
            b = (dirs * oc).sum(-1) / n2
            disc = b * b - ((oc * oc).sum() - r * r) / n2
            t = -b - np.sqrt(np.maximum(disc, 0))
            z = np.minimum(z, np.where((disc > 0) & (t > 0), t, np.inf))
    return z.astype(np.float32)


def camera_obs(depth, K, quat, pos, dev, rgb=None, feat=None):
    def t(a):
        return None if a is None else torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    return ct.CameraObservation(t(depth), t(K), ct.Pose(t(pos), t(quat)), rgb=t(rgb), feature=t(feat))


def grid_agreement(a, b):
    """Share of voxels whose TSDF, weight and appearance agree within
    MAP_ATOL between two maps, and the largest TSDF difference."""
    bad = torch.zeros(tuple(a.tsdf.shape), dtype=torch.bool)
    for k in ("tsdf", "weight", "rgb", "feature"):
        x, y = getattr(a, k), getattr(b, k)
        if x is not None:
            d = (x.cpu() - y.cpu()).abs().reshape(bad.shape + (-1,))
            bad |= (d > MAP_ATOL).any(-1)
    return 1.0 - float(bad.float().mean()), float((a.tsdf.cpu() - b.tsdf.cpu()).abs().max())


def mapper_centres(dims, cell, origin):
    axes = [origin[k] + cell * np.arange(dims[k]) for k in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).astype(np.float32)


def ik_launch_check(label, launches, pair):
    if any(launches.values()) or pair["sc_pair_cost"] < 1 or pair["sc_pair_grad"] < 1:
        fail(f"{label}: IK or trajectory kernels {launches}, pair kernels {pair}")


def timed_solves(solver, world, goals, reps):
    """Warm-up, then `reps` solves timed by CUDA events; (result, ms list,
    launches, pair launches) of the timed solves."""
    solver.solve_pose(world, goals)
    reset_counts()
    ms = []
    for i in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        res = solver.solve_pose(world, goals, seed=i)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    for name in ("solution", "position_error", "cost"):
        if not torch.isfinite(getattr(res, name)).all():
            fail(f"non-finite IKResult.{name}")
    return res, ms, counts(), sc_counts()


def perception_example(kin):
    """(a) The example's protocol at full size: a 320 x 240 frame of the box
    -> `FilterDepth` -> `Mapper.integrate` (96 x 96 x 80 at 2.5 cm) ->
    `get_voxel_grid` -> `compile_scene` -> `IKSolver.solve_pose`: the example's
    goal, then 100 goals x 32 seeds (FK of configurations clear of the box)
    against the same solve in the numpy-exact box ESDF on the same grid."""
    K = pinhole(PERC_W, PERC_H, 60.0)
    depth = slab_depth(PERC_W, PERC_H, K, PERC_CAM_R, PERC_CAM_P, PERCEPTION_BOX)
    quat = rot_quat(PERC_CAM_R)
    cfg = ct.MapperConfig(dims=PERC_DIMS, voxel_size=PERC_CELL, origin=PERC_ORIGIN)

    def pipeline(dev, sync):
        t = [time.perf_counter()]
        obs = ct.FilterDepth()(camera_obs(depth, K, quat, PERC_CAM_P, dev))
        sync()
        t.append(time.perf_counter())
        mapper = ct.Mapper(cfg, device=dev)
        mapper.integrate(obs)
        sync()
        t.append(time.perf_counter())
        vg = mapper.get_voxel_grid("esdf_world")
        t.append(time.perf_counter())
        world = ct.compile_scene(gt.Scene().add(vg), device=dev)
        sync()
        t.append(time.perf_counter())
        stages = dict(zip(("filter_ms", "integrate_ms", "esdf_to_host_ms", "compile_scene_ms"),
                          np.diff(t) * 1e3))
        return mapper, vg, world, stages

    runs = [pipeline(DEV, torch.cuda.synchronize) for _ in range(PERC_REPS + 1)][1:]
    mapper, vg, world, _ = runs[-1]
    stage_ms = {k: statistics.median(r[3][k] for r in runs) for k in runs[0][3]}
    cpu_mapper, cpu_vg, _, _ = pipeline(torch.device("cpu"), lambda: None)
    share, tsdf_diff = grid_agreement(mapper.grid, cpu_mapper.grid)
    occupied, occupied_cpu = int((vg.data < 0).sum()), int((cpu_vg.data < 0).sum())
    if share < MAP_SHARE or occupied == 0:
        fail(f"perception map: {share} of voxels agree with the CPU's, {occupied} occupied")
    # the mapped ESDF against the analytic box SDF on the camera's side of the
    # box, within 10 cm of its face
    x = mapper_centres(PERC_DIMS, PERC_CELL, PERC_ORIGIN)
    exact = box_sdf(x, (PERCEPTION_BOX,))
    seen = (x[..., 0] < PERCEPTION_BOX[0][0]) & (exact > 0) & (exact <= 0.1)
    gap = np.abs(vg.data - exact)[seen]

    solver = ct.IKSolver(kin.params, ct.IKConfig(n_seeds=N_SEEDS))
    one = solver.solve_pose(world, ct.Pose(torch.tensor([[0.45, 0.0, 0.75]], device=DEV),
                                           torch.tensor([[0.0, 1.0, 0.0, 0.0]], device=DEV)))
    (lo, hi) = PERCEPTION_BOX
    box_world = ct.compile_scene(gt.Scene().add(gt.Cuboid(
        name="box", pose=[(a + b) / 2 for a, b in zip(lo, hi)] + [1, 0, 0, 0],
        dims=[b - a for a, b in zip(lo, hi)])))
    goals = make_goals(kin, box_world)
    res, ms, launches, pair = timed_solves(solver, world, goals, 3)
    ik_launch_check("perception IK", launches, pair)
    twin = ct.compile_scene(gt.Scene().add(gt.VoxelGridObstacle(
        name="esdf_exact", pose=vg.pose, dims=vg.dims, voxel_size=PERC_CELL, data=exact)))
    twin_res = solver.solve_pose(twin, goals)
    valid = ct.RobotSceneCollision(kin.params).validate(box_world, res.solution)
    out = dict(frame=[PERC_H, PERC_W], grid=list(PERC_DIMS), cell_m=PERC_CELL, **stage_ms,
               map_voxels_agree_with_cpu=share, map_tsdf_max_diff_vs_cpu=tsdf_diff,
               occupied_voxels=occupied, occupied_voxels_cpu=occupied_cpu,
               esdf_max_diff_vs_cpu=float(np.abs(vg.data - cpu_vg.data).max()),
               esdf_gap_to_box_sdf_m=dict(voxels=int(seen.sum()), median=float(np.median(gap)),
                                          max=float(gap.max())),
               example_goal=dict(success=bool(one.success[0]),
                                 position_error_mm=float(one.position_error[0]) * 1e3),
               goals=N_GOALS, seeds=N_SEEDS, success_rate=float(res.success.float().mean()),
               success_exact_esdf_twin=float(twin_res.success.float().mean()),
               solved_and_clear_of_the_box=float((res.success & valid).float().sum() /
                                                 res.success.float().sum().clamp_min(1)),
               ms_per_solve_median=statistics.median(ms), ms_per_solve_min=min(ms),
               launches=launches, pair_kernel_launches=pair)
    if out["success_rate"] < out["success_exact_esdf_twin"] - PERC_IK_MARGIN:
        fail(f"perception IK success under the exact-ESDF twin's less {PERC_IK_MARGIN}: {out}")
    return out


def bench_frames(dev):
    """The bench's two cameras, 4 frames each: the tabletop (a plane 1.45 m
    from the camera and three spheres moving with the frame, raycast, 2 mm
    noise), RGB and 8 feature channels, from numpy seeds."""
    K = pinhole(BENCH_W, BENCH_H, 60.0)
    uu, vv = np.meshgrid(np.arange(BENCH_W), np.arange(BENCH_H))
    dirs = np.stack([(uu - BENCH_W / 2) / K[0, 0], (vv - BENCH_H / 2) / K[1, 1],
                     np.ones_like(uu, np.float64)], -1)
    nrm = np.linalg.norm(dirs, axis=-1)

    def frame(i, pos):
        rng = np.random.RandomState(100 + i)
        z = np.full((BENCH_H, BENCH_W), 1.45)
        for c, r in BENCH_SPHERES:
            c = np.asarray(c) + np.asarray([0.02, 0.015, 0.0]) * (i % 4)
            b = (dirs * c).sum(-1) / nrm ** 2
            disc = b * b - ((c * c).sum() - r * r) / nrm ** 2
            z = np.minimum(z, np.where(disc > 0, b - np.sqrt(np.maximum(disc, 0)), np.inf))
        depth = (z + rng.normal(0, 0.002, z.shape)).astype(np.float32)
        return camera_obs(depth, K, [1.0, 0, 0, 0], pos, dev,
                          rgb=rng.uniform(size=(BENCH_H, BENCH_W, 3)),
                          feat=rng.uniform(size=(BENCH_H, BENCH_W, BENCH_F)))

    return ([frame(i, [0.0, 0.0, -1.2]) for i in range(4)],
            [frame(i + 4, [0.3, 0.0, -1.2]) for i in range(4)])


def group_ms(call):
    """The bench's timing: one warm call, then BENCH_GROUPS groups of
    BENCH_GROUP calls (`call(i)`), the device synchronised after each group;
    ms per call of each group."""
    call(0)
    torch.cuda.synchronize()
    per = []
    for _ in range(BENCH_GROUPS):
        t0 = time.perf_counter()
        for i in range(BENCH_GROUP):
            call(i)
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3 / BENCH_GROUP)
    return per


def perception_bench():
    """(b) The reference bench's perception protocol: two 480 x 640 RGB-D
    cameras with 8 feature channels into the block-sparse pool
    (`integrate_cameras_sparse`, the bench's `BlockSparseConfig`), the dense
    128^3 grid from both cameras, and its ESDF; the card's pool against the
    CPU's after the same 4 frame pairs."""
    obs_a, obs_b = bench_frames(DEV)
    scfg = ct.BlockSparseConfig(**BENCH_SPARSE)

    def sparse_step(g, a, b):
        return bsp.integrate_cameras_sparse(scfg, g, (a, b))

    st = dict(sparse=bsp.make_sparse_grid(scfg, DEV))

    def sparse_call(i):
        st["sparse"] = sparse_step(st["sparse"], obs_a[i % 4], obs_b[i % 4])

    sparse = group_ms(sparse_call)
    sgrid = st["sparse"]
    dropped, dropped_active = int(sgrid.dropped_blocks), int(sgrid.dropped_active)
    if dropped or dropped_active:
        fail(f"perception bench: dropped blocks {dropped}, dropped actives {dropped_active}")
    # the card's pool against the CPU's after the same 4 frame pairs
    cpu_a, cpu_b = bench_frames(torch.device("cpu"))
    g_card, g_cpu = bsp.make_sparse_grid(scfg, DEV), bsp.make_sparse_grid(scfg, "cpu")
    for i in range(4):
        g_card = sparse_step(g_card, obs_a[i], obs_b[i])
        g_cpu = sparse_step(g_cpu, cpu_a[i], cpu_b[i])
    table_equal = {k: bool(torch.equal(getattr(g_card, k).cpu(), getattr(g_cpu, k)))
                   for k in ("table_key", "table_slot", "pool_coords", "n_alloc", "dropped_blocks",
                             "dropped_active")}
    payload_diff = {k: float((getattr(g_card, k).cpu() - getattr(g_cpu, k)).abs().max())
                    for k in ("tsdf", "weight", "rgb", "feature")}
    if not all(table_equal.values()) or max(payload_diff.values()) > MAP_ATOL:
        fail(f"perception bench: the card's pool differs from the CPU's: {table_equal} {payload_diff}")

    dcfg = ct.MapperConfig(dims=(128, 128, 128), rgb_channels=True, feature_channels=BENCH_F)

    def dense_step(g, a, b):
        return mpr.integrate_camera(dcfg, mpr.integrate_camera(dcfg, g, a), b)

    st["dense"] = mpr.make_grid(dcfg, DEV)

    def dense_call(i):
        st["dense"] = dense_step(st["dense"], obs_a[i % 4], obs_b[i % 4])

    dense = group_ms(dense_call)
    dgrid = st["dense"]
    esdf = group_ms(lambda i: mpr.compute_esdf(dcfg, dgrid))
    jfa_cfg = dataclasses.replace(dcfg, esdf_mode="jfa")
    jfa_ms = host_ms(lambda: mpr.compute_esdf(jfa_cfg, dgrid), reps=3)
    exact_d, jfa_d = mpr.compute_esdf(dcfg, dgrid), mpr.compute_esdf(jfa_cfg, dgrid)
    return dict(
        cameras=2, frame=[BENCH_H, BENCH_W], feature_channels=BENCH_F, config=BENCH_SPARSE,
        dual_rgbd_feature_integrate_ms_min=min(sparse),
        dual_rgbd_feature_integrate_ms_median=statistics.median(sparse),
        curobo_quoted_ms=CUROBO_FRAME_MS, vs_curobo=CUROBO_FRAME_MS / min(sparse),
        allocated_blocks=int(sgrid.n_alloc), dropped_blocks=dropped, dropped_active=dropped_active,
        pool_vs_cpu=dict(table_equal=table_equal, payload_max_abs_diff=payload_diff,
                         allocated=int(g_cpu.n_alloc)),
        dense_128_integrate_ms_min=min(dense), dense_128_integrate_ms_median=statistics.median(dense),
        esdf_128_ms=min(esdf), esdf_128_ms_median=statistics.median(esdf), esdf_128_mode="exact",
        esdf_128_jfa_ms=jfa_ms, jfa_vs_exact_max_m=float((exact_d - jfa_d).abs().max()),
        occupied_128=int((exact_d < 0).sum()))


def perception_mesh(kin):
    """(c) An icosphere mesh and a point cloud (a box's surface) beside the
    table: the native bake against its numpy plain version, then both
    obstacles through `compile_scene` and 100 goals x 32 seeds of IK around
    them on the card (generic route)."""
    phi = (1 + 5 ** 0.5) / 2
    v = [[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0], [0, -1, phi], [0, 1, phi],
         [0, -1, -phi], [0, 1, -phi], [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]]
    v = [list(np.asarray(p) / np.linalg.norm(p)) for p in v]
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
         [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
         [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(2):
        mid, nf = {}, []

        def m(a, b):
            if (min(a, b), max(a, b)) not in mid:
                p = np.asarray(v[a]) + np.asarray(v[b])
                v.append(list(p / np.linalg.norm(p)))
                mid[(min(a, b), max(a, b))] = len(v) - 1
            return mid[(min(a, b), max(a, b))]

        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        f = nf
    verts, faces = np.asarray(v) * 0.12, np.asarray(f, dtype=np.int64)
    mesh = gt.MeshObstacle(name="ball_mesh", pose=[0.5, 0.3, 0.45, 1, 0, 0, 0], vertices=verts,
                           faces=faces, voxel_size=0.02)
    t0 = time.perf_counter()
    g_native, _, _ = gmesh.mesh_to_sdf_grid(mesh)
    t1 = time.perf_counter()
    g_plain, _, _ = gmesh.mesh_to_sdf_grid(mesh, plain=True)
    t2 = time.perf_counter()
    bake_diff = float(np.abs(g_native - g_plain).max())
    if bake_diff > MAP_ATOL:
        fail(f"native mesh bake differs from the numpy one by {bake_diff}")
    rng = np.random.RandomState(5)
    pts = rng.uniform(-1, 1, (2000, 3)) * 0.1
    face = np.argmax(np.abs(pts), axis=-1)
    pts[np.arange(len(pts)), face] = np.sign(pts[np.arange(len(pts)), face]) * 0.1
    cloud = gt.PointCloudObstacle(name="crate_cloud", pose=[0.5, -0.3, 0.4, 1, 0, 0, 0], points=pts,
                                  point_radius=0.01, voxel_size=0.02)
    t3 = time.perf_counter()
    world = ct.compile_scene(table_scene().add(mesh, cloud))
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    goals = make_goals(kin, world)
    solver = ct.IKSolver(kin.params, ct.IKConfig(n_seeds=N_SEEDS))
    res, ms, launches, pair = timed_solves(solver, world, goals, 2)
    ik_launch_check("mesh IK", launches, pair)
    valid = ct.RobotSceneCollision(kin.params).validate(world, res.solution)
    return dict(mesh_vertices=len(verts), mesh_triangles=len(faces), mesh_grid=list(g_native.shape),
                native_bake_ms=(t1 - t0) * 1e3, plain_bake_ms=(t2 - t1) * 1e3,
                native_vs_plain_max_m=bake_diff, cloud_points=len(pts),
                compile_scene_ms=(t4 - t3) * 1e3, grids=[g.name for g in world.voxel_grids],
                goals=N_GOALS, seeds=N_SEEDS, success_rate=float(res.success.float().mean()),
                solved_and_clear=float((res.success & valid).float().sum() /
                                       res.success.float().sum().clamp_min(1)),
                ms_per_solve_median=statistics.median(ms), launches=launches,
                pair_kernel_launches=pair)


def perception_pose_and_mask(kin):
    """(d) `SDFPoseDetector` recovers the small offset of
    `tests/test_pose_estimation.py` on the card (and agrees with the CPU), and
    `RobotSegmenter` masks the Franka in a 480 x 640 frame with the same
    pixels as on the CPU."""
    h = np.asarray(POSE_BOX_HALF)
    verts = np.array([[sx * h[0], sy * h[1], sz * h[2]] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)])
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    mesh = gt.MeshObstacle(name="box", vertices=verts, faces=faces, voxel_size=0.01)
    rng = np.random.RandomState(0)
    local = rng.uniform(-1, 1, (256, 3)) * h
    face = np.argmax(np.abs(local) / h, axis=-1)
    local[np.arange(256), face] = np.sign(local[np.arange(256), face]) * h[face]
    c, s = np.cos(POSE_YAW), np.sin(POSE_YAW)
    pts = (local @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T + POSE_TRUE_P).astype(np.float32)
    q_true = np.array([np.cos(POSE_YAW / 2), 0, 0, np.sin(POSE_YAW / 2)], np.float32)
    p0 = (np.asarray(POSE_TRUE_P) + [0.03, -0.02, 0.01]).astype(np.float32)
    q0 = q_true + np.array([0.05, 0, 0, 0], np.float32)
    q0 = q0 / np.linalg.norm(q0)
    out = {}
    for key, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
        det = SDFPoseDetector(mesh, PoseEstimationConfig(n_iters=40), device=dev)

        def refine():
            return det.refine(ct.Pose(torch.tensor(p0, device=dev), torch.tensor(q0, device=dev)),
                              torch.tensor(pts, device=dev))

        ms = []
        for _ in range(2):  # the first call, then a warm one
            t0 = time.perf_counter()
            pose, rms = refine()
            pose.position.cpu()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[key] = (pose, rms, ms)
    pose, rms, ms = out["card"]
    pose_cpu = out["cpu"][0]
    pos_err = float(np.linalg.norm(pose.position.cpu().numpy() - POSE_TRUE_P))
    rot_err = float(2 * np.arccos(min(1.0, abs(float(np.dot(pose.quaternion.cpu().numpy(), q_true))))))
    pose_line = dict(n_points=256, n_iters=40, position_error_m=pos_err, rotation_error_rad=rot_err,
                     rms_m=float(rms), refine_first_ms=ms[0], refine_ms=ms[1],
                     vs_cpu_position_m=float((pose.position.cpu() - pose_cpu.position).norm()))
    if pos_err >= 0.01 or rot_err >= 0.1 or float(rms) >= 0.01:
        fail(f"SDFPoseDetector did not recover the pose: {pose_line}")

    R = np.array([[0, 0, -1], [1, 0, 0], [0, -1, 0]], dtype=np.float64)  # looking along -x
    origin = np.array([1.6, 0.0, 0.5])
    K = pinhole(BENCH_W, BENCH_H, 70.0)
    q = kin.params.retract_config
    spheres = kin.compute_kinematics(q).spheres.cpu().numpy()
    depth = sphere_render(BENCH_W, BENCH_H, K, R, origin, spheres, wall=2.4)
    kin_cpu = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    masks = {}
    for key, dev, k in (("card", DEV, kin), ("cpu", torch.device("cpu"), kin_cpu)):
        seg = ct.RobotSegmenter(k.params)
        obs = camera_obs(depth, K, rot_quat(R), origin, dev)
        masks[key] = seg.get_robot_mask(obs, k.params.retract_config).cpu()
    seg = ct.RobotSegmenter(kin.params)
    obs = camera_obs(depth, K, rot_quat(R), origin, DEV)
    mask_ms = host_ms(lambda: seg.get_robot_mask(obs, q), reps=5)
    n_card, n_cpu = int(masks["card"].sum()), int(masks["cpu"].sum())
    mask_line = dict(frame=[BENCH_H, BENCH_W], spheres=int((spheres[:, 3] >= 0).sum()),
                     robot_pixels=n_card, robot_pixels_cpu=n_cpu,
                     masks_equal=bool(torch.equal(masks["card"], masks["cpu"])), mask_ms=mask_ms)
    if n_card != n_cpu or n_card == 0:
        fail(f"RobotSegmenter: {mask_line}")
    return pose_line, mask_line


def perception_phase(kin):
    """Phase `perception`: (a) the example's pipeline into IK, (b) the bench's
    perception throughput, (c) mesh and point-cloud obstacles, (d) pose
    estimation and robot segmentation; each part fails the run at its gate."""
    t_phase = time.perf_counter()
    out = dict(phase="perception", gpu=gpu_line())
    out["example"] = perception_example(kin)
    out["bench"] = perception_bench()
    out["mesh"] = perception_mesh(kin)
    out["pose"], out["segmenter"] = perception_pose_and_mask(kin)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase `urdf`: the Franka loaded from URDF text, the robot builder and
# debugger, the optimizer registry, the sharded solve on a 2 x 2 mesh of the
# card, and USD export
# ---------------------------------------------------------------------------
# the 3-dof arm of `examples/build_robot_model.py` (its DEMO_URDF), copied
DEMO_URDF = """<?xml version="1.0"?>
<robot name="demo_arm">
  <link name="base_link"/>
  <link name="link1"/>
  <link name="link2"/>
  <link name="tool"/>
  <joint name="j1" type="revolute">
    <parent link="base_link"/><child link="link1"/>
    <origin xyz="0 0 0.10" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-3.0" upper="3.0" effort="50" velocity="2.0"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="link1"/><child link="link2"/>
    <origin xyz="0 0 0.25" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-2.2" upper="2.2" effort="50" velocity="2.0"/>
  </joint>
  <joint name="j3" type="revolute">
    <parent link="link2"/><child link="tool"/>
    <origin xyz="0 0 0.25" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-2.2" upper="2.2" effort="50" velocity="2.0"/>
  </joint>
</robot>
"""
# franka.yml's fields that a URDF does not carry, handed to `from_urdf`
URDF_CARRIED = ("retract_config", "cspace_weight", "null_space_weight", "self_collision_ignore",
                "self_collision_buffer", "sphere_buffer", "extra_collision_spheres",
                "max_acceleration", "max_jerk", "velocity_scale")
# link-indexed fields of KinematicsParams, compared by link name: `from_urdf`
# orders links depth first by sorted name (as the JAX package does), the YAML
# lists them breadth first
LINK_FIELDS = ("fixed_rot", "fixed_pos", "joint_axis", "mimic_mult", "mimic_offset", "link_mass",
               "link_com", "link_inertia")
# `examples/custom_optimization.py`'s menu and budgets, and the rest of the
# registry at budgets of the same order
REGISTRY_RUNS = (("lbfgs", dict(n_iters=40)), ("conjugate_gradient", dict(n_iters=60)),
                 ("lsr1", dict(n_iters=60)), ("gradient_descent", dict(n_iters=60)),
                 ("mppi", dict(n_iters=20, n_particles=64, init_std=0.4)),
                 ("es", dict(n_iters=20, n_particles=64)), ("torch", dict(max_iters=100, lr=0.05)),
                 ("scipy", dict(max_iters=20)))
# methods that draw nothing: held to the CPU's run of the same method, final
# mean cost within 1 % of the CPU's (line-search ties part the two float
# orders after a few iterations, as between the JAX and PyTorch runs: 0.11 %
# at most, conjugate gradient, in the H100 runs before this limit was set)
REGISTRY_DETERMINISTIC = ("lbfgs", "conjugate_gradient", "lsr1", "gradient_descent", "torch",
                          "scipy")
REGISTRY_REL = 0.01
# the objective's self-collision term (the pair kernels on the card, the plain
# pair sum on the CPU) and its gradient, at the start, at every method's end
# and on a sweep of configurations drawn within the limits, where pairs are
# active: the cost's largest difference over its largest CPU value, the
# gradient's median and 99th-percentile relative error over its nonzero
# entries (floor 1); a planted fault, one representative active pair left out
# of the CPU's sum, must read above the cost limit
REGISTRY_SC_REL, REGISTRY_SWEEP = 1e-4, 256
REGISTRY_POS_MM = 20.0  # the example's gate on L-BFGS's mean position error
USD_ATOL = 1e-5
USD_NUM = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")


def urdf_text(d):
    """URDF text of a robot YAML dict's `links` (origins, axes, limits, mimic
    relations, inertials, visuals named package://robot/<mesh>)."""
    def v3(x):
        return " ".join(repr(float(a)) for a in x)

    r = d["robot"] if "robot" in d else d
    out = ['<?xml version="1.0"?>', f'<robot name="{r.get("name", "robot")}">']
    for l in r["links"]:
        out.append(f'  <link name="{l["name"]}">')
        if "mass" in l:
            I = np.asarray(l.get("inertia", [0.0] * 9), np.float64).reshape(3, 3)
            out += ["    <inertial>", f'      <origin xyz="{v3(l.get("com", (0, 0, 0)))}" rpy="0 0 0"/>',
                    f'      <mass value="{float(l["mass"])!r}"/>',
                    f'      <inertia ixx="{float(I[0, 0])!r}" ixy="{float(I[0, 1])!r}" '
                    f'ixz="{float(I[0, 2])!r}" iyy="{float(I[1, 1])!r}" iyz="{float(I[1, 2])!r}" '
                    f'izz="{float(I[2, 2])!r}"/>', "    </inertial>"]
        for v in l.get("visual", []):
            out += ["    <visual>", f'      <origin xyz="{v3(v.get("origin_xyz", (0, 0, 0)))}" '
                    f'rpy="{v3(v.get("origin_rpy", (0, 0, 0)))}"/>',
                    f'      <geometry><mesh filename="package://robot/{v["mesh"]}" '
                    f'scale="{v3(v.get("scale", (1, 1, 1)))}"/></geometry>', "    </visual>"]
        out.append("  </link>")
    for l in r["links"]:
        if l.get("parent") is None:
            continue
        jt = l.get("joint_type", "fixed")
        out += [f'  <joint name="{l.get("joint_name", l["name"] + "_joint")}" type="{jt}">',
                f'    <parent link="{l["parent"]}"/>', f'    <child link="{l["name"]}"/>',
                f'    <origin xyz="{v3(l.get("origin_xyz", (0, 0, 0)))}" '
                f'rpy="{v3(l.get("origin_rpy", (0, 0, 0)))}"/>']
        # every joint's axis, the fixed ones' too: the YAML's default is z
        out.append(f'    <axis xyz="{v3(l.get("axis", (0, 0, 1)))}"/>')
        if jt != "fixed":
            lo, hi, vel, eff = l["limits"]
            out += [f'    <limit lower="{float(lo)!r}" upper="{float(hi)!r}" '
                    f'velocity="{float(vel)!r}" effort="{float(eff)!r}"/>']
        if l.get("mimic"):
            m = l["mimic"]
            out.append(f'    <mimic joint="{m["joint"]}" multiplier="{float(m.get("multiplier", 1.0))!r}" '
                       f'offset="{float(m.get("offset", 0.0))!r}"/>')
        out.append("  </joint>")
    out.append("</robot>")
    return "\n".join(out) + "\n"


def params_mismatch(a, b):
    """Fields of KinematicsParams `a` that differ from `b`'s: link-indexed
    tables and link indices compared through the link names, every other
    field exactly (tensors bit for bit)."""
    bad = []
    if sorted(a.link_names) != sorted(b.link_names):
        return ["link_names"]
    perm = torch.as_tensor([a.link_names.index(n) for n in b.link_names], device=a.device)
    name_a = lambda i: a.link_names[i] if i >= 0 else None
    name_b = lambda i: b.link_names[i] if i >= 0 else None
    for f in LINK_FIELDS:
        if not torch.equal(getattr(a, f)[perm], getattr(b, f).to(a.device)):
            bad.append(f)
    pa = {a.link_names[i]: i for i in range(a.n_links)}
    if [name_a(a.parent_idx[pa[n]]) for n in b.link_names] != [name_b(p) for p in b.parent_idx]:
        bad.append("parent_idx")
    for f in ("joint_type", "dof_idx"):
        if [getattr(a, f)[pa[n]] for n in b.link_names] != list(getattr(b, f)):
            bad.append(f)
    if [sorted(name_a(i) for i in lv) for lv in a.levels] != [sorted(name_b(i) for i in lv)
                                                               for lv in b.levels]:
        bad.append("levels")
    for f in ("sphere_link_idx", "tool_frame_idx"):
        if [name_a(i) for i in getattr(a, f)] != [name_b(i) for i in getattr(b, f)]:
            bad.append(f)
    skip = set(LINK_FIELDS) | {"link_names", "parent_idx", "joint_type", "dof_idx", "levels",
                               "sphere_link_idx", "tool_frame_idx"}

    def same(x, y):
        if isinstance(x, torch.Tensor):
            return x.dtype == y.dtype and torch.equal(x, y.to(x.device))
        if dataclasses.is_dataclass(x):
            return all(same(getattr(x, g.name), getattr(y, g.name)) for g in dataclasses.fields(x))
        return x == y

    bad += [f.name for f in dataclasses.fields(a)
            if f.name not in skip and not same(getattr(a, f.name), getattr(b, f.name))]
    return bad


def launch_counts():
    return dict(launches=counts(), pair_kernel_launches=sc_counts())


IK_FIELDS = ("solution", "success", "cost", "position_error", "rotation_error")


def urdf_franka(tmp, kin, world, goals):
    """(a) franka.yml's links written as URDF text, loaded with `from_urdf`
    and franka.yml's spheres, ignore matrix, buffers, retract and locks: the
    tables equal the YAML model's, and the bench's 100 x 32 kernel-route
    solve equals the YAML robot's bit for bit."""
    path = os.path.join(tmp, "franka.urdf")
    with open(path, "w") as fh:
        fh.write(urdf_text(load_yaml(ct.robot_config_path("franka"))))
    y = ct.RobotModelConfig.from_yaml(ct.robot_config_path("franka"))
    cfg = ct.RobotModelConfig.from_urdf(path, y.base_link, y.tool_frames,
                                        collision_spheres=y.collision_spheres,
                                        lock_joints=y.lock_joints,
                                        **{k: getattr(y, k) for k in URDF_CARRIED})
    params = ct.build_kinematics_params(cfg)
    bad = params_mismatch(params, kin.params)
    if bad:
        fail(f"URDF Franka: KinematicsParams fields differ from the YAML model's: {bad}")
    bench_cfg = bench_ik_config()
    solver_u, solver_y = ct.IKSolver(params, bench_cfg), ct.IKSolver(kin.params, bench_cfg)
    if not torch.equal(solver_u.generate_seeds(N_GOALS), solver_y.generate_seeds(N_GOALS)):
        fail("URDF Franka: its seeds differ from the YAML robot's")
    reset_counts()
    ms_u, res_u = event_samples(lambda: solver_u.solve_pose(world, goals), 10)
    if counts()["ik_solve"] != 11:
        fail(f"URDF Franka: 11 solves launched {counts()}")
    ms_y, res_y = event_samples(lambda: solver_y.solve_pose(world, goals), 10)
    differ = [f for f in IK_FIELDS if not torch.equal(getattr(res_u, f), getattr(res_y, f))]
    if differ:
        fail(f"URDF Franka: the solve differs from the YAML robot's in {differ}")
    # the repo's check of a solution, on the URDF robot's tables: FK reaches
    # the goal, and the objective kernel gives the reported cost
    kin_u = ct.Kinematics(params)
    fk_err = (kin_u.compute_kinematics(res_u.solution).tool_pose.position[:, 0] - goals.position).norm(dim=-1)
    if bool(res_u.success.any()) and float(fk_err[res_u.success].max()) > 0.005 + 1e-4:
        fail(f"URDF Franka: FK of a solution misses its goal by {float(fk_err[res_u.success].max())}")
    c_chk, _ = solver_u._ik_cost(torch.cat([goals.position, goals.quaternion], dim=-1),
                                 res_u.solution.contiguous(), world)
    c_rel = float(((c_chk - res_u.cost).abs() / (res_u.cost.abs() + 1e-2)).max())
    launches = launch_counts()
    if c_rel > 1e-3 or launches["launches"]["ik_cost_grad"] < 1:
        fail(f"URDF Franka: cost check {c_rel}, launches {launches}")
    return dict(
        links=params.n_links, spheres=params.n_spheres, pairs=int(params.self_collision.pair_a.shape[0]),
        link_order_urdf=list(params.link_names), link_order_yaml=list(kin.params.link_names),
        params_equal_by_link_name=True, goals=N_GOALS, seeds=N_SEEDS,
        success_rate=float(res_u.success.float().mean()), solve_bit_equal=list(IK_FIELDS),
        seed_solutions_max_abs_diff=float((res_u.seed_solutions - res_y.seed_solutions).abs().max()),
        ms_per_solve_median=statistics.median(ms_u), ms_per_solve_min=min(ms_u),
        ms_per_solve_median_yaml=statistics.median(ms_y), cost_check_rel_max=c_rel, **launches), path


def urdf_builder(tmp, franka_path, world, goals):
    """(b) `RobotBuilder` on the URDF Franka (skeleton spheres: no mesh
    resolves) and the demo arm, on the card and on the CPU; the built
    Franka's 100 x 32 solve beside the plain version's on the same seeds;
    `RobotDebugger` on franka.yml against the CPU's report."""
    out = {}
    reset_counts()
    built = {}
    for name, path, base, tools in (("franka", franka_path, "panda_link0", ["panda_hand"]),
                                    ("demo_arm", os.path.join(tmp, "demo_arm.urdf"), "base_link",
                                     ["tool"])):
        if name == "demo_arm":
            with open(path, "w") as fh:
                fh.write(DEMO_URDF)
        t0 = time.perf_counter()
        card = RobotBuilder(path, base, tools)
        cfg = card.build(out_path=os.path.join(tmp, f"{name}.yml"), name=name)
        card_s = time.perf_counter() - t0
        cfg_cpu = RobotBuilder(path, base, tools, device="cpu").build(name=name)
        if cfg != cfg_cpu:
            fail(f"RobotBuilder({name}): the card's config differs from the CPU's")
        retract = card.debug_retract_pose(cfg)
        if not retract["retract_ok"]:
            fail(f"RobotBuilder({name}): built model collides at retract: {retract}")
        col = cfg["robot"]["collision"]
        built[name] = os.path.join(tmp, f"{name}.yml")
        out[name] = dict(build_s=card_s, spheres=sum(map(len, col["spheres"].values())),
                         ignore_pairs=sum(map(len, col["self_collision_ignore"].values())),
                         dof=len(cfg["robot"]["actuated_joints"]), config_equal_to_cpu=True,
                         retract=retract)
    out["build_launches"] = launch_counts()

    # the built Franka (9 dof: the fingers are actuated, skeleton spheres),
    # in an empty world: the skeleton's spheres at panda_link0's origin reach
    # below z = 0, into the table (its success there is reported)
    kin_b = ct.Kinematics.from_robot_yaml(built["franka"])
    bench_cfg = bench_ik_config()
    solver = ct.IKSolver(kin_b.params, bench_cfg)
    empty = ct.compile_scene(gt.Scene())
    sr_table = float(solver.solve_pose(world, goals).success.float().mean())
    reset_counts()
    ms, res = event_samples(lambda: solver.solve_pose(empty, goals), 3)
    launches = launch_counts()
    if launches["launches"]["ik_solve"] != 4:
        fail(f"built Franka: 4 solves launched {launches}")
    D = kin_b.n_dof
    seeds = solver.generate_seeds(N_GOALS).reshape(-1, D).contiguous()
    goal7 = torch.cat([goals.position, goals.quaternion], dim=-1)
    goal7 = goal7[:, None].expand(N_GOALS, N_SEEDS, 7).reshape(-1, 7).contiguous()
    _, _, pe, re_, fe = ikk.ik_solve_plain(solver._ik_cost.tables, ikk.pack_world_arrays(empty),
                                           goal7, seeds, budget_of(bench_cfg))
    conv = ((pe <= 0.005) & (re_ <= 0.05) & (fe > 0.5)).reshape(N_GOALS, N_SEEDS)
    sr, sr_plain = float(res.success.float().mean()), float(conv.any(dim=1).float().mean())
    sph = kin_b.compute_kinematics(kin_b.params.retract_config).spheres
    out["built_franka_solve"] = dict(
        dof=D, spheres=kin_b.params.n_spheres, goals=N_GOALS, seeds=N_SEEDS, world="empty",
        success_rate=sr, success_rate_plain=sr_plain, success_rate_table_world=sr_table,
        lowest_sphere_bottom_z_at_retract=float((sph[:, 2] - sph[:, 3]).min()),
        ms_per_solve_median=statistics.median(ms), **launches)
    if abs(sr - sr_plain) > 0.05:
        fail(f"built Franka: success {sr} against the plain version's {sr_plain}")

    # the debugger on franka.yml: the card's report equals the CPU's
    kin_cpu = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    kin = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"))
    reset_counts()
    t0 = time.perf_counter()
    rep = RobotDebugger(kin.params).report()
    debug_s = time.perf_counter() - t0
    launches = launch_counts()
    rep_cpu = RobotDebugger(kin_cpu.params).report()
    keys = ("ok", "issues", "n_dof", "n_spheres", "n_self_collision_pairs", "free_fraction",
            "retract_violating_pairs", "per_link_spheres", "sphere_radius_range")
    differ = [k for k in keys if getattr(rep, k) != getattr(rep_cpu, k)]
    if differ or launches["pair_kernel_launches"]["sc_pair_viol"] < 1:
        fail(f"RobotDebugger: differs from the CPU's report in {differ}, launches {launches}")
    out["debugger"] = dict(ok=rep.ok, issues=rep.issues, free_fraction=rep.free_fraction,
                           n_spheres=rep.n_spheres, n_self_collision_pairs=rep.n_self_collision_pairs,
                           retract_violation=rep.retract_self_collision_violation,
                           report_equal_to_cpu=True, report_s=debug_s, **launches)
    return out


def registry_problem(dev):
    """`examples/custom_optimization.py`'s objective on `dev`: the Franka's
    `RobotRollout.evaluate_config` over the table, 8 goals made from the
    retract pose with a seeded offset, from the retract pose."""
    kin = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device=dev)
    p = kin.params
    world = ct.compile_scene(table_scene(), device=dev)
    rollout = RobotRollout(p, RobotRolloutConfig())
    rng = np.random.RandomState(0)
    q_true = torch.as_tensor(p.retract_config.cpu().numpy() + rng.uniform(-0.5, 0.5, (8, p.n_dof)),
                             dtype=torch.float32, device=dev)
    st = kin.compute_kinematics(q_true)
    goal = Goal.from_pose(ct.Pose(st.tool_pose.position[:, 0], st.tool_pose.quaternion[:, 0]))
    sc_cfg = rollout.cfg.self_collision_cost
    return dict(cost=lambda q: rollout.evaluate_config(world, goal, q).cost,
                x0=p.retract_config.expand(8, p.n_dof), lo=p.joint_limits.lower,
                hi=p.joint_limits.upper, pos_err=lambda q: rollout.evaluate_config(world, goal, q).pos_err,
                spheres=lambda q: kin.compute_kinematics(q).spheres,
                sc=lambda q, sc=p.self_collision: cost_terms.self_collision_cost_term(
                    sc, kin.compute_kinematics(q).spheres, sc_cfg), sc_params=p.self_collision)


def registry_sc_check(prob, prob_cpu, points):
    """The objective's self-collision term and its gradient on the card
    against the CPU's at the named batches of configurations `points`, and a
    planted fault's reading (module comment of REGISTRY_SC_REL)."""
    names = list(points)
    q = torch.cat([points[k].detach().cpu() for k in names])
    lo, hi = prob_cpu["lo"].numpy(), prob_cpu["hi"].numpy()
    sweep = np.random.RandomState(1).uniform(lo, hi, (REGISTRY_SWEEP, lo.shape[0]))
    q = torch.cat([q, torch.as_tensor(sweep, dtype=torch.float32)])

    def cost_grad(pr, x, **kw):
        x = x.clone().requires_grad_(True)
        c = pr["sc"](x, **kw)
        return c.detach(), torch.autograd.grad(c.sum(), x)[0]

    c_k, g_k = cost_grad(prob, q.to(DEV))
    c_k, g_k = c_k.cpu(), g_k.cpu()
    c_p, g_p = cost_grad(prob_cpu, q)
    big = float(c_p.abs().max())
    g = grad_agreement(g_k, g_p)
    # the planted fault: the active pair of median summed hinge over the sweep
    sc = prob_cpu["sc_params"]
    with torch.no_grad():
        x = prob_cpu["spheres"](q[-REGISTRY_SWEEP:])
        d = (x[:, sc.pair_a.long(), :3] - x[:, sc.pair_b.long(), :3]).norm(dim=-1)
        hinge = torch.relu(sc.pair_margin - d).sum(dim=0)
    active = torch.nonzero(hinge > 0).flatten()
    pair = int(active[torch.argsort(hinge[active])[active.numel() // 2]]) if active.numel() else -1
    planted = float("nan")
    if pair >= 0:
        margin = sc.pair_margin.clone()
        margin[pair] = -float("inf")
        c_f, _ = cost_grad(prob_cpu, q, sc=dataclasses.replace(sc, pair_margin=margin))
        planted = float((c_f - c_p).abs().max()) / big
    out, i = dict(points={}), 0
    for k in names + ["sweep"]:
        n = points[k].shape[0] if k != "sweep" else REGISTRY_SWEEP
        out["points"][k] = dict(mean_card=float(c_k[i:i + n].mean()), mean_cpu=float(c_p[i:i + n].mean()),
                                nonzero=int((c_p[i:i + n] > 0).sum()), n=n)
        i += n
    out.update(max_abs_cpu=big, cost_max_abs_err_over_max=float((c_k - c_p).abs().max()) / big if big else
               float("inf"), grad=g, planted_pair=pair, planted_pair_hinge_sum=float(hinge[pair]) if pair >= 0
               else 0.0, planted_cost_max_abs_err_over_max=planted)
    if not (out["cost_max_abs_err_over_max"] <= REGISTRY_SC_REL and g["rel_median"] < COST_MED
            and g["rel_p99"] < COST_P99):
        fail(f"registry: the self-collision term on the card differs from the CPU's: {out}")
    if not planted > REGISTRY_SC_REL:
        fail(f"registry: a pair left out of the sum does not show in the self-collision check: {out}")
    return out


def urdf_registry():
    """(c) every registry method on the example's objective on the card; the
    deterministic ones also on the CPU."""
    prob, prob_cpu = registry_problem(DEV), registry_problem(torch.device("cpu"))
    c0 = float(prob["cost"](prob["x0"]).mean())
    out = dict(problems=8, start_mean_cost=c0, methods={})
    # one iteration of each first: the ms below are steady state (the first
    # `torch.optim` step imports much of torch's compiler stack)
    for name, _ in REGISTRY_RUNS:
        budget = {"max_iters": 1} if name in ("torch", "scipy") else {"n_iters": 1}
        opt_factory.optimize(name, prob["cost"], prob["x0"], opt_factory.make_config(name, **budget),
                             lower=prob["lo"], upper=prob["hi"],
                             generator=torch.Generator(device=DEV).manual_seed(0))
    reset_counts()
    ends = {"start": prob["x0"]}
    for name, kw in REGISTRY_RUNS:
        cfg = opt_factory.make_config(name, **kw)
        gen = torch.Generator(device=DEV).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, c = opt_factory.optimize(name, prob["cost"], prob["x0"], cfg, lower=prob["lo"],
                                    upper=prob["hi"], generator=gen)
        torch.cuda.synchronize()
        row = dict(ms=(time.perf_counter() - t0) * 1e3, mean_cost=float(c.mean()))
        if not (torch.isfinite(x).all() and row["mean_cost"] < c0):
            fail(f"registry {name}: mean cost {row['mean_cost']} from {c0}")
        ends[name] = x
        if name in REGISTRY_DETERMINISTIC:
            t0 = time.perf_counter()
            xc, cc = opt_factory.optimize(name, prob_cpu["cost"], prob_cpu["x0"], cfg,
                                          lower=prob_cpu["lo"], upper=prob_cpu["hi"])
            row.update(ms_cpu=(time.perf_counter() - t0) * 1e3, mean_cost_cpu=float(cc.mean()),
                       max_abs_x_vs_cpu=float((x.cpu() - xc).abs().max()))
            row["mean_cost_rel_diff_vs_cpu"] = abs(row["mean_cost"] - row["mean_cost_cpu"]) / row["mean_cost_cpu"]
            if row["mean_cost_rel_diff_vs_cpu"] > REGISTRY_REL:
                fail(f"registry {name}: the card's run parts from the CPU's: {row}")
        if name == "lbfgs":
            row["mean_position_error_mm"] = float(prob["pos_err"](x).mean()) * 1e3
            if row["mean_position_error_mm"] >= REGISTRY_POS_MM:
                fail(f"registry lbfgs: mean position error {row['mean_position_error_mm']} mm")
        out["methods"][name] = row
    out.update(launch_counts())
    out["self_collision"] = registry_sc_check(prob, prob_cpu, ends)
    out["tolerance"] = (f"deterministic methods: |mean cost - CPU's| <= {REGISTRY_REL} CPU's; "
                        f"lbfgs mean position error < {REGISTRY_POS_MM} mm; self-collision term: "
                        f"max |card - CPU| <= {REGISTRY_SC_REL} max |CPU|, gradient relative median "
                        f"< {COST_MED}, p99 < {COST_P99}")
    if min(out["pair_kernel_launches"][k] for k in ("sc_pair_cost", "sc_pair_grad")) < 1:
        fail(f"registry: the pair kernels did not launch: {out['pair_kernel_launches']}")
    return out


def urdf_sharded(kin, world, goals):
    """(d) `solve_ik_sharded` over the bench's 100 x 32 on a 2 x 2 mesh of
    the card at the bench budget (no particle stage) against the unsharded
    solve from the same seeds: bit-equal wherever a seed converged; a problem
    no seed solves is held to the JAX rule (the block winner of least
    position error)."""
    solver = ct.IKSolver(kin.params, bench_ik_config())
    goal = Goal.from_pose(goals)
    seeds = solver.generate_seeds(N_GOALS)
    mesh = pmesh.make_mesh_2d(2, 2, [DEV] * 4)
    ms_ref, ref = event_samples(lambda: solver.solve_pose(world, goals), 5)
    gen = torch.Generator(device=DEV).manual_seed(0)
    reset_counts()
    ms_sh, res = event_samples(lambda: pmesh.solve_ik_sharded(solver, world, goal, seeds, gen, mesh), 5)
    launches = launch_counts()
    if launches["launches"]["ik_solve"] != 4 * 6:
        fail(f"sharded IK: 6 solves of 4 blocks launched {launches}")
    ok = ref.success
    differ = [f for f in IK_FIELDS if not torch.equal(getattr(res, f)[ok], getattr(ref, f)[ok])]
    if differ or not torch.equal(res.success, ref.success):
        fail(f"sharded IK: differs from the unsharded solve in {differ}")
    if not bool(ok.all()):
        # per seed block, the winner of that block: the rule's least error
        h = N_SEEDS // 2
        blocks = [solver._solve_seeds(world, goal, seeds[:, h * j:h * j + h], 0) for j in range(2)]
        least = torch.minimum(blocks[0].position_error, blocks[1].position_error)
        if not torch.equal(res.position_error[~ok], least[~ok]):
            fail("sharded IK: a failed problem does not take the least position error")
    return dict(mesh=[2, 2], device=str(DEV), goals=N_GOALS, seeds=N_SEEDS,
                success_rate=float(ok.float().mean()), failed_problems=int((~ok).sum()),
                bit_equal_fields=list(IK_FIELDS), seed_solutions_bit_equal=bool(
                    torch.equal(res.seed_solutions, ref.seed_solutions)),
                ms_sharded_median=statistics.median(ms_sh), ms_unsharded_median=statistics.median(ms_ref),
                **launches)


def usd_prims(text):
    return re.findall(r'def (\w+) "([^"]+)"', text)


def urdf_usd(tmp, kin, suite):
    """(e) `export_plan_usd` of suite problem 0's plan: FK on the card and on
    the CPU give the same prims, numbers within USD_ATOL."""
    p0 = suite["problems"][0]
    world, goal, start = problem_inputs(kin, p0, suite["cuboid_capacity"])
    planner = ct.MotionPlanner(kin.params)
    reset_counts()
    res = planner.plan_pose(world, goal, start, seed=0)
    scene = gt.Scene().add(*[gt.Cuboid(**o) for o in p0["world"]["cuboids"]])
    paths = dict(card=os.path.join(tmp, "plan_card.usda"), cpu=os.path.join(tmp, "plan_cpu.usda"))
    t0 = time.perf_counter()
    usd_export.export_plan_usd(paths["card"], scene, kin.params, res.trajectory)
    export_s = time.perf_counter() - t0
    launches = launch_counts()
    kin_cpu = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    traj_cpu = ct.JointState.from_position(res.trajectory.position.cpu())
    usd_export.export_plan_usd(paths["cpu"], scene, kin_cpu.params, traj_cpu)
    texts = {k: open(v).read() for k, v in paths.items()}
    la, lb = texts["card"].splitlines(), texts["cpu"].splitlines()
    worst = 0.0
    same = usd_prims(texts["card"]) == usd_prims(texts["cpu"]) and len(la) == len(lb)
    for x, y in zip(la, lb):
        nx, ny = USD_NUM.findall(x), USD_NUM.findall(y)
        same = same and USD_NUM.sub("#", x) == USD_NUM.sub("#", y) and len(nx) == len(ny)
        if nx and len(nx) == len(ny):
            worst = max(worst, float(np.abs(np.asarray(nx, float) - np.asarray(ny, float)).max()))
    if not same or worst > USD_ATOL:
        fail(f"USD export: the card's stage differs from the CPU's (max number diff {worst})")
    return dict(plan_success=bool(res.success[0]), frames=int(res.trajectory.position.shape[-2]),
                prims=len(usd_prims(texts["card"])), lines=len(la), bytes=len(texts["card"]),
                max_abs_number_diff_vs_cpu=worst, export_s=export_s, **launches)


def urdf_phase(kin, suite):
    """Phase `urdf`: (a) the URDF Franka, (b) the builder and debugger, (c)
    the optimizer registry, (d) the sharded solve, (e) USD export; each part
    fails the run at its gate."""
    t_phase = time.perf_counter()
    out = dict(phase="urdf", gpu=gpu_line())
    world = ct.compile_scene(table_scene())
    goals = make_goals(kin, world)
    with tempfile.TemporaryDirectory() as tmp:
        out["franka"], franka_path = urdf_franka(tmp, kin, world, goals)
        parts = (("builder", lambda: urdf_builder(tmp, franka_path, world, goals)),
                 ("registry", urdf_registry), ("sharded", lambda: urdf_sharded(kin, world, goals)),
                 ("usd", lambda: urdf_usd(tmp, kin, suite)))
        for name, part in parts:
            # each part's line as it ends (a later part's failure keeps them)
            emit(dict(phase="urdf_part", done=list(out)[2:], seconds=time.perf_counter() - t_phase))
            out[name] = part()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main():
    quick = "--quick" in sys.argv[1:]
    t_start = time.perf_counter()
    torch.cuda.set_device(DEV)
    out_dir = OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    try:
        alone = [a for a in sys.argv[1:]
                 if a in ("--g1", "--retarget", "--torque", "--voxel", "--perception", "--urdf")]
        if alone:
            emit(dict(phase="env", gpu=gpu_line(), torch=torch.__version__, cuda=torch.version.cuda))
            kin = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"))
            if "--g1" in alone:
                emit(g1_phase(out_dir)[0])
            if "--retarget" in alone:
                emit(retarget_phase())
            if "--torque" in alone:
                emit(torque_phase(kin, motion_suite(), out_dir, t_start))
            if "--voxel" in alone:
                emit(voxel_phase(kin, motion_suite()))
            if "--perception" in alone:
                emit(perception_phase(kin))
            if "--urdf" in alone:
                emit(urdf_phase(kin, motion_suite()))
            return
        run(quick, t_start, out_dir)
    finally:
        with open(os.path.join(out_dir, "chip_smoke.jsonl"), "w") as fh:
            fh.write("".join(l + "\n" for l in LOG_LINES))


# the kernels whose spills fail the build, by library (ptxas names; every
# pair kernel is a template per candidates-per-warp width, and the forward's
# ILb0E is the sum, ILb1E the maximum: a name matches all its instances)
NO_SPILL = {"ik_kernels": ("ik_solve_kernel",), "traj_kernels": ("traj_solve_kernel",),
            "self_collision": ("sc_fwd_kernelILb0E", "sc_fwd_kernelILb1E", "sc_grad_kernel",
                               "sc_sum_parts_kernel")}


def build_phase(out_dir, names=None):
    """Build the libraries (one nvcc each, all started together), keep the
    compiler's logs, and fail where a kernel of NO_SPILL spills. Returns the
    `build` line, the ptxas summaries and the seconds."""
    secs = kbuild.build_all(names)
    for n in secs:
        with open(os.path.join(out_dir, f"build_{n}.log"), "w") as fh:
            fh.write(kbuild.build_log(n))
    ptx = {n: ptxas_summary(kbuild.build_log(n)) for n in secs}
    warnings = [l.strip() for n in secs for l in kbuild.build_log(n).splitlines() if "warning" in l.lower()]
    line = dict(phase="build", seconds=secs, libraries=[kbuild.library_path(n) for n in secs],
                warnings=warnings[:20], ptxas_summary=ptx, logs=out_dir)
    for lib in secs:
        for kernel in NO_SPILL.get(lib, ()):
            spills = ptxas_of(ptx[lib], kernel)["spill_stores_with_callees"]
            if spills:
                fail(f"{kernel} spills {spills} bytes (-Xptxas -v, {lib})")
    return line, ptx, secs


def sc_ptxas_entries(ptx, kernel):
    """Registers and spills of each instance of a pair kernel (one per
    candidates-per-warp width: ...Li32E... is cw 32)."""
    out = {}
    for fn, v in ptx.items():
        m = re.search(r"Li(\d+)EE", fn)
        if kernel in fn and ":" not in fn and m:
            out[f"cw{m.group(1)}"] = dict(registers=v.get("registers"),
                                          spill_stores=v.get("spill_stores", 0),
                                          spill_loads=v.get("spill_loads", 0))
    return out


URDF_PARTS = {"franka": ("franka",), "builder": ("builder", "build_launches"),
              "built_franka_solve": ("builder", "built_franka_solve"),
              "debugger": ("builder", "debugger"), "registry": ("registry",),
              "sharded": ("sharded",), "usd": ("usd",)}


def new_path_launches(name, torque, voxel, perception, urdf):
    """A kernel's launches on the paths of phases `torque`, `voxel`,
    `perception` and `urdf` (per part)."""
    def of(d):
        return d.get("launches", {}).get(name, d.get("pair_kernel_launches", {}).get(name, 0))

    def part_of(keys):
        d = urdf
        for k in keys:
            d = d[k]
        return of(d)

    return dict(launches_torque_phase=of(torque), launches_voxel_phase={
        part: of(voxel[part]) for part in ("ik", "mpc", "attached", "multi_env")},
        launches_perception_phase={part: of(perception[part]) for part in ("example", "mesh")},
        launches_urdf_phase={part: part_of(keys) for part, keys in URDF_PARTS.items()})


def sc_kernel_lines(sc, g1, generic, rt, ptx, torque, voxel, perception, urdf):
    """The `kernels` entries of the three pair kernels: times at the G1 line
    search (the main fields), the retarget robot's global and local frames
    and the Franka; launches in phase `retarget` (the slice's main path; per
    part) and in phases `g1` and `generic`."""
    cases = {c["case"]: c for c in sc["cases"]}
    g, rg, rl, fr = (cases[k] for k in ("g1/line_search", "retarget/global_frame",
                                         "retarget/local_frame", "franka"))
    err_key = dict(sc_pair_cost="max_abs_err_cost", sc_pair_grad="max_abs_err_grad",
                   sc_pair_viol="max_abs_err_viol")
    ptx_name = dict(sc_pair_cost="sc_fwd_kernelILb0E", sc_pair_grad="sc_grad_kernelI",
                    sc_pair_viol="sc_fwd_kernelILb1E")
    replaces = dict(sc_pair_cost="curobo_tpu/ops/pallas_ik.py:710",
                    sc_pair_grad="curobo_tpu/ops/pallas_ik.py:710",
                    sc_pair_viol="curobo_tpu/ops/pallas_ik.py:789")
    def shape(c):
        return f"N={c['candidates']} S={c['spheres']} P={c['live_pairs']}"

    lines = []
    for k in SC_KERNELS:
        per_part = {part: n[k] for part, n in rt["launches_per_part"].items()}
        line = dict(
            name=k, route="cuda", source="curobo_tpu_torch/ops/csrc/self_collision.cu",
            replaces=replaces[k], launches=sum(per_part.values()),
            max_abs_err=max(c[err_key[k]] for c in sc["cases"]),
            tolerance=("|viol_kernel - viol_plain| <= 1e-6 m" if k == "sc_pair_viol" else
                       f"relative error: median < {COST_MED}, 99th percentile < {COST_P99}"),
            ms=g["ms"][k], plain_ms=g["plain_ms"][k], bound_ms=g["bound_ms"][k],
            bound_by=g["bound_by"][k], library_ms=None,
            shape=shape(g) + " unitree_g1, one line search of the G1 solve's seeds",
            launches_retarget_per_part=per_part,
            launches_g1_phase=g1["pair_kernel_launches"][k],
            launches_generic_phase=generic["pair_kernel_launches"][k],
            **new_path_launches(k, torque, voxel, perception, urdf),
            device_ms=g["device_ms"][k], device_ms_retarget_global=rg["device_ms"][k],
            device_ms_retarget_local=rl["device_ms"][k], device_ms_franka=fr["device_ms"][k],
            shape_retarget_global=shape(rg), ms_retarget_global=rg["ms"][k],
            plain_ms_retarget_global=rg["plain_ms"][k], bound_ms_retarget_global=rg["bound_ms"][k],
            shape_retarget_local=shape(rl), ms_retarget_local=rl["ms"][k],
            plain_ms_retarget_local=rl["plain_ms"][k], bound_ms_retarget_local=rl["bound_ms"][k],
            shape_franka=shape(fr), ms_franka=fr["ms"][k], plain_ms_franka=fr["plain_ms"][k],
            bound_ms_franka=fr["bound_ms"][k],
            redesigned="PR 8", geometry={c["case"]: c["geometry"] for c in sc["cases"]},
            # the G1 shape runs the 32-candidates-per-warp instance
            ptxas=ptxas_of(ptx, ptx_name[k] + "Li32E"),
            ptxas_per_entry=sc_ptxas_entries(ptx, ptx_name[k]))
        if k == "sc_pair_grad":
            line.update(also_replaces="the custom_vjp backward of sc_matmul_cost",
                        plain_is="the chunked scatter (index_add_) of the plain sum",
                        plain_ms_tiled=g["plain_ms"]["sc_pair_grad_tiled"],
                        bound_ms_as_executed=g["bound_ms_grad_as_executed"],
                        bound_ms_as_executed_retarget_local=rl["bound_ms_grad_as_executed"])
        lines.append(line)
    return lines


def run(quick, t_start, out_dir):
    gpu = gpu_line()
    env = dict(phase="env", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
               python=sys.version.split()[0])
    emit(env)

    # ---- build ------------------------------------------------------------
    build, ptx, secs = build_phase(out_dir)
    emit(build)
    # the route predicate's constants (`ik_kernels.robot_takes_kernel`) against
    # the built library and the card
    optin = getattr(torch.cuda.get_device_properties(DEV), "shared_memory_per_block_optin",
                    ikk.IK_SMEM_BYTES)
    if ikk.IK_MAXD != ikk._lib().ik_max_dof() or ikk.IK_SMEM_BYTES != optin:
        fail(f"robot_takes_kernel's constants: IK_MAXD {ikk.IK_MAXD} vs ik_max_dof() "
             f"{ikk._lib().ik_max_dof()}, IK_SMEM_BYTES {ikk.IK_SMEM_BYTES} vs the card's {optin}")

    # ---- set-up -------------------------------------------------------------
    kin = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"))
    world = ct.compile_scene(table_scene())
    world_mixed = ct.compile_scene(mixed_scene())
    goals = make_goals(kin, world)
    bench_cfg = bench_ik_config()
    solver = ct.IKSolver(kin.params, bench_cfg)
    tab = solver._ik_cost.tables
    wt, wt_mixed = ikk.pack_world_arrays(world), ikk.pack_world_arrays(world_mixed)
    N = N_GOALS * N_SEEDS
    D = kin.n_dof
    seeds = solver.generate_seeds(N_GOALS).reshape(N, D).contiguous()
    goal7 = torch.cat([goals.position, goals.quaternion], dim=-1)
    goal7 = goal7[:, None].expand(N_GOALS, N_SEEDS, 7).reshape(N, 7).contiguous()
    gen = torch.Generator(device="cpu").manual_seed(0)
    q_rand = (torch.rand((N, D), generator=gen) * 2.6 - 1.3).to(DEV)

    # ---- kernels against their plain versions ----------------------------------
    cmp = dict(phase="compare", limits=dict(
        cost_rel_median=COST_MED, cost_rel_p99=COST_P99, loop_cost_rel_median=LOOP_COST_MED,
        loop_x_agree_frac=LOOP_X_FRAC, loop_x_tol=LOOP_X_TOL))
    cg = [compare_cost_grad(tab, wt, goal7, seeds, "table/seeds"),
          compare_cost_grad(tab, wt, goal7, q_rand, "table/random"),
          compare_cost_grad(tab, wt_mixed, goal7, q_rand, "mixed/random")]
    cmp["ik_cost_grad"] = cg

    shallow = ikk.IKSolveBudget(mppi_iters=0, lbfgs_iters=3, history=4, n_linesearch=2,
                                warmup_iters=4, warmup_history=6)
    shallow_mppi = dataclasses.replace(shallow, mppi_iters=2, n_particles=4)
    noise = torch.randn((2, 4, N, D), generator=gen).to(DEV)
    sv = []
    sv.append(compare_solve(tab, wt, goal7, seeds, shallow, "shallow/table")[0])
    sv.append(compare_solve(tab, wt_mixed, goal7, q_rand, shallow, "shallow/mixed")[0])
    sv.append(compare_solve(tab, wt_mixed, goal7, q_rand, shallow_mppi,
                            "shallow+mppi/injected-noise", noise=noise)[0])
    lb_only = ikk.IKSolveBudget(mppi_iters=0, lbfgs_iters=3, history=4, n_linesearch=2)
    sv.append(compare_solve(tab, wt, goal7, seeds, lb_only, "lbfgs-only (build_lbfgs_solver)")[0])
    mp_only = ikk.IKSolveBudget(mppi_iters=2, n_particles=4, lbfgs_iters=0, history=1)
    sv.append(compare_solve(tab, wt, goal7, seeds, mp_only, "mppi-only (build_mppi_solver)",
                            noise=noise)[0])

    # in-kernel Philox noise: the debug entry gives the normals the solve draws
    z_k = ikk.philox_normal(7, N, 2, 4, D, DEV)
    z_p = ikk.philox_normal_plain(7, N, 2, 4, D, DEV)
    z_big = ikk.philox_normal(11, N, 8, 32, D, DEV)
    torch.cuda.synchronize()
    philox = dict(max_abs_vs_plain=float((z_k - z_p).abs().max()),
                  mean=float(z_big.mean()), var=float(z_big.var()),
                  n=int(z_big.numel()))
    if philox["max_abs_vs_plain"] > 1e-3:
        fail(f"philox_normal kernel disagrees with its plain version: {philox}")
    # standard error of the mean of n normals is 1/sqrt(n): allow six of them
    if abs(philox["mean"]) > 6.0 / philox["n"] ** 0.5 or abs(philox["var"] - 1.0) > 0.01:
        fail(f"in-kernel normals are not standard normal: {philox}")
    cmp["philox"] = philox
    # the same solve with the generator inside the kernel (noise=None) against
    # the plain version fed the normals of the debug entry
    sv.append(compare_solve(tab, wt_mixed, goal7, q_rand, shallow_mppi,
                            "shallow+mppi/in-kernel-philox", seed=7, noise=None,
                            plain_noise=z_k)[0])
    cmp["ik_solve"] = sv
    emit(cmp)
    suite = motion_suite()
    tcmp = traj_compare(kin, suite)
    tcmp["long_horizon"] = traj_compare_long_horizon(kin, suite)
    tcmp["big_world"] = compare_big_world(kin, suite, tab, goal7, q_rand)
    emit(dict(phase="compare_traj", limits=dict(
        rel_median=COST_MED, rel_p99=COST_P99, feasible_agree_frac=0.99,
        loop_cost_rel_median=LOOP_COST_MED, loop_x_agree_frac=LOOP_X_FRAC,
        loop_x_tol=LOOP_X_TOL), **tcmp))
    mpc_cmp = compare_mpc_kernel(kin)
    emit(dict(phase="compare_mpc_kernel", limits=dict(
        loop_cost_rel_median=LOOP_COST_MED, loop_x_agree_frac=LOOP_X_FRAC,
        loop_x_tol=LOOP_X_TOL), traj_solve=mpc_cmp))

    if quick:
        emit(dict(phase="quick", seconds=time.perf_counter() - t_start))
        return

    # ---- the two budgets at full depth: outcome statistics ------------------------
    bench_b = budget_of(bench_cfg)
    default_cfg = ct.IKConfig()
    default_b = budget_of(default_cfg)
    full_bench, _ = compare_solve(tab, wt, goal7, seeds, bench_b, "bench-budget", strict=False)
    noise_d = torch.randn((default_b.mppi_iters, default_b.n_particles, N, D), generator=gen).to(DEV)
    full_inj, out_inj = compare_solve(tab, wt, goal7, seeds, default_b, "default/injected-noise",
                                      noise=noise_d, strict=False)
    out_phx = ikk.ik_solve(tab, wt, goal7, seeds, default_b, 3, None)
    torch.cuda.synchronize()

    def problem_success(out):
        _, _, pe, re, fe = out
        conv = (pe <= 0.005) & (re <= 0.05) & (fe > 0.5)
        return float(conv.reshape(N_GOALS, N_SEEDS).any(dim=1).float().mean())

    sr_inj, sr_phx = problem_success(out_inj), problem_success(out_phx)
    if sr_phx < sr_inj - 0.02:
        fail(f"success with in-kernel noise {sr_phx} is lower than with injected noise {sr_inj}")
    full_traj = compare_traj_full(kin, suite)
    emit(dict(phase="compare_full", bench=full_bench, default_injected=full_inj,
              success_injected_noise=sr_inj, success_philox_noise=sr_phx, traj_solve=full_traj))

    # ---- kernel timings at the main path's shapes -----------------------------------
    ms_cg = time_ms(lambda: ikk.ik_cost_grad(tab, wt, goal7, seeds, True), reps=20, warm=2)
    plain_cg = time_ms(lambda: ikk.ik_cost_grad_plain(tab, wt, goal7, seeds, True), reps=5)
    ms_solve = time_ms(lambda: ikk.ik_solve(tab, wt, goal7, seeds, bench_b, 0, None), reps=10)
    ms_solve_default = time_ms(lambda: ikk.ik_solve(tab, wt, goal7, seeds, default_b, 0, None), reps=5)
    # the trajectory kernels at the planner's shapes: 4 seed trajectories of
    # problem 0 (traj_solve at the trajopt budget) and the final check of one
    # trajectory (traj_cost_grad, metrics mode)
    tcfg = ct.TrajOptConfig()
    tt = tk.build_traj_tables(kin.params, tcfg.rollout, tcfg.bspline, True, DEV)
    traj_b = traj_budget_of(tcfg)
    p0 = suite["problems"][0]
    wt0 = ikk.pack_world_arrays(motion_world(p0["world"], suite["cuboid_capacity"]))
    tr = BSplineTransition(tcfg.bspline)
    g4 = torch.Generator(device="cpu").manual_seed(4)
    in4 = traj_inputs(tr, [p0], 4, g4, True, start_noise=0.0, end_noise=0.01, knot_noise=0.0)
    in1 = tuple(t[:1] for t in in4)
    in8 = traj_inputs(tr, [p0], 8, g4, True, start_noise=0.0, end_noise=0.01, knot_noise=0.01)
    ms_ts = time_ms(lambda: tk.traj_solve(tt, wt0, *in4, traj_b), reps=5)
    ms_ts8 = time_ms(lambda: tk.traj_solve(tt, wt0, *in8, traj_b), reps=5)
    plain_ts = time_ms(lambda: tk.traj_solve_plain(tt, wt0, *in4, traj_b), reps=1, warm=0)
    ms_tm = time_ms(lambda: tk.traj_cost_grad(tt, wt0, *in1, "metrics"), reps=20, warm=2)
    plain_tm = time_ms(lambda: tk.traj_cost_grad_plain(tt, wt0, *in1, "metrics"), reps=5)
    in1k = traj_inputs(tr, suite["problems"], N_TRAJ, g4, True)
    ms_tg1k = time_ms(lambda: tk.traj_cost_grad(tt, wt0, *in1k, "grad"), reps=5)
    # ik_solve at the planner's shape: one goal x 32 seeds, the default budget
    g32 = in4[0][:1].expand(N_SEEDS, 7).contiguous()
    s32 = solver.generate_seeds(1, in4[2][:1]).reshape(N_SEEDS, D).contiguous()
    ms_ik32 = time_ms(lambda: ikk.ik_solve(tab, wt0, g32, s32, default_b, 0, None), reps=5)
    du = dual_setup()
    emit(dict(phase="determinism", **determinism(tab, wt0, g32, s32, default_b, tt, wt0, in4,
                                                  traj_b, du)))

    # ---- main path, twice: bench budget and the default IKConfig ----------------------
    ikk.ik_solve.launches = 0
    ikk.ik_cost_grad.launches = 0
    ikk.philox_normal.launches = 0
    solve_lines = []
    n_solves = 0
    for label, cfg in (("bench", bench_cfg), ("default", default_cfg)):
        slv = ct.IKSolver(kin.params, cfg)
        before = ikk.ik_solve.launches
        res = slv.solve_pose(world, goals)  # warm-up solve
        torch.cuda.synchronize()
        reps = 10
        times = []
        for i in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            res = slv.solve_pose(world, goals, seed=i)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        launched = ikk.ik_solve.launches - before
        n_solves += reps + 1
        if launched != reps + 1:
            fail(f"{label}: {reps + 1} solves launched ik_solve {launched} times")
        for name in ("solution", "position_error", "rotation_error", "cost", "seed_solutions"):
            if not torch.isfinite(getattr(res, name)).all():
                fail(f"{label}: IKResult.{name} has non-finite values")
        if res.solution.shape != (N_GOALS, D) or res.seed_solutions.shape != (N_GOALS, N_SEEDS, D):
            fail(f"{label}: unexpected result shapes")
        # the repo's own check of a solution: FK of the returned configuration
        # reaches the goal, and the objective kernel gives the reported cost
        st = kin.compute_kinematics(res.solution)
        fk_err = (st.tool_pose.position[:, 0] - goals.position).norm(dim=-1)
        ok = res.success
        if bool(ok.any()) and float(fk_err[ok].max()) > 0.005 + 1e-4:
            fail(f"{label}: FK of a successful solution misses its goal by {float(fk_err[ok].max())}")
        g7 = torch.cat([goals.position, goals.quaternion], dim=-1)
        c_chk, _ = slv._ik_cost(g7, res.solution.contiguous(), world)
        torch.cuda.synchronize()
        c_rel = float(((c_chk - res.cost).abs() / (res.cost.abs() + 1e-2)).max())
        if c_rel > 1e-3:
            fail(f"{label}: reported cost differs from ik_cost_grad on the solution by {c_rel}")
        sr = float(ok.float().mean())
        line = dict(
            phase="solve", budget=label, goals=N_GOALS, seeds=N_SEEDS, success_rate=sr,
            median_position_error=float(res.position_error.median()),
            median_rotation_error=float(res.rotation_error.median()),
            ms_per_solve_median=statistics.median(times), ms_per_solve_min=min(times),
            solves=reps + 1, ik_solve_launches=launched, cost_check_rel_max=c_rel,
        )
        solve_lines.append(line)
        emit(line)
        if label == "bench" and sr < 0.95:
            fail(f"bench-budget success rate {sr} is under 0.95")
    launches = dict(ik_solve=ikk.ik_solve.launches, ik_cost_grad=ikk.ik_cost_grad.launches)
    if launches["ik_solve"] != n_solves or launches["ik_cost_grad"] < 1:
        fail(f"main path did not go through the kernels: {launches}")

    # ---- dual-arm IK (two tool frames) on the kernel route, with the LM seed stage ------
    dual, dual_cmp, dual_t = dual_phase(du, out_dir)
    emit(dict(phase="dual_compare", limits=dict(
        cost_rel_median=COST_MED, cost_rel_p99=COST_P99, loop_cost_rel_median=LOOP_COST_MED,
        loop_x_agree_frac=LOOP_X_FRAC, loop_x_tol=LOOP_X_TOL), **dual_cmp))
    emit(dual)

    # ---- main path of motion generation: MotionPlanner.plan_pose over the suite ------
    plan, plan_launches, planner = plan_phase(kin, suite, t_start)
    # kernel time of a first attempt (one ik_solve, two traj_solve, one check)
    # against the plan's wall time: the rest is host work and launch gaps
    kernel_ms = ms_ik32 + 2 * ms_ts + ms_tm
    plan["kernel_ms_per_first_attempt"] = kernel_ms
    plan["device_idle_share_first_attempt"] = 1.0 - kernel_ms / plan["plan_time_median_ms"]
    emit(plan)
    for k in ("ik_solve", "traj_solve", "traj_cost_grad"):
        if plan_launches[k] < 1:
            fail(f"plan phase did not launch {k}: {plan_launches}")
    emit(profile_plans(planner, kin, suite, out_dir))

    # ---- MPC's main path, then the generic route ------------------------------------
    mpc, mpc_launches = mpc_phase(kin, out_dir)
    emit(mpc)
    generic = generic_phase(kin, suite)
    emit(generic)

    # ---- torque-limited motion generation, then voxel-grid worlds ---------------------
    torque = torque_phase(kin, suite, out_dir, t_start)
    emit(torque)
    voxel = voxel_phase(kin, suite)
    emit(voxel)
    perception = perception_phase(kin)
    emit(perception)
    urdf = urdf_phase(kin, suite)
    emit(urdf)

    # ---- the Unitree G1 on the generic route ----------------------------------------
    g1, g1_q = g1_phase(out_dir)
    emit(g1)

    # ---- the pair kernels at their paths' shapes, then the retargeter ---------------
    sc = sc_phase(g1_q, seeds)
    emit(sc)
    rt = retarget_phase()
    emit(rt)

    # ---- the kernels line ------------------------------------------------------------
    io_cg = N * (7 + D) * 4 + N * (1 + D) * 4
    io_solve = N * (7 + D) * 4 + N * (D + 4) * 4
    b_cg, by_cg = bound_ms(N * eval_flops(tab, wt, True, False), io_cg)
    b_sv, by_sv = bound_ms(N * solve_flops(tab, wt, bench_b), io_solve)
    # bytes of one trajectory: goal, knots, start and end in; cost, metrics
    # (and knots or gradient) out
    io_traj = lambda n_out: (7 + tt.nfD + 2 * D + 1 + n_out) * 4
    b_tm, by_tm = bound_ms(traj_eval_flops(tt, wt0, False), io_traj(5))
    b_ts, by_ts = bound_ms(4 * traj_solve_flops(tt, wt0, traj_b), 4 * io_traj(5 + tt.nfD))
    f32 = 32 * solve_flops(tab, wt0, default_b)
    b_ik32 = bound_ms(f32, 32 * ((7 + D) + (D + 4)) * 4)[0]
    blocks = lambda n: -(-n // IK_WARPS)
    lh = tcmp["long_horizon"]
    # the dual-arm shape: N = 3200 configurations, 12 dof, goals of 2 tool frames
    dtab, dwt, dN, dD, dT = du["tab"], du["wt"], du["N"], du["D"], du["T"]
    dual_shape = (f"N={dN} D={dD} T={dT} dual_ur10e table, {dtab.S} spheres, {dtab.P} live pairs")
    f_cg_d = dN * eval_flops(dtab, dwt, True, False)
    f_sv_d = dN * solve_flops(dtab, dwt, dual_t["bench_b"])
    b_cg_d = bound_ms(f_cg_d, dN * (7 * dT + dD) * 4 + dN * (1 + dD) * 4)
    b_sv_d = bound_ms(f_sv_d, dN * (7 * dT + dD) * 4 + dN * (dD + 4) * 4)
    dual_cg_fields = dict(
        shape_dual=dual_shape, ms_dual=dual_t["ms_cg"], plain_ms_dual=dual_t["plain_cg"],
        bound_ms_dual=b_cg_d[0], bound_by_dual=b_cg_d[1], sm_floor_ms_dual=sm_floor_ms(f_cg_d, blocks(dN)),
        launches_dual_phase=dual_t["launches"]["ik_cost_grad"],
        max_abs_err_dual=dual_t["max_abs_err_cg"], rel_err_dual=dual_cmp["ik_cost_grad"][0])
    dual_sv_fields = dict(
        shape_dual=dual_shape + ", bench budget (LM-refined seeds)", ms_dual=dual_t["ms_sv"],
        plain_ms_dual=dual_t["plain_sv"], bound_ms_dual=b_sv_d[0], bound_by_dual=b_sv_d[1],
        sm_floor_ms_dual=sm_floor_ms(f_sv_d, blocks(dN)),
        launches_dual_phase=dual_t["launches"]["ik_solve"], max_abs_err_dual=dual_t["max_abs_err_sv"],
        bench_budget_agreement_dual=dual_t["sv_bench"])
    kernels = [
        dict(name="ik_cost_grad", route="cuda",
             source="curobo_tpu_torch/ops/csrc/ik_kernels.cu",
             replaces="curobo_tpu/ops/pallas_ik.py:849",
             launches=launches["ik_cost_grad"],
             max_abs_err=max(c["max_abs_err"] for c in cg),
             tolerance=f"relative error of cost and of gradient: median < {COST_MED}, "
                       f"99th percentile < {COST_P99}",
             ms=ms_cg, plain_ms=plain_cg, bound_ms=b_cg, bound_by=by_cg, library_ms=None,
             shape=f"N={N} D={D} franka table", rel_err=cg[0],
             also_replaces=["curobo_tpu/ops/pallas_ik.py:865"],
             sm_floor_ms=sm_floor_ms(N * eval_flops(tab, wt, True, False), blocks(N)),
             **dual_cg_fields,
             ptxas=ptxas_of(ptx["ik_kernels"], "ik_cost_grad_kernel")),
        dict(name="ik_solve", route="cuda",
             source="curobo_tpu_torch/ops/csrc/ik_kernels.cu",
             replaces="curobo_tpu/ops/pallas_ik.py:1279",
             launches=launches["ik_solve"],
             # largest |x_kernel - x_plain| (rad) over the strict comparisons; at the
             # full budgets the runs part on line-search ties and are held to
             # their outcome statistics instead (bench_budget_agreement)
             max_abs_err=max(c["max_abs_err_x"] for c in sv),
             tolerance=f"strict cases: |dx| < {LOOP_X_TOL} rad on >= {LOOP_X_FRAC} of the "
                       f"configurations and median relative cost error < {LOOP_COST_MED}; "
                       "full budgets: converged share within 0.02 of the plain version's",
             bench_budget_agreement=full_bench,
             ms=ms_solve, plain_ms=full_bench["plain_ms"], bound_ms=b_sv, bound_by=by_sv,
             library_ms=None, shape=f"N={N} D={D} franka table, bench budget",
             ms_default_budget=ms_solve_default,
             plain_ms_default_budget=full_inj["plain_ms"],
             bound_ms_default_budget=bound_ms(N * solve_flops(tab, wt, default_b), io_solve)[0],
             also_replaces=["curobo_tpu/ops/pallas_ik.py:1144",
                            "curobo_tpu/ops/pallas_ik.py:1191"],
             launches_plan_phase=plan_launches["ik_solve"],
             ms_plan_shape=ms_ik32, plan_shape="N=32 (1 goal x 32 seeds), default budget",
             redesigned="PR 3",
             sm_floor_ms=sm_floor_ms(N * solve_flops(tab, wt, bench_b), blocks(N)),
             sm_floor_ms_default_budget=sm_floor_ms(N * solve_flops(tab, wt, default_b), blocks(N)),
             bound_ms_plan_shape=b_ik32, sm_floor_ms_plan_shape=sm_floor_ms(f32, blocks(32)),
             **dual_sv_fields,
             ptxas=ptxas_of(ptx["ik_kernels"], "ik_solve_kernel")),
        dict(name="traj_cost_grad", route="cuda",
             source="curobo_tpu_torch/ops/csrc/traj_kernels.cu",
             replaces="curobo_tpu/ops/pallas_traj.py:625",
             launches=plan_launches["traj_cost_grad"],
             max_abs_err=max(c["max_abs_err"] for c in tcmp["traj_cost_grad"] + [lh["traj_cost_grad"]]),
             tolerance=f"relative error of cost, gradient, pose errors and retimed dt: median < "
                       f"{COST_MED}, 99th percentile < {COST_P99}; feasibility equal on >= 0.99",
             ms=ms_tm, plain_ms=plain_tm, bound_ms=b_tm, bound_by=by_tm, library_ms=None,
             shape=f"NP=1 trajectory, spline (5, 16, 32), D={D}, metrics mode, problem 0's world",
             ms_grad_mode_n1024=ms_tg1k,
             bound_ms_grad_mode_n1024=bound_ms(N_TRAJ * traj_eval_flops(tt, wt0, True),
                                               N_TRAJ * io_traj(1 + tt.nfD))[0],
             rel_err=tcmp["traj_cost_grad"][0], long_horizon_rel_err=lh["traj_cost_grad"],
             sm_floor_ms=sm_floor_ms(traj_eval_flops(tt, wt0, False), 1),
             ptxas=ptxas_of(ptx["traj_kernels"], "traj_cost_grad_kernel")),
        dict(name="traj_solve", route="cuda",
             source="curobo_tpu_torch/ops/csrc/traj_kernels.cu",
             replaces="curobo_tpu/ops/pallas_traj.py:795",
             launches=plan_launches["traj_solve"],
             # largest |x_kernel - x_plain| (rad) over the strict comparisons
             max_abs_err=max(c["max_abs_err_x"] for c in tcmp["traj_solve"] + [
                 lh["traj_solve"], mpc_cmp, mpc_cmp["shallow_lbfgs4"]]),
             tolerance=f"strict cases: |dx| < {LOOP_X_TOL} rad on >= {LOOP_X_FRAC} of the "
                       f"trajectories and median relative cost error < {LOOP_COST_MED}; "
                       "trajopt budget: converged share within 0.02 of the plain version's",
             trajopt_budget_agreement=full_traj,
             ms=ms_ts, plain_ms=plain_ts, bound_ms=b_ts, bound_by=by_ts, library_ms=None,
             shape=f"NP=4 trajectories, spline (5, 16, 32), D={D}, L-BFGS 56 x line search 5, "
                   "problem 0's world",
             redesigned="PR 3",
             sm_floor_ms=sm_floor_ms(4 * traj_solve_flops(tt, wt0, traj_b), 4),
             ms_np8=ms_ts8,
             bound_ms_np8=bound_ms(8 * traj_solve_flops(tt, wt0, traj_b), 8 * io_traj(5 + tt.nfD))[0],
             sm_floor_ms_np8=sm_floor_ms(8 * traj_solve_flops(tt, wt0, traj_b), 8),
             long_horizon_agreement=lh["traj_solve"],
             launches_mpc_phase=mpc_launches["traj_solve"], mpc_shape=mpc_cmp["shape"],
             ms_mpc_shape=mpc_cmp["ms_np1"], plain_ms_mpc_shape=mpc_cmp["plain_ms_np1"],
             bound_ms_mpc_shape=mpc_cmp["bound_ms_np1"], bound_by_mpc_shape=mpc_cmp["bound_by_np1"],
             sm_floor_ms_mpc_shape=mpc_cmp["sm_floor_ms_np1"],
             mpc_shape_agreement={k: mpc_cmp[k] for k in (
                 "cost_rel_median", "x_agree_frac", "feasible_agree_frac", "max_abs_err_x")},
             mpc_shape_shallow_agreement={k: mpc_cmp["shallow_lbfgs4"][k] for k in (
                 "cost_rel_median", "x_agree_frac", "feasible_agree_frac", "max_abs_err_x")},
             ptxas=ptxas_of(ptx["traj_kernels"], "traj_solve_kernel")),
    ]
    kernels += sc_kernel_lines(sc, g1, generic, rt, ptx["self_collision"], torque, voxel, perception,
                               urdf)
    for line in kernels[:4]:
        line.update(new_path_launches(line["name"], torque, voxel, perception, urdf))
    emit(dict(phase="compare_summary", env={k: env[k] for k in ("torch", "cuda", "python")},
              build_seconds=secs, cases=brief_cases(
                  [cmp, tcmp, mpc_cmp, full_bench, full_inj, full_traj, dual_cmp, sc], []),
              full_output="chiprun_out/chip_smoke.jsonl"))
    emit(dict(quoted_not_measured="kernel ms of the one-thread-per-evaluation design, "
                                  "PERF.md, PR 2 (NVIDIA H100 80GB HBM3, 700 W)",
              pr2_ms=PR2_QUOTED_MS))
    emit(dict(kernels=kernels))
    emit(dict(phase="done", seconds=time.perf_counter() - t_start))
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
