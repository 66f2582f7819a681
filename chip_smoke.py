#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (needs one CUDA device)
    python3 chip_smoke.py --quick    # build + kernel comparisons only

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card at the shapes of the main path
(Franka, 100 goals x 32 seeds = 3200 configurations), then drives the main
path through the public entry points (`Kinematics.from_robot_yaml` ->
`compile_scene` -> `IKSolver.solve_pose`) and checks the results. Every line
of output is one JSON object, except the line with the card's name and power
limit. Exits non-zero on the first failed phase, and when there is no CUDA
device.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; a CUDA device is required\n")
    sys.exit(2)

import curobo_tpu_torch as ct
from curobo_tpu_torch.geom import types as gt
from curobo_tpu_torch.ops import build as kbuild
from curobo_tpu_torch.ops import ik_kernels as ikk
from curobo_tpu_torch.opt.lbfgs import LBFGSConfig, LineSearchConfig
from curobo_tpu_torch.opt.mppi import MPPIConfig

DEV = torch.device("cuda", 0)
N_GOALS, N_SEEDS = 100, 32

# Published peaks of one H100 SXM: float32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67.0e12
PEAK_BYTES = 3.35e12

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


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def time_ms(fn, reps, warm=1):
    """Median milliseconds of `fn` by CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


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
    pose = 120
    bounds = 8 * tab.D
    f = fk + pose + bounds
    if grad:
        f += tab.L * 30 + 40  # reverse sweep + tool force/torque
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
    if strict:
        if not (res["cost_rel_median"] < LOOP_COST_MED and res["x_agree_frac"] >= LOOP_X_FRAC):
            fail(f"ik_solve[{label}] disagrees with its plain version: {res}")
    elif abs(res["conv_frac_kernel"] - res["conv_frac_plain"]) > 0.02:
        fail(f"ik_solve[{label}] converges on another share than its plain version: {res}")
    return res, out_k


def main():
    quick = "--quick" in sys.argv[1:]
    t_start = time.perf_counter()
    torch.cuda.set_device(DEV)
    gpu = gpu_line()
    emit(dict(phase="env", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
              python=sys.version.split()[0]))

    # ---- build ------------------------------------------------------------
    secs = kbuild.build_all()
    ptxas = [l.strip() for l in kbuild.build_log("ik_kernels").splitlines()
             if "registers" in l or "spill" in l or "Compiling entry" in l or "warning" in l.lower()]
    emit(dict(phase="build", seconds=secs, libraries=[kbuild.library_path(n) for n in secs],
              ptxas=ptxas[:40]))

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
    emit(dict(phase="compare_full", bench=full_bench, default_injected=full_inj,
              success_injected_noise=sr_inj, success_philox_noise=sr_phx))

    # ---- kernel timings at the main path's shapes -----------------------------------
    ms_cg = time_ms(lambda: ikk.ik_cost_grad(tab, wt, goal7, seeds, True), reps=20, warm=2)
    plain_cg = time_ms(lambda: ikk.ik_cost_grad_plain(tab, wt, goal7, seeds, True), reps=5)
    ms_solve = time_ms(lambda: ikk.ik_solve(tab, wt, goal7, seeds, bench_b, 0, None), reps=10)
    ms_solve_default = time_ms(lambda: ikk.ik_solve(tab, wt, goal7, seeds, default_b, 0, None), reps=5)

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

    # ---- the kernels line ------------------------------------------------------------
    io_cg = N * (7 + D) * 4 + N * (1 + D) * 4
    io_solve = N * (7 + D) * 4 + N * (D + 4) * 4
    b_cg, by_cg = bound_ms(N * eval_flops(tab, wt, True, False), io_cg)
    b_sv, by_sv = bound_ms(N * solve_flops(tab, wt, bench_b), io_solve)
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
             also_replaces=["curobo_tpu/ops/pallas_ik.py:865"]),
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
                            "curobo_tpu/ops/pallas_ik.py:1191"]),
    ]
    emit(dict(kernels=kernels))
    emit(dict(phase="done", seconds=time.perf_counter() - t_start))
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
