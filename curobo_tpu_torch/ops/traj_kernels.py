"""Fused trajectory kernels: B-spline trajectory cost + gradient, and a whole
trajectory seed-solve, per trajectory.

Counterpart of `curobo_tpu/ops/pallas_traj.py`. Two CUDA kernels written by
hand for `sm_90a` (`ops/csrc/traj_kernels.cu`, over the device functions of
`ops/csrc/ik_device.cuh`) stand in for its two Pallas call sites:

- `traj_cost_grad` replaces `PallasTrajCost._build` -> `kernel` (K4): the
  trajectory objective of the free B-spline knots (per step: pose with the
  terminal / run weight, margin-shrunk joint limits, velocity, acceleration and
  jerk hinges, smoothness, the self-collision hinge and the swept scene term)
  and, by mode, its gradient with respect to the free knots or the metrics of
  `_lane_eval`'s "metrics" mode (terminal pose errors, feasibility, retimed dt).
- `traj_solve` replaces `PallasTrajCost.build_solver` (K5): optional MPPI over
  the knots (optional STOMP smoothing of the noise), L-BFGS over the knots with
  the knot-wise clip, then the metrics, in one launch.

What bounds them on an H100: operations, not bytes. A trajectory reads and
writes a few hundred bytes; one evaluation costs H steps x (FK, 694 pairs, 61
spheres x K sweep samples x obstacles), about 1e7 float operations, and a solve
runs a few hundred evaluations in a serial chain. The TPU kernel lays the
horizon on the lane axis; here one block of 16 warps takes a trajectory and
one warp a step at a time, its lanes splitting the step's pairs, spheres and
links (the evaluation of the IK kernels). Tables and every step's state live
in shared memory (in a global scratch buffer where a long horizon's state or a
very large world does not fit), and the optimizer's vector work runs on one
warp. The motion planner launches 4 or 8 trajectories, so a launch fills 4 or
8 SMs.

Beside each kernel stands its plain PyTorch version (`traj_cost_grad_plain`,
`traj_solve_plain`), taking the same arguments. A wrapper takes the plain
version only for a tensor that lies on the CPU; for a CUDA tensor it launches
the kernel or raises. Each wrapper counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from curobo_tpu_torch.ops import ik_kernels as ikk
from curobo_tpu_torch.robot.params import KinematicsParams
from curobo_tpu_torch.rollout.robot_rollout import RobotRolloutConfig
from curobo_tpu_torch.transition.bspline import N_PIN, BSplineConfig, _basis_matrices

BIG = 1.0e6
MAX_HORIZON = 128  # TRAJ_MAX_H in ops/csrc/traj_kernels.cu
MAX_HISTORY = 32  # most L-BFGS history slots of traj_solve
_LIB_NAME = "traj_kernels"
_MODES = {"cost": 0, "grad": 1, "metrics": 4}


def traj_config_is_supported(cfg: RobotRolloutConfig) -> bool:
    """The kernels hold an isotropic quadratic pose objective and have no
    torque or c-space terms; per-axis pose weights, the metric pose cost, a
    torque limit and the support polygon need another route."""
    pc = cfg.pose_cost
    return (
        pc.position_axis_weight is None
        and pc.rotation_axis_weight is None
        and pc.quadratic
        and cfg.torque_limit_weight == 0.0
        and cfg.support_polygon is None
    )


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrajTables:
    """Device arrays and scalars the kernels read, prepared once per (robot,
    cost config, spline). Layouts are those of `TrajCfg` in
    `ops/csrc/traj_kernels.cu`; the robot is the IK kernels' `IKTables` (its
    cost weights give the pose, self-collision and scene terms)."""

    ik: ikk.IKTables
    basis: torch.Tensor  # (4, H, n_ctrl): B0, B1, B2, B3
    dof_t: torch.Tensor  # (D, 9) cost lo/hi, lim lo/hi, clip lo/hi, v/a/j limits
    weights: Tuple[float, ...]  # bound_w, vel_bw, acc_bw, jerk_bw, smooth_v/a/j, run_w
    H: int
    n_ctrl: int
    n_free: int
    pin_goal: bool
    K: int
    speed_metric: bool

    @property
    def D(self) -> int:
        return self.ik.D

    @property
    def nfD(self) -> int:
        return self.n_free * self.ik.D


def _margin_limits(params: KinematicsParams, margin: float):
    """Margin-shrunk joint limits (terms.bound_cost semantics, finite-guarded
    for unbounded joints), float64."""
    lo = params.joint_limits.lower.detach().cpu().numpy().astype(np.float64)
    hi = params.joint_limits.upper.detach().cpu().numpy().astype(np.float64)
    if margin != 0.0:
        rng = hi - lo
        rng[~np.isfinite(rng)] = 0.0
        lo = lo + margin * rng
        hi = hi - margin * rng
    return lo, hi


def build_traj_tables(
    params: KinematicsParams, cfg: RobotRolloutConfig, bspline: BSplineConfig,
    pin_goal: bool = False, device=None,
) -> TrajTables:
    device = params.device if device is None else torch.device(device)
    H = bspline.horizon
    if H > MAX_HORIZON:
        raise ValueError(f"horizon {H} exceeds the {MAX_HORIZON} steps one block holds")
    if H < 2:
        raise ValueError(f"horizon must be >= 2, got {H}")
    if params.n_tools != 1:
        raise NotImplementedError(
            f"trajectory kernels: {params.n_tools} tool frames; the trajectory goal "
            "is single-tool, as in the JAX package"
        )
    if not traj_config_is_supported(cfg):
        raise NotImplementedError(
            "trajectory kernels: per-axis pose weights, the metric pose cost, a "
            "torque limit and the support-polygon term are not supported"
        )
    n_free = bspline.n_free_cspace if pin_goal else bspline.n_free
    if n_free < 1:
        raise ValueError(f"spline {bspline} leaves no free knots (pin_goal={pin_goal})")
    # the robot tables of the IK kernels; their joint-limit columns are unused
    # here (the margin-shrunk limits live in dof_t), so the margin is not theirs
    ik_cfg = dataclasses.replace(
        cfg, bound_cost=dataclasses.replace(cfg.bound_cost, margin=0.0)
    )
    tab = ikk.build_ik_tables(params, ik_cfg, device)
    B = np.stack(_basis_matrices(bspline.n_control, bspline.degree, H)).astype(np.float32)
    lo_m, hi_m = _margin_limits(params, cfg.bound_cost.margin)
    lim = params.joint_limits
    clip_lo, clip_hi = params.dof_clip_bounds()
    cols = [
        lo_m, hi_m, lim.lower.detach().cpu().numpy(), lim.upper.detach().cpu().numpy(),
        clip_lo, clip_hi, lim.velocity.detach().cpu().numpy(),
        lim.acceleration.detach().cpu().numpy(), lim.jerk.detach().cpu().numpy(),
    ]
    dof_t = np.stack([np.asarray(c, np.float64) for c in cols], axis=1).astype(np.float32)
    bc = cfg.bound_cost
    weights = tuple(
        float(np.float32(v)) for v in (
            bc.weight, bc.velocity_weight, bc.acceleration_weight, bc.jerk_weight,
            cfg.velocity_weight / H, cfg.acceleration_weight / H, cfg.jerk_weight / H,
            cfg.pose_run_weight / max(H - 1, 1),
        )
    )
    cc = cfg.collision_cost
    return TrajTables(
        ik=tab,
        basis=torch.as_tensor(B, device=device),
        dof_t=torch.as_tensor(dof_t, device=device),
        weights=weights, H=H, n_ctrl=bspline.n_control, n_free=n_free,
        pin_goal=bool(pin_goal), K=int(cc.sweep_steps) if cfg.use_swept_collision else 1,
        speed_metric=bool(cc.speed_metric),
    )


@dataclasses.dataclass(frozen=True)
class TrajSolveBudget:
    """Stage budgets of `traj_solve` (defaults of `PallasTrajCost.build_solver`)."""

    mppi_iters: int = 0
    n_particles: int = 16
    init_std: float = 0.1
    std_decay: float = 0.9
    min_std: float = 0.005
    temperature: float = 0.05
    step_size: float = 0.9
    lbfgs_iters: int = 48
    history: int = 10
    max_step: float = 0.4
    n_linesearch: int = 5
    ls_base: float = 1.0
    ls_ratio: float = 0.35


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def _control_points(tt: TrajTables, x, q_start, q_end):
    NP = x.shape[0]
    parts = [q_start[:, None].expand(NP, N_PIN, tt.D), x.reshape(NP, tt.n_free, tt.D)]
    if tt.pin_goal:
        parts.append(q_end[:, None].expand(NP, N_PIN, tt.D))
    return torch.cat(parts, dim=1)


def _traj_eval_plain(tt: TrajTables, world_tabs, goal7, x, q_start, q_end, dt, metrics=False):
    """The trajectory objective of NP trajectories, written out in PyTorch.
    Returns cost (NP,), or (cost, pos_err, rot_err, feasible01, dt_retimed)
    with `metrics`."""
    tab = tt.ik
    NP, D, H = x.shape[0], tt.D, tt.H
    pos_w, rot_w, _, _, sc_w, sc_act, coll_w, coll_act = tab.cfg_host
    bound_w, vel_bw, acc_bw, jerk_bw, sm_v, sm_a, sm_j, run_w = tt.weights
    dt = dt.clamp_min(1e-4)
    ctrl = _control_points(tt, x, q_start, q_end)  # (NP, n_ctrl, D)
    T = dt * (H - 1)
    invT = (1.0 / T.clamp_min(1e-6))[:, None, None]
    B0, B1, B2, B3 = tt.basis
    q = torch.einsum("hc,ncd->nhd", B0, ctrl)
    v = torch.einsum("hc,ncd->nhd", B1, ctrl) * invT
    a = torch.einsum("hc,ncd->nhd", B2, ctrl) * invT * invT
    j = torch.einsum("hc,ncd->nhd", B3, ctrl) * invT * invT * invT

    R, p = ikk._fk_plain(tab, q.reshape(NP * H, D))
    R = R.reshape(NP, H, tab.L, 3, 3)
    p = p.reshape(NP, H, tab.L, 3)

    # pose: every step when the run weight is on, else the terminal step only
    steps = torch.arange(H, device=x.device) if run_w != 0.0 else torch.tensor([H - 1], device=x.device)
    Rt = R[:, steps, tab.tools[0]].reshape(-1, 3, 3)
    tp = p[:, steps, tab.tools[0]].reshape(-1, 3)
    g = goal7[:, None].expand(NP, len(steps), 7).reshape(-1, 7)
    dp = g[:, 0:3] - tp
    pe2 = (dp * dp).sum(dim=-1)
    tq = ikk._rot_to_quat_plain(Rt)
    gw, gx, gy, gz = g[:, 3], g[:, 4], g[:, 5], g[:, 6]
    tw, tx, ty, tz = tq[:, 0], tq[:, 1], tq[:, 2], tq[:, 3]
    rw = gw * tw + gx * tx + gy * ty + gz * tz
    rx = gw * tx - gx * tw - gy * tz + gz * ty
    ry = gw * ty + gx * tz - gy * tw - gz * tx
    rz = gw * tz - gx * ty + gy * tx - gz * tw
    sgn = torch.where(rw < 0, -torch.ones_like(rw), torch.ones_like(rw))
    rw, rx, ry, rz = rw * sgn, rx * sgn, ry * sgn, rz * sgn
    s2 = rx * rx + ry * ry + rz * rz
    small = s2 < 1e-12
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    scale = torch.where(small, torch.full_like(s, 2.0), 2.0 * torch.atan2(s, rw) / s)
    re2 = s2 * scale * scale
    pe2 = pe2.reshape(NP, len(steps))
    re2 = re2.reshape(NP, len(steps))
    wpose = torch.full((len(steps),), run_w, dtype=x.dtype, device=x.device)
    wpose[-1] = 1.0
    cost_h = torch.zeros((NP, H), dtype=x.dtype, device=x.device)
    cost_h = cost_h.index_add(1, steps, (pos_w * pe2 + rot_w * re2) * wpose)

    # joint limits (margin-shrunk), vel/acc/jerk hinges, smoothness
    df = tt.dof_t
    viol = (df[:, 0] - q).clamp_min(0.0) + (q - df[:, 1]).clamp_min(0.0)
    per_dof = bound_w * viol * viol
    if vel_bw > 0:
        per_dof = per_dof + vel_bw * (v.abs() - df[:, 6]).clamp_min(0.0) ** 2
    if acc_bw > 0:
        per_dof = per_dof + acc_bw * (a.abs() - df[:, 7]).clamp_min(0.0) ** 2
    if jerk_bw > 0:
        per_dof = per_dof + jerk_bw * (j.abs() - df[:, 8]).clamp_min(0.0) ** 2
    if sm_v > 0:
        per_dof = per_dof + sm_v * v * v
    if sm_a > 0:
        per_dof = per_dof + sm_a * a * a
    if sm_j > 0:
        per_dof = per_dof + sm_j * j * j
    cost_h = cost_h + per_dof.sum(dim=-1)

    # sphere centres of every step
    sl = tab.sph_link.long()
    centres = (R[:, :, sl] @ tab.sph_f[:, 0:3, None])[..., 0] + p[:, :, sl]  # (NP, H, S, 3)

    # self collision at each step
    self_viol = torch.full((NP, H), -BIG, dtype=x.dtype, device=x.device)
    if tab.P > 0:
        dd = centres[:, :, tab.pair_i[:, 0].long()] - centres[:, :, tab.pair_i[:, 1].long()]
        dist = torch.sqrt((dd * dd).sum(dim=-1) + 1e-12)
        cost_h = cost_h + sc_w * (tab.pair_m + sc_act - dist).clamp_min(0.0).sum(dim=-1)
        if metrics:
            self_viol = (tab.pair_m - dist).amax(dim=-1).clamp_min(-BIG)

    # swept scene term: K samples from step h-1's centres to step h's
    radii = tab.sph_f[:, 3]
    live = torch.nonzero(radii >= 0)[:, 0]
    r_live = radii[live]
    Sc = centres[:, :, live]  # (NP, H, Sl, 3)
    hprev = torch.clamp(torch.arange(H, device=x.device) - 1, min=0)
    Pc = Sc[:, hprev]
    K = tt.K
    pen = torch.zeros(Sc.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(1, K + 1):
        alpha, om = float(np.float32(k / K)), float(np.float32(1.0 - k / K))
        msdf = ikk._scene_msdf_plain(world_tabs, Pc * om + Sc * alpha)
        pen = pen + (coll_act + r_live - msdf).clamp_min(0.0)
    pen = pen / K
    if tt.speed_metric:
        spd = torch.sqrt(((Sc - Pc) ** 2).sum(dim=-1) + 1e-12) + 1e-3
    else:
        spd = torch.ones_like(pen)
    cost_h = cost_h + coll_w * (pen * spd).sum(dim=-1)
    cost = cost_h.sum(dim=-1)
    if not metrics:
        return cost

    min_clear = (msdf - r_live).amin(dim=-1).clamp_max(BIG)  # endpoint samples (k = K)
    oob = torch.any((q < df[:, 2] - 1e-4) | (q > df[:, 3] + 1e-4), dim=-1)
    bad = (min_clear < 0.0) | (self_viol > 0.0) | oob
    feasible = (~bad.any(dim=-1)).to(x.dtype)
    pos_err = torch.sqrt(pe2[:, -1].clamp_min(1e-16))
    rot_err = torch.sqrt(re2[:, -1].clamp_min(1e-16))
    rv = (v.abs() / df[:, 6]).amax(dim=(-1, -2))
    ra = (a.abs() / df[:, 7]).amax(dim=(-1, -2))
    rj = (j.abs() / df[:, 8]).amax(dim=(-1, -2))
    scale_t = torch.maximum(rv, torch.maximum(torch.sqrt(ra), rj.pow(1.0 / 3.0)))
    dt_ret = dt * scale_t * 1.01
    return cost, pos_err, rot_err, feasible, dt_ret


def traj_cost_grad_plain(tt: TrajTables, world_tabs, goal7, x, q_start, q_end, dt, mode="grad"):
    """Plain PyTorch version of `traj_cost_grad`: mode "grad" -> (cost, grad
    (NP, n_free * D)) with the gradient by autograd; "cost" -> (cost, None);
    "metrics" -> (cost, pos_err, rot_err, feasible01, dt_retimed)."""
    if mode == "metrics":
        with torch.no_grad():
            return _traj_eval_plain(tt, world_tabs, goal7, x, q_start, q_end, dt, metrics=True)
    if mode == "cost":
        with torch.no_grad():
            return _traj_eval_plain(tt, world_tabs, goal7, x, q_start, q_end, dt), None
    with torch.enable_grad():
        xx = x.detach().clone().requires_grad_(True)
        c = _traj_eval_plain(tt, world_tabs, goal7, xx, q_start, q_end, dt)
        (g,) = torch.autograd.grad(c.sum(), xx)
    return c.detach(), g


def _clip_knots_plain(tt: TrajTables, x):
    """Knot row r is clipped to the clip window of dof r % D."""
    lo = tt.dof_t[:, 4].repeat(tt.n_free)
    hi = tt.dof_t[:, 5].repeat(tt.n_free)
    return torch.minimum(torch.maximum(x, lo), hi)


def _smooth_noise(noise, eps_smooth, n_free: int, D: int):
    """eps'[k D + d] = sum_j L[k, j] eps[j D + d], weights under 1e-8 dropped."""
    L = torch.where(eps_smooth.abs() < 1e-8, torch.zeros_like(eps_smooth), eps_smooth)
    shp = noise.shape
    z = noise.reshape(shp[:-1] + (n_free, D))
    return torch.einsum("kj,...jd->...kd", L, z).reshape(shp)


def traj_solve_plain(
    tt: TrajTables, world_tabs, goal7, x0, q_start, q_end, dt, budget: TrajSolveBudget,
    seed: int = 0, noise: Optional[torch.Tensor] = None, eps_smooth: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of `traj_solve`: the same stages on the same
    arguments -> (x (NP, n_free * D), cost, pos_err, rot_err, feasible01,
    dt_retimed (NP,))."""
    b = budget
    NP = x0.shape[0]
    clip = lambda xx: _clip_knots_plain(tt, xx)

    def cost_fn(xx):
        return traj_cost_grad_plain(tt, world_tabs, goal7, xx, q_start, q_end, dt, "cost")[0]

    def cost_grad_fn(xx):
        return traj_cost_grad_plain(tt, world_tabs, goal7, xx, q_start, q_end, dt, "grad")

    x = x0
    if b.mppi_iters > 0:
        if noise is None:
            noise = ikk.philox_normal_plain(seed, NP, b.mppi_iters, b.n_particles, tt.nfD, x0.device)
        if eps_smooth is not None:
            noise = _smooth_noise(noise, eps_smooth, tt.n_free, tt.D)
        x, _ = ikk._mppi_plain(
            cost_fn, clip, x, noise, b.mppi_iters, b.n_particles, b.init_std,
            b.std_decay, b.min_std, b.temperature, b.step_size,
        )
    best_x, _ = ikk._lbfgs_plain(
        cost_fn, cost_grad_fn, clip, x, b.lbfgs_iters, b.history, b.max_step,
        b.n_linesearch, b.ls_base, b.ls_ratio,
    )
    out = traj_cost_grad_plain(tt, world_tabs, goal7, best_x, q_start, q_end, dt, "metrics")
    return (best_x,) + tuple(out)


# ---------------------------------------------------------------------------
# CUDA side: ctypes mirrors of the C structures, library, wrappers
# ---------------------------------------------------------------------------
class _CTrajCfg(ctypes.Structure):
    _fields_ = [
        ("basis", ctypes.c_void_p), ("dof_t", ctypes.c_void_p),
        ("bound_w", ctypes.c_float), ("vel_bw", ctypes.c_float),
        ("acc_bw", ctypes.c_float), ("jerk_bw", ctypes.c_float),
        ("smooth_v", ctypes.c_float), ("smooth_a", ctypes.c_float),
        ("smooth_j", ctypes.c_float), ("run_w", ctypes.c_float),
        ("H", ctypes.c_int), ("n_ctrl", ctypes.c_int), ("n_free", ctypes.c_int),
        ("K", ctypes.c_int), ("speed_metric", ctypes.c_int),
    ]


class _CTrajSolveCfg(ctypes.Structure):
    _fields_ = [
        ("mppi_iters", ctypes.c_int), ("n_particles", ctypes.c_int),
        ("init_std", ctypes.c_float), ("std_decay", ctypes.c_float),
        ("min_std", ctypes.c_float), ("temperature", ctypes.c_float),
        ("step_size", ctypes.c_float),
        ("lbfgs_iters", ctypes.c_int), ("history", ctypes.c_int),
        ("max_step", ctypes.c_float), ("n_linesearch", ctypes.c_int),
        ("ls_base", ctypes.c_float), ("ls_ratio", ctypes.c_float),
        ("seed_lo", ctypes.c_uint), ("seed_hi", ctypes.c_uint),
    ]


_lib_ready = None


def _lib():
    """The built library with argument types set (first use builds it)."""
    global _lib_ready
    if _lib_ready is None:
        from curobo_tpu_torch.ops.build import load_library

        lib = load_library(_LIB_NAME)
        vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.traj_max_horizon.argtypes = []
        lib.traj_max_horizon.restype = ci
        cll = ctypes.c_longlong
        lib.traj_cost_grad_scratch_words.argtypes = [vp, vp, vp, ci]
        lib.traj_cost_grad_scratch_words.restype = cll
        lib.traj_solve_scratch_words.argtypes = [vp, vp, vp, ci, ci]
        lib.traj_solve_scratch_words.restype = cll
        lib.traj_cost_grad_launch.argtypes = [vp] * 15 + [ci, ci, vp]
        lib.traj_cost_grad_launch.restype = ci
        lib.traj_solve_launch.argtypes = [vp] * 18 + [ci, vp]
        lib.traj_solve_launch.restype = ci
        lib.traj_philox_normal_launch.argtypes = [cu, cu, ci, ci, ci, ci, vp, vp]
        lib.traj_philox_normal_launch.restype = ci
        _lib_ready = lib
    return _lib_ready


def _check_inputs(tt: TrajTables, world_tabs, goal7, x, q_start, q_end, dt):
    NP = x.shape[0] if x.ndim == 2 else -1
    if x.ndim != 2 or x.shape[1] != tt.nfD:
        raise ValueError(f"x must have shape (NP, {tt.nfD}), got {tuple(x.shape)}")
    if goal7.shape != (NP, 7):
        raise ValueError(f"goal7 must have shape ({NP}, 7), got {tuple(goal7.shape)}")
    if q_start.shape != (NP, tt.D):
        raise ValueError(f"q_start must have shape ({NP}, {tt.D}), got {tuple(q_start.shape)}")
    if tt.pin_goal and q_end is None:
        # silently pinning the far end to q_start would "solve" every problem
        # with a trajectory that returns home
        raise ValueError(
            "pin_goal=True requires q_end (the goal configuration to pin the "
            "spline's terminal state to); got q_end=None"
        )
    if q_end is not None and q_end.shape != (NP, tt.D):
        raise ValueError(f"q_end must have shape ({NP}, {tt.D}), got {tuple(q_end.shape)}")
    if dt.shape != (NP,):
        raise ValueError(f"dt must have shape ({NP},), got {tuple(dt.shape)}")
    ikk._check_inputs(tt.ik, world_tabs, goal7, q_start)
    for name, t in (("x", x), ("q_end", q_end), ("dt", dt), ("spline tables", tt.basis)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")


def _cuda_guard(tt: TrajTables):
    lib = _lib()
    ikk._cuda_guard(tt.ik, ikk._lib())
    if tt.H > lib.traj_max_horizon():
        raise ValueError(f"horizon {tt.H} exceeds {lib.traj_max_horizon()}")
    return lib


def _c_traj(tt: TrajTables) -> _CTrajCfg:
    return _CTrajCfg(
        tt.basis.data_ptr(), tt.dof_t.data_ptr(), *tt.weights,
        tt.H, tt.n_ctrl, tt.n_free, tt.K, int(tt.speed_metric),
    )


def _contig(*ts):
    return tuple(None if t is None else t.contiguous() for t in ts)


def traj_cost_grad(tt: TrajTables, world_tabs, goal7, x, q_start, q_end, dt, mode="grad"):
    """goal7 (NP, 7), free knots x (NP, n_free * D), q_start (NP, D), q_end
    (NP, D) or None, dt (NP,) -> by mode: "grad" (cost, grad), "cost" (cost,
    None), "metrics" (cost, pos_err, rot_err, feasible01, dt_retimed). CUDA
    tensors go through the `traj_cost_grad` kernel, CPU tensors through
    `traj_cost_grad_plain`."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    _check_inputs(tt, world_tabs, goal7, x, q_start, q_end, dt)
    if x.device.type == "cpu":
        return traj_cost_grad_plain(tt, world_tabs, goal7, x, q_start, q_end, dt, mode)
    lib = _cuda_guard(tt)
    NP, dev = x.shape[0], x.device
    if q_end is None:
        q_end = q_start
    goal7, x, q_start, q_end, dt = _contig(goal7, x, q_start, q_end, dt)
    world_tabs = _contig(*world_tabs)
    outs = [torch.empty((NP,), dtype=torch.float32, device=dev) for _ in range(5)]
    grad = torch.empty((NP, tt.nfD), dtype=torch.float32, device=dev) if mode == "grad" else None
    with torch.cuda.device(dev):
        rb, w, tc = ikk._c_robot(tt.ik), ikk._c_world(world_tabs), _c_traj(tt)
        rbp, wp, tcp = ctypes.addressof(rb), ctypes.addressof(w), ctypes.addressof(tc)
        scratch = ikk._scratch(lib.traj_cost_grad_scratch_words(rbp, wp, tcp, NP), dev)
        err = lib.traj_cost_grad_launch(
            rbp, wp, tcp,
            goal7.data_ptr(), x.data_ptr(), q_start.data_ptr(), q_end.data_ptr(), dt.data_ptr(),
            outs[0].data_ptr(), None if grad is None else grad.data_ptr(),
            *(o.data_ptr() for o in outs[1:]), None if scratch is None else scratch.data_ptr(),
            NP, _MODES[mode], torch.cuda.current_stream().cuda_stream,
        )
    traj_cost_grad.launches += 1
    if err != 0:
        raise RuntimeError(f"traj_cost_grad kernel launch failed: CUDA error {err}")
    if mode == "metrics":
        return tuple(outs)
    return outs[0], grad


traj_cost_grad.launches = 0


def _check_budget(b: TrajSolveBudget):
    if not 1 <= b.history <= MAX_HISTORY:
        raise ValueError(f"L-BFGS history must be in [1, {MAX_HISTORY}], got {b.history}")
    if min(b.mppi_iters, b.lbfgs_iters, b.n_linesearch) < 0:
        raise ValueError("stage budgets must be >= 0")
    if b.mppi_iters > 0 and b.n_particles < 1:
        raise ValueError("n_particles must be >= 1 when the MPPI stage runs")
    if not 0.0 < b.ls_ratio:
        raise ValueError("ls_ratio must be > 0")


def traj_solve(
    tt: TrajTables, world_tabs, goal7, x0, q_start, q_end, dt, budget: TrajSolveBudget,
    seed: int = 0, noise: Optional[torch.Tensor] = None, eps_smooth: Optional[torch.Tensor] = None,
):
    """A whole seed-solve per trajectory -> (x (NP, n_free * D), cost, pos_err,
    rot_err, feasible01, dt_retimed (NP,)); the caller clips dt_retimed.

    `noise`, when given, is (mppi_iters, n_particles, NP, n_free * D) standard
    normals used by the MPPI stage instead of the generator keyed by `seed`;
    `eps_smooth`, when given, is the (n_free, n_free) knot-smoothing matrix
    applied to every draw. CUDA tensors go through the `traj_solve` kernel,
    CPU tensors through `traj_solve_plain`."""
    _check_inputs(tt, world_tabs, goal7, x0, q_start, q_end, dt)
    _check_budget(budget)
    b = budget
    NP, dev = x0.shape[0], x0.device
    if noise is not None:
        want = (b.mppi_iters, b.n_particles, NP, tt.nfD)
        if tuple(noise.shape) != want or noise.dtype != torch.float32 or noise.device != dev:
            raise ValueError(
                f"noise must be float32 {want} on {dev}, got "
                f"{noise.dtype} {tuple(noise.shape)} on {noise.device}"
            )
    if eps_smooth is not None:
        want = (tt.n_free, tt.n_free)
        if tuple(eps_smooth.shape) != want or eps_smooth.dtype != torch.float32 or eps_smooth.device != dev:
            raise ValueError(
                f"eps_smooth must be float32 {want} on {dev}, got "
                f"{eps_smooth.dtype} {tuple(eps_smooth.shape)} on {eps_smooth.device}"
            )
    if dev.type == "cpu":
        return traj_solve_plain(tt, world_tabs, goal7, x0, q_start, q_end, dt, b, seed, noise, eps_smooth)
    lib = _cuda_guard(tt)
    if q_end is None:
        q_end = q_start
    goal7, x0, q_start, q_end, dt, noise, eps_smooth = _contig(
        goal7, x0, q_start, q_end, dt, noise, eps_smooth
    )
    world_tabs = _contig(*world_tabs)
    x = torch.empty((NP, tt.nfD), dtype=torch.float32, device=dev)
    outs = [torch.empty((NP,), dtype=torch.float32, device=dev) for _ in range(5)]
    s_lo, s_hi = ikk._seed_words(seed)
    cfg = _CTrajSolveCfg(
        b.mppi_iters, b.n_particles, b.init_std, b.std_decay, b.min_std, b.temperature,
        b.step_size, b.lbfgs_iters, b.history, b.max_step, b.n_linesearch, b.ls_base,
        b.ls_ratio, s_lo, s_hi,
    )
    with torch.cuda.device(dev):
        rb, w, tc = ikk._c_robot(tt.ik), ikk._c_world(world_tabs), _c_traj(tt)
        rbp, wp, tcp = ctypes.addressof(rb), ctypes.addressof(w), ctypes.addressof(tc)
        scratch = ikk._scratch(lib.traj_solve_scratch_words(rbp, wp, tcp, b.history, NP), dev)
        err = lib.traj_solve_launch(
            rbp, wp, tcp, ctypes.addressof(cfg),
            goal7.data_ptr(), x0.data_ptr(), q_start.data_ptr(), q_end.data_ptr(), dt.data_ptr(),
            None if noise is None else noise.data_ptr(),
            None if eps_smooth is None else eps_smooth.data_ptr(),
            x.data_ptr(), *(o.data_ptr() for o in outs),
            None if scratch is None else scratch.data_ptr(), NP,
            torch.cuda.current_stream().cuda_stream,
        )
    traj_solve.launches += 1
    if err != 0:
        raise RuntimeError(f"traj_solve kernel launch failed: CUDA error {err}")
    return (x, *outs)


traj_solve.launches = 0


def traj_philox_normal(seed: int, N: int, iters: int, particles: int, n: int, device):
    """The standard normals `traj_solve` draws for its MPPI stage when it is
    given no noise, (iters, particles, N, n): a debug entry of the kernel
    library on a CUDA device, `ik_kernels.philox_normal_plain` on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return ikk.philox_normal_plain(seed, N, iters, particles, n, device)
    lib = _lib()
    out = torch.empty((iters, particles, N, n), dtype=torch.float32, device=device)
    s_lo, s_hi = ikk._seed_words(seed)
    with torch.cuda.device(device):
        err = lib.traj_philox_normal_launch(
            s_lo, s_hi, N, iters, particles, n, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    traj_philox_normal.launches += 1
    if err != 0:
        raise RuntimeError(f"traj_philox_normal kernel launch failed: CUDA error {err}")
    return out


traj_philox_normal.launches = 0


# ---------------------------------------------------------------------------
# Object API (counterpart of PallasTrajCost)
# ---------------------------------------------------------------------------
class TrajCost:
    """Build once per (robot, cost config, spline); call per solve with any
    world (obstacle capacities are launch arguments, nothing is rebuilt per
    world).

    __call__(goal7 (NP, 7), free (NP, n_free * D), q_start (NP, D), dt (NP,),
             world, q_end=None) -> (cost (NP,), grad (NP, n_free * D))
    """

    def __init__(self, params: KinematicsParams, cfg: RobotRolloutConfig,
                 bspline: BSplineConfig, pin_goal: bool = False, device=None):
        self.params = params
        self.cfg = cfg
        self.bspline = bspline
        self.pin_goal = pin_goal
        self.tables = build_traj_tables(params, cfg, bspline, pin_goal, device)

    def _world_tabs(self, world):
        if not ikk.world_is_supported(world):
            raise NotImplementedError("trajectory kernels: voxel-grid worlds are not supported")
        return ikk.pack_world_arrays(world)

    def __call__(self, goal7, free, q_start, dt, world, q_end=None):
        return traj_cost_grad(self.tables, self._world_tabs(world), goal7, free, q_start, q_end, dt, "grad")

    def metrics(self, goal7, free, q_start, dt, world, q_end=None):
        """(cost, pos_err, rot_err, feasible01, dt_retimed): one launch."""
        return traj_cost_grad(self.tables, self._world_tabs(world), goal7, free, q_start, q_end, dt, "metrics")

    def build_solver(self, eps_smooth: Optional[torch.Tensor] = None, **budget):
        """solve(goal7, free, q_start, dt, seed, world, q_end=None, noise=None)
        -> (free, cost, pos_err, rot_err, feasible01, dt_retimed): one launch."""
        b = TrajSolveBudget(**budget)
        _check_budget(b)

        def solve(goal7, free, q_start, dt, seed, world, q_end=None, noise=None):
            return traj_solve(self.tables, self._world_tabs(world), goal7, free, q_start, q_end,
                              dt, b, seed, noise, eps_smooth)

        return solve
