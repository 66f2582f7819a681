"""Fused IK kernels: cost + gradient, and a whole solve, per configuration.

Counterpart of `curobo_tpu/ops/pallas_ik.py`. Two CUDA kernels written by hand
for `sm_90a` (`ops/csrc/ik_kernels.cu` over `ops/csrc/ik_device.cuh`) stand in
for the five Pallas call sites of that module:

- `ik_cost_grad` replaces `PallasIKCost._build` -> `kernel_grad` / `kernel_fwd`:
  the IK objective (FK, pose error, joint-limit and null-space penalties,
  self-collision hinge, scene penalty) and its gradient, per configuration.
- `ik_solve` replaces `PallasIKCost.build_solver`, `build_mppi_solver` and
  `build_lbfgs_solver`: pose-only L-BFGS warm-up -> optional MPPI -> full-cost
  L-BFGS -> metrics in one launch; with the other stages' budgets at 0 it is
  the MPPI-only or the L-BFGS-only solver.

What bounds them on an H100: operations, not bytes. A configuration reads and
writes a few hundred bytes and costs about 1e4 float operations per objective
evaluation, and a solve evaluates it hundreds of times in a serial chain. The
design gives one warp to each configuration (4 warps per block): the block
copies the robot and world tables into shared memory once (a world too large
for it is compacted into a global buffer once per launch and read there),
each warp keeps its evaluation state and its L-BFGS history there, lane d holds
dof d of every optimizer vector, and an evaluation's spheres, pairs and links
are split over the 32 lanes. Robot and world stay runtime tables (nothing is
compiled per robot or per world: a world update is a tensor update). The host
builds the lists the lanes walk in a fixed order (`IKTables.sph_pair_*`,
`link_sph*`), so there are no atomics and a launch gives the same bits every
time.

Both serve 1 to `IK_MAXT` tool frames: the goal of a configuration is
(7 T,), each tool's position and quaternion in turn; the pose cost is summed
over the tools and the metrics take the largest error over them, as in the
TPU kernel.

Beside each kernel stands its plain PyTorch version (`ik_cost_grad_plain`,
`ik_solve_plain`), taking the same arguments. A wrapper takes the plain
version only for a tensor that lies on the CPU; for a CUDA tensor it launches
the kernel or raises. Each wrapper counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from curobo_tpu_torch.geom import world as world_mod
from curobo_tpu_torch.robot.params import (
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    KinematicsParams,
)
from curobo_tpu_torch.rollout.robot_rollout import RobotRolloutConfig

BIG = 1.0e6
_LIB_NAME = "ik_kernels"
# Most tool frames a goal may have: IK_MAXT of ops/csrc/ik_device.cuh, which
# sizes the `tool` array of `_CRobot` and the warp's goal slot (7 words per
# tool); tests/test_torch_multitool.py holds the two equal.
IK_MAXT = 4
# Most degrees of freedom: IK_MAXD of ops/csrc/ik_device.cuh (lane d of a warp
# owns dof d); chip_smoke.py holds it equal to the library's `ik_max_dof()`.
IK_MAXD = 16
# Shared memory a block may opt in to on sm_90 (227 KB; chip_smoke.py holds it
# equal to the card's `shared_memory_per_block_optin`), and the kernels' warps
# per block and goal-slot words (IK_WARPS of ops/csrc/ik_kernels.cu,
# IK_GOAL_WORDS and IK_TERR_WORDS of ops/csrc/ik_device.cuh).
IK_SMEM_BYTES = 232448
_IK_WARPS = 4
_IK_GOAL_WORDS = (7 * IK_MAXT + 3) & ~3
_IK_TERR_WORDS = 6 * IK_MAXT


# ---------------------------------------------------------------------------
# World tables
# ---------------------------------------------------------------------------
def world_is_supported(world: world_mod.WorldData) -> bool:
    return len(world.voxel_grids) == 0


def world_capacities(world: world_mod.WorldData) -> tuple:
    """Rows of the four obstacle tables (launch arguments of the kernels)."""
    return (
        max(world.cuboids.pos.shape[0], 1),
        max(world.spheres.center.shape[0], 1),
        max(world.capsules.pos.shape[0], 1),
        max(world.cylinders.pos.shape[0], 1),
    )


def pack_world_arrays(world: world_mod.WorldData):
    """WorldData -> four f32 tables on the world's device:

    cub (Kc, 16): rot row-major 9 | pos 3 | half 3 | enabled
    sph (Ks, 5):  center 3 | radius | enabled
    cap (Kp, 8):  world endpoint a 3 | ba 3 | radius | enabled
    cyl (Ky, 15): rot row-major 9 | pos 3 | radius | half_height | enabled

    An empty table is one all-zero (disabled) row.
    """
    dev = world.device

    def padded(arr, width):
        if arr.shape[0] == 0:
            return torch.zeros((1, width), dtype=torch.float32, device=dev)
        return arr.to(torch.float32).contiguous()

    c = world.cuboids
    cub = padded(
        torch.cat([c.rot.reshape(-1, 9), c.pos, c.half_dims, c.enabled[:, None]], dim=-1),
        16,
    )
    s = world.spheres
    sph = padded(torch.cat([s.center, s.radius[:, None], s.enabled[:, None]], dim=-1), 5)
    p = world.capsules
    if p.pos.shape[0] == 0:
        cap = torch.zeros((1, 8), dtype=torch.float32, device=dev)
    else:
        a = (p.rot @ p.base[..., None])[..., 0] + p.pos
        ba = (p.rot @ (p.tip - p.base)[..., None])[..., 0]
        cap = torch.cat([a, ba, p.radius[:, None], p.enabled[:, None]], dim=-1).to(
            torch.float32
        ).contiguous()
    y = world.cylinders
    cyl = padded(
        torch.cat(
            [
                y.rot.reshape(-1, 9), y.pos, y.radius[:, None],
                y.half_height[:, None], y.enabled[:, None],
            ],
            dim=-1,
        ),
        15,
    )
    return cub, sph, cap, cyl


def rollout_config_is_supported(cfg: RobotRolloutConfig) -> bool:
    """The kernels hold an isotropic quadratic pose objective and raw joint
    limits; per-axis pose weights, the metric (sqrt) pose cost, a bound margin
    or the support-polygon term need another route."""
    pc = cfg.pose_cost
    return (
        pc.position_axis_weight is None
        and pc.rotation_axis_weight is None
        and pc.quadratic
        and cfg.bound_cost.margin == 0.0
        and cfg.support_polygon is None
    )


def goal_takes_kernel(goal) -> bool:
    """The goals every kernel route serves: one goal per tool, no per-tool
    weights or tolerances, no c-space goal. Goal sets, tool criteria and
    c-space goals take the generic route. Reads no tensor."""
    return (
        goal.goal_pos.shape[-3] == 1
        and goal.tool_weight is None
        and goal.tool_tolerance is None
        and goal.goal_cspace is None
    )


def robot_takes_kernel(params: KinematicsParams, history: int = 0) -> bool:
    """Whether the IK kernels take this robot, from its shapes alone (no built
    library, no launch): 1 to IK_MAXT tool frames, at most IK_MAXD dof, a live
    collision sphere, and the robot tables (the per-sphere pair lists
    included) fit a block's shared memory beside IK_WARPS warps' evaluation
    state, goal slot and an L-BFGS history of `history` pairs. The arithmetic
    is the launch's (`ik_robot_words`, `ik_warp_words`, `ik_hist_words` in
    ops/csrc/); the world is left out, as a world that does not fit goes to
    global memory."""
    if not (1 <= params.n_tools <= IK_MAXT and params.n_dof <= IK_MAXD):
        return False
    L, S, D = params.n_links, params.n_spheres, params.n_dof
    P = int(torch.isfinite(params.self_collision.pair_margin).sum())
    n_lsph = int((params.sphere_radii >= 0).sum())
    if n_lsph == 0:
        return False
    robot = 20 * L + 4 * S + S + (S + 1) + 4 * P + (L + 1) + n_lsph + 6 * D + 8
    state = 18 * L + 6 * S + 2 * IK_MAXD
    hist = 2 * history * D + 3 * history
    warp = state + _IK_GOAL_WORDS + _IK_TERR_WORDS + hist
    return 4 * (robot + _IK_WARPS * warp) <= IK_SMEM_BYTES


# ---------------------------------------------------------------------------
# Robot tables
# ---------------------------------------------------------------------------
def _fold_links(params: KinematicsParams):
    """Per link (kind, parent, dof) and (mult, off, R(9), p(3), axis(3)), with
    locked, unactuated and zero-multiplier joints folded into a constant local
    transform fixed @ joint(off)."""
    L = params.n_links
    fixed_rot = params.fixed_rot.detach().cpu().numpy().astype(np.float64)
    fixed_pos = params.fixed_pos.detach().cpu().numpy().astype(np.float64)
    axes = params.joint_axis.detach().cpu().numpy().astype(np.float64)
    mult = params.mimic_mult.detach().cpu().numpy().astype(np.float64)
    off = params.mimic_offset.detach().cpu().numpy().astype(np.float64)
    link_i = np.zeros((L, 3), np.int32)
    link_f = np.zeros((L, 17), np.float64)
    for i in range(L):
        jt = params.joint_type[i]
        d = params.dof_idx[i]
        live = jt != 0 and d >= 0 and mult[i] != 0.0
        R = fixed_rot[i].copy()
        p = fixed_pos[i].copy()
        if not live:
            if jt == JOINT_REVOLUTE and off[i] != 0.0:
                a, ang = axes[i], off[i]
                c, s = np.cos(ang), np.sin(ang)
                K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
                R = R @ (np.eye(3) * c + s * K + (1 - c) * np.outer(a, a))
            elif jt == JOINT_PRISMATIC and off[i] != 0.0:
                p = p + R @ (axes[i] * off[i])
            link_i[i] = (0, params.parent_idx[i], -1)
            link_f[i, 0:2] = (0.0, 0.0)
        else:
            kind = 1 if jt == JOINT_REVOLUTE else 2
            link_i[i] = (kind, params.parent_idx[i], d)
            link_f[i, 0:2] = (mult[i], off[i])
            link_f[i, 14:17] = axes[i]
        link_f[i, 2:11] = R.reshape(9)
        link_f[i, 11:14] = p
    return link_i, link_f.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class IKTables:
    """Device arrays the kernels read, prepared once per (robot, cost config).
    Layouts are those of `IKRobot` in `ops/csrc/ik_device.cuh`."""

    link_i: torch.Tensor  # (L, 3) int32
    link_f: torch.Tensor  # (L, 17)
    sph_f: torch.Tensor  # (S, 4)
    sph_link: torch.Tensor  # (S,) int32
    pair_i: torch.Tensor  # (P, 2) int32, live pairs only
    pair_m: torch.Tensor  # (P,)
    sph_pair_off: torch.Tensor  # (S + 1,) int32: sphere s's pairs, both directions
    sph_pair_j: torch.Tensor  # (2 P,) int32 partner sphere, in pair order
    sph_pair_m: torch.Tensor  # (2 P,) margin
    link_sph_off: torch.Tensor  # (L + 1,) int32: link l's live spheres
    link_sph: torch.Tensor  # (live spheres,) int32, ascending within a link
    dof_f: torch.Tensor  # (D, 6)
    cfg_f: torch.Tensor  # (8,)
    tools: Tuple[int, ...]  # link index of each tool frame, in goal order
    # host copies of the small integer/weight tables, read by the plain
    # versions without a device round-trip
    link_host: Tuple[Tuple[int, int, int], ...] = ()
    cfg_host: Tuple[float, ...] = ()

    @property
    def L(self) -> int:
        return self.link_i.shape[0]

    @property
    def S(self) -> int:
        return self.sph_f.shape[0]

    @property
    def P(self) -> int:
        return self.pair_i.shape[0]

    @property
    def D(self) -> int:
        return self.dof_f.shape[0]

    @property
    def T(self) -> int:
        return len(self.tools)

    @property
    def device(self) -> torch.device:
        return self.link_f.device


def sphere_pair_lists(S: int, pair_i: np.ndarray, pair_m: np.ndarray):
    """Per sphere, its live self-collision pairs in both directions, in pair
    order: (offsets (S + 1,), partner (2 P,), margin (2 P,)). The lane that
    owns sphere s walks entries [off[s], off[s + 1]) and adds the pair's hinge
    cost only where s is the lower index, so every pair costs once and every
    sphere's cotangent is summed in one place."""
    P = pair_i.shape[0]
    src = np.concatenate([pair_i[:, 0], pair_i[:, 1]]).astype(np.int64)
    dst = np.concatenate([pair_i[:, 1], pair_i[:, 0]])
    k = np.concatenate([np.arange(P), np.arange(P)])
    order = np.lexsort((k, src))
    off = np.zeros(S + 1, np.int32)
    np.cumsum(np.bincount(src, minlength=S), out=off[1:])
    margin = np.concatenate([pair_m, pair_m])
    return off, dst[order].astype(np.int32), margin[order].astype(np.float32)


def link_sphere_lists(L: int, sph_link: np.ndarray, radii: np.ndarray):
    """Per link, its live spheres (radius >= 0) in ascending order:
    (offsets (L + 1,), sphere indices). The lane that owns link l sums the
    cotangents of entries [off[l], off[l + 1]) into its force and torque."""
    live = np.nonzero(radii >= 0)[0]
    order = live[np.argsort(sph_link[live], kind="stable")]
    off = np.zeros(L + 1, np.int32)
    np.cumsum(np.bincount(sph_link[live], minlength=L), out=off[1:])
    return off, order.astype(np.int32)


def build_ik_tables(
    params: KinematicsParams, cfg: RobotRolloutConfig, device=None
) -> IKTables:
    """Robot + cost configuration -> kernel tables on `device` (default: the
    device the robot parameters live on)."""
    device = params.device if device is None else torch.device(device)
    if not 1 <= params.n_tools <= IK_MAXT:
        raise NotImplementedError(
            f"IK kernels: {params.n_tools} tool frames; the goal slot holds 1 to "
            f"{IK_MAXT} (IK_MAXT)"
        )
    if not rollout_config_is_supported(cfg):
        raise NotImplementedError(
            "IK kernels: per-axis pose weights, the metric pose cost, a bound "
            "margin and the support-polygon term are not supported"
        )
    radii = params.sphere_radii.detach().cpu().numpy().astype(np.float32)
    if not np.any(radii >= 0):
        raise ValueError(
            "robot has no collision spheres with radius >= 0; "
            "collision-aware IK kernels need at least one live sphere"
        )
    link_i, link_f = _fold_links(params)
    centers = params.sphere_centers.detach().cpu().numpy().astype(np.float32)
    sph_f = np.concatenate([centers, radii[:, None]], axis=1)
    sph_link = np.asarray(params.sphere_link_idx, np.int32)
    sc = params.self_collision
    pa = sc.pair_a.detach().cpu().numpy()
    pb = sc.pair_b.detach().cpu().numpy()
    mg = sc.pair_margin.detach().cpu().numpy().astype(np.float32)
    live = np.isfinite(mg)
    pair_i = np.stack([pa[live], pb[live]], axis=1).astype(np.int32).reshape(-1, 2)
    pair_m = mg[live]
    sp_off, sp_j, sp_m = sphere_pair_lists(len(sph_link), pair_i, pair_m)
    ls_off, ls = link_sphere_lists(link_i.shape[0], sph_link, radii)
    clip_lo, clip_hi = params.dof_clip_bounds()
    lim = params.joint_limits
    dof_f = np.stack(
        [
            lim.lower.detach().cpu().numpy(), lim.upper.detach().cpu().numpy(),
            clip_lo, clip_hi,
            params.retract_config.detach().cpu().numpy(),
            params.null_space_weight.detach().cpu().numpy(),
        ],
        axis=1,
    ).astype(np.float32)
    cfg_f = np.asarray(
        [
            cfg.pose_cost.position_weight, cfg.pose_cost.rotation_weight,
            cfg.bound_cost.weight, cfg.null_space_weight,
            cfg.self_collision_cost.weight, cfg.self_collision_cost.activation_distance,
            cfg.collision_cost.weight, cfg.collision_cost.activation_distance,
        ],
        np.float32,
    )

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return IKTables(
        link_i=t(link_i), link_f=t(link_f), sph_f=t(sph_f), sph_link=t(sph_link),
        pair_i=t(pair_i), pair_m=t(pair_m), sph_pair_off=t(sp_off), sph_pair_j=t(sp_j),
        sph_pair_m=t(sp_m), link_sph_off=t(ls_off), link_sph=t(ls), dof_f=t(dof_f), cfg_f=t(cfg_f),
        tools=tuple(int(t) for t in params.tool_frame_idx),
        link_host=tuple(tuple(int(v) for v in row) for row in link_i),
        cfg_host=tuple(float(v) for v in cfg_f),
    )


@dataclasses.dataclass(frozen=True)
class IKSolveBudget:
    """Stage budgets of `ik_solve` (defaults of `PallasIKCost.build_solver`)."""

    mppi_iters: int = 5
    n_particles: int = 16
    init_std: float = 0.6
    std_decay: float = 0.9
    min_std: float = 0.01
    temperature: float = 0.05
    step_size: float = 0.9
    lbfgs_iters: int = 28
    history: int = 8
    max_step: float = 1.0
    n_linesearch: int = 6
    ls_base: float = 1.5
    ls_ratio: float = 0.45
    warmup_iters: int = 0
    warmup_history: int = 6


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def _fk_plain(tab: IKTables, q: torch.Tensor):
    """(R (N, L, 3, 3), p (N, L, 3)) from the link table."""
    N = q.shape[0]
    lf = tab.link_f
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    Rs, ps = [], []
    for i in range(tab.L):
        kind, par, dof = tab.link_host[i]
        F = lf[i, 2:11].reshape(3, 3)
        fp = lf[i, 11:14]
        if kind == 1:
            val = lf[i, 0] * q[:, dof] + lf[i, 1]
            a = lf[i, 14:17]
            c = torch.cos(val)[:, None, None]
            s = torch.sin(val)[:, None, None]
            zero = torch.zeros((), dtype=q.dtype, device=q.device)
            K = torch.stack(
                [zero, -a[2], a[1], a[2], zero, -a[0], -a[1], a[0], zero]
            ).reshape(3, 3)
            Rj = c * eye + s * K + (1.0 - c) * (a[:, None] * a[None, :])
            Rl = F @ Rj
            pl = fp.expand(N, 3)
        elif kind == 2:
            val = lf[i, 0] * q[:, dof] + lf[i, 1]
            Rl = F.expand(N, 3, 3)
            pl = fp + val[:, None] * (F @ lf[i, 14:17])
        else:
            Rl = F.expand(N, 3, 3)
            pl = fp.expand(N, 3)
        if par < 0:
            Rs.append(Rl)
            ps.append(pl)
        else:
            Rs.append(Rs[par] @ Rl)
            ps.append(ps[par] + (Rs[par] @ pl[..., None])[..., 0])
    return torch.stack(Rs, dim=1), torch.stack(ps, dim=1)


def _rot_to_quat_plain(R: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) -> (N, 4) unit quaternion, w >= 0, dominant component first."""
    m00, m01, m02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    m10, m11, m12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    m20, m21, m22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
    qw2 = (1.0 + m00 + m11 + m22).clamp_min(0.0)
    qx2 = (1.0 + m00 - m11 - m22).clamp_min(0.0)
    qy2 = (1.0 - m00 + m11 - m22).clamp_min(0.0)
    qz2 = (1.0 - m00 - m11 + m22).clamp_min(0.0)
    cands = torch.stack(
        [
            torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1),
        ],
        dim=1,
    )  # (N, 4 candidates, 4)
    m0 = (qw2 >= qx2) & (qw2 >= qy2) & (qw2 >= qz2)
    m1 = (~m0) & (qx2 >= qy2) & (qx2 >= qz2)
    m2 = (~m0) & (~m1) & (qy2 >= qz2)
    m3 = (~m0) & (~m1) & (~m2)
    masks = torch.stack([m0, m1, m2, m3], dim=1).to(R.dtype)  # (N, 4)
    qv = (masks[:, :, None] * cands).sum(dim=1)
    norm = torch.sqrt((qv * qv).sum(dim=-1).clamp_min(1e-12))
    sign = torch.where(qv[:, 0] < 0, -torch.ones_like(norm), torch.ones_like(norm))
    return qv * (sign / norm)[:, None]


def _scene_msdf_plain(world_tabs, pts: torch.Tensor) -> torch.Tensor:
    """Min signed distance (..., ) of points (..., 3) over the four tables,
    disabled rows counting as 1e6."""
    cub, sph, cap, cyl = world_tabs
    big = pts.new_tensor(BIG)
    x = pts[..., None, :]  # (..., 1, 3)
    parts = []
    # cuboids
    rot = cub[:, 0:9].reshape(-1, 3, 3)
    u = x - cub[:, 9:12]
    l = torch.einsum("kji,...kj->...ki", rot, u)  # R^T u
    qv = l.abs() - cub[:, 12:15]
    o = torch.sqrt((qv.clamp_min(0.0) ** 2).sum(dim=-1) + 1e-12)
    inside_max = torch.maximum(qv[..., 0], torch.maximum(qv[..., 1], qv[..., 2]))
    d = o + inside_max.clamp_max(0.0)
    parts.append(torch.where(cub[:, 15] > 0.5, d, big))
    # spheres
    u = x - sph[:, 0:3]
    d = torch.sqrt((u * u).sum(dim=-1) + 1e-12) - sph[:, 3]
    parts.append(torch.where(sph[:, 4] > 0.5, d, big))
    # capsules
    ba = cap[:, 3:6]
    denom = (ba * ba).sum(dim=-1).clamp_min(1e-12)
    pa = x - cap[:, 0:3]
    h = ((pa * ba).sum(dim=-1) / denom).clamp(0.0, 1.0)
    u = pa - ba * h[..., None]
    d = torch.sqrt((u * u).sum(dim=-1) + 1e-12) - cap[:, 6]
    parts.append(torch.where(cap[:, 7] > 0.5, d, big))
    # cylinders
    rot = cyl[:, 0:9].reshape(-1, 3, 3)
    u = x - cyl[:, 9:12]
    l = torch.einsum("kji,...kj->...ki", rot, u)
    rad = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2 + 1e-12)
    dr = rad - cyl[:, 12]
    dz = l[..., 2].abs() - cyl[:, 13]
    o = torch.sqrt(dr.clamp_min(0.0) ** 2 + dz.clamp_min(0.0) ** 2 + 1e-12)
    d = o + torch.maximum(dr, dz).clamp_max(0.0)
    parts.append(torch.where(cyl[:, 14] > 0.5, d, big))
    return torch.cat(parts, dim=-1).min(dim=-1).values


def _pose_error_plain(goal: torch.Tensor, Rt: torch.Tensor, tp: torch.Tensor):
    """Squared position and rotation errors (N,) of one tool frame (rotation
    Rt (N, 3, 3), origin tp (N, 3)) against goals (N, 7); the rotation error is
    the rotation vector of conj(goal) * tool."""
    dp = goal[:, 0:3] - tp
    pe2 = (dp * dp).sum(dim=-1)
    tq = _rot_to_quat_plain(Rt)
    gw, gx, gy, gz = goal[:, 3], goal[:, 4], goal[:, 5], goal[:, 6]
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
    # in float64, rounded once: float32 atan2 on the CPU takes a vector or a
    # scalar path by the tensor's length, which would make a configuration's
    # bits depend on the batch (the kernel's are per configuration)
    angle = 2.0 * torch.atan2(s.double(), rw.double()).to(s.dtype)
    scale = torch.where(small, torch.full_like(s, 2.0), angle / s)
    return pe2, s2 * scale * scale


def _eval_plain(
    tab: IKTables, world_tabs, goal7: torch.Tensor, q: torch.Tensor,
    pose_only: bool = False, with_metrics: bool = False,
):
    """The IK objective on (N, D) configurations against goals (N, 7 T), index
    tensors for the pair and sphere loops. The pose cost is summed over the
    tool frames; the metrics take each error's maximum over them. Returns
    cost (N,), or (cost, pe2, re2, self_viol, min_clear) with
    `with_metrics`."""
    pos_w, rot_w, bound_w, null_w, sc_w, sc_act, coll_w, coll_act = tab.cfg_host
    R, p = _fk_plain(tab, q)

    cost = pe2 = re2 = None
    for t, link in enumerate(tab.tools):
        pe2_t, re2_t = _pose_error_plain(goal7[:, 7 * t: 7 * t + 7], R[:, link], p[:, link])
        c_t = pos_w * pe2_t + rot_w * re2_t
        if cost is None:
            cost, pe2, re2 = c_t, pe2_t, re2_t
        else:
            cost = cost + c_t
            pe2, re2 = torch.maximum(pe2, pe2_t), torch.maximum(re2, re2_t)

    # joint limits + null space
    lo, hi = tab.dof_f[:, 0], tab.dof_f[:, 1]
    viol = (lo - q).clamp_min(0.0) + (q - hi).clamp_min(0.0)
    cost = cost + bound_w * (viol * viol).sum(dim=-1)
    if null_w > 0.0:
        dn = (q - tab.dof_f[:, 4]) * tab.dof_f[:, 5]
        cost = cost + null_w * (dn * dn).sum(dim=-1)
    if pose_only:
        return cost

    # sphere centres
    sl = tab.sph_link.long()
    centres = (R[:, sl] @ tab.sph_f[:, 0:3, None])[..., 0] + p[:, sl]  # (N, S, 3)

    # self collision: hinge over live pairs
    self_viol = torch.full_like(cost, -BIG)
    if tab.P > 0:
        dd = centres[:, tab.pair_i[:, 0].long()] - centres[:, tab.pair_i[:, 1].long()]
        dist = torch.sqrt((dd * dd).sum(dim=-1) + 1e-12)
        cost = cost + sc_w * (tab.pair_m + sc_act - dist).clamp_min(0.0).sum(dim=-1)
        if with_metrics:
            self_viol = (tab.pair_m - dist).amax(dim=-1).clamp_min(-BIG)

    # scene: penalty on the min signed distance of every live sphere
    radii = tab.sph_f[:, 3]
    live = torch.nonzero(radii >= 0)[:, 0]
    msdf = _scene_msdf_plain(world_tabs, centres[:, live])  # (N, Slive)
    r_live = radii[live]
    cost = cost + coll_w * (coll_act + r_live - msdf).clamp_min(0.0).sum(dim=-1)
    if with_metrics:
        min_clear = (msdf - r_live).amin(dim=-1).clamp_max(BIG)
        return cost, pe2, re2, self_viol, min_clear
    return cost


def ik_cost_grad_plain(
    tab: IKTables, world_tabs, goal7: torch.Tensor, q: torch.Tensor,
    want_grad: bool = True, pose_only: bool = False,
):
    """Plain PyTorch version of `ik_cost_grad`: cost (N,) and grad (N, D) (or
    None), the gradient by autograd."""
    if not want_grad:
        with torch.no_grad():
            return _eval_plain(tab, world_tabs, goal7, q, pose_only), None
    with torch.enable_grad():
        qq = q.detach().clone().requires_grad_(True)
        c = _eval_plain(tab, world_tabs, goal7, qq, pose_only)
        (g,) = torch.autograd.grad(c.sum(), qq)
    return c.detach(), g


def _clip_plain(tab: IKTables, x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, tab.dof_f[:, 2]), tab.dof_f[:, 3])


def _lbfgs_plain(cost_fn, cost_grad_fn, clip, x0, n_iters, m, max_step,
                 n_linesearch, ls_base, ls_ratio):
    """Batched L-BFGS over (N, D): two-loop recursion (slot m-1 newest),
    descent safeguard, max-norm step clamp, best-of-L backtracking, history
    roll with the curvature guard, best iterate after a gradient evaluation."""
    N, D = x0.shape
    x = clip(x0)
    c, g = cost_grad_fn(x)
    S = x.new_zeros((m, N, D))
    Y = x.new_zeros((m, N, D))
    rho = x.new_zeros((m, N))
    valid = x.new_zeros((m, N))
    best_x, best_c = x, c
    log_ratio = math.log(ls_ratio)
    for _ in range(n_iters):
        q_ = g
        alphas = []
        for i in range(m - 1, -1, -1):
            a = rho[i] * (S[i] * q_).sum(dim=-1) * valid[i]
            q_ = q_ - a[:, None] * Y[i]
            alphas.append(a)
        alphas = alphas[::-1]
        sy = (S[m - 1] * Y[m - 1]).sum(dim=-1)
        yy = (Y[m - 1] * Y[m - 1]).sum(dim=-1)
        gamma = torch.where(valid[m - 1] > 0, sy / yy.clamp_min(1e-10), torch.ones_like(sy))
        r = gamma[:, None] * q_
        for i in range(m):
            b = rho[i] * (Y[i] * r).sum(dim=-1) * valid[i]
            r = r + S[i] * (alphas[i] - b)[:, None]
        d = -r
        descent = (d * g).sum(dim=-1) < 0
        d = torch.where(descent[:, None], d, -g)
        dn = d.abs().amax(dim=-1)
        d = d * torch.clamp(max_step / dn.clamp_min(1e-9), max=1.0)[:, None]

        best_a = torch.zeros_like(c)
        best_lc = c
        for k in range(n_linesearch):
            alpha = float(np.float32(ls_base) * np.exp(np.float32(k) * np.float32(log_ratio)))
            c_a = cost_fn(clip(x + alpha * d))
            better = c_a < best_lc
            best_a = torch.where(better, torch.full_like(best_a, alpha), best_a)
            best_lc = torch.where(better, c_a, best_lc)
        x_new = clip(x + best_a[:, None] * d)
        c_new, g_new = cost_grad_fn(x_new)

        s_ = x_new - x
        y_ = g_new - g
        sy_ = (s_ * y_).sum(dim=-1)
        ok = sy_ > 1e-10
        okf = ok.to(x.dtype)
        new_rho = torch.where(ok, 1.0 / sy_.clamp_min(1e-10), torch.zeros_like(sy_))
        S = torch.cat([S[1:], (s_ * okf[:, None])[None]], dim=0)
        Y = torch.cat([Y[1:], (y_ * okf[:, None])[None]], dim=0)
        rho = torch.cat([rho[1:], new_rho[None]], dim=0)
        valid = torch.cat([valid[1:], okf[None]], dim=0)

        improved = c_new < best_c
        best_x = torch.where(improved[:, None], x_new, best_x)
        best_c = torch.minimum(c_new, best_c)
        x, c, g = x_new, c_new, g_new
    return best_x, best_c


def _mppi_plain(cost_fn, clip, mean0, noise, n_iters, n_particles, init_std,
                std_decay, min_std, temperature, step_size):
    """Batched MPPI over (N, D) with a streaming softmax (running-minimum
    shift); noise (n_iters, n_particles, N, D) standard normals."""
    mean = clip(mean0)
    c0 = cost_fn(mean)
    best_x, best_c = mean, c0
    std = init_std
    for it in range(n_iters):
        m = torch.full_like(c0, 1.0e30)
        num = torch.zeros_like(mean)
        den = torch.zeros_like(c0)
        for pi in range(n_particles):
            x_p = mean if pi == 0 else clip(mean + std * noise[it, pi])
            c_p = cost_fn(x_p)
            m_new = torch.minimum(m, c_p)
            scale = torch.exp((m_new - m) / temperature)
            w = torch.exp((m_new - c_p) / temperature)
            num = num * scale[:, None] + w[:, None] * x_p
            den = den * scale + w
            better = c_p < best_c
            best_x = torch.where(better[:, None], x_p, best_x)
            best_c = torch.minimum(c_p, best_c)
            m = m_new
        new_mean = num / den.clamp_min(1e-12)[:, None]
        mean = clip(mean + step_size * (new_mean - mean))
        std = max(std * std_decay, min_std)
    c_mean = cost_fn(mean)
    use_mean = c_mean < best_c
    return torch.where(use_mean[:, None], mean, best_x), torch.minimum(c_mean, best_c)


def _finish_metrics_plain(tab: IKTables, cost, x, pe2, re2, self_viol, min_clear):
    pos_err = torch.sqrt(pe2.clamp_min(1e-16))
    rot_err = torch.sqrt(re2.clamp_min(1e-16))
    oob = torch.any((x < tab.dof_f[:, 0] - 1e-4) | (x > tab.dof_f[:, 1] + 1e-4), dim=-1)
    feasible = (min_clear >= 0.0) & (self_viol <= 0.0) & (~oob)
    return cost, pos_err, rot_err, feasible.to(cost.dtype)


def ik_solve_plain(
    tab: IKTables, world_tabs, goal7: torch.Tensor, x0: torch.Tensor,
    budget: IKSolveBudget, seed: int = 0, noise: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of `ik_solve`: the same stages on the same
    arguments -> (x (N, D), cost, pos_err, rot_err, feasible01 (N,))."""
    b = budget
    N, D = x0.shape
    clip = lambda x: _clip_plain(tab, x)

    def cost_fn(x):
        return ik_cost_grad_plain(tab, world_tabs, goal7, x, want_grad=False)[0]

    def cost_grad_fn(x):
        return ik_cost_grad_plain(tab, world_tabs, goal7, x)

    def pose_cost_fn(x):
        return ik_cost_grad_plain(tab, world_tabs, goal7, x, want_grad=False, pose_only=True)[0]

    def pose_cost_grad_fn(x):
        return ik_cost_grad_plain(tab, world_tabs, goal7, x, pose_only=True)

    x = x0
    if b.warmup_iters > 0:
        x, _ = _lbfgs_plain(
            pose_cost_fn, pose_cost_grad_fn, clip, x, b.warmup_iters, b.warmup_history,
            b.max_step, b.n_linesearch, b.ls_base, b.ls_ratio,
        )
    if b.mppi_iters > 0:
        if noise is None:
            noise = philox_normal_plain(seed, N, b.mppi_iters, b.n_particles, D, x0.device)
        x, _ = _mppi_plain(
            cost_fn, clip, x, noise, b.mppi_iters, b.n_particles, b.init_std,
            b.std_decay, b.min_std, b.temperature, b.step_size,
        )
    best_x, _ = _lbfgs_plain(
        cost_fn, cost_grad_fn, clip, x, b.lbfgs_iters, b.history, b.max_step,
        b.n_linesearch, b.ls_base, b.ls_ratio,
    )
    with torch.no_grad():
        c, pe2, re2, sviol, min_clear = _eval_plain(
            tab, world_tabs, goal7, best_x, with_metrics=True
        )
    c, pe, re, fe = _finish_metrics_plain(tab, c, best_x, pe2, re2, sviol, min_clear)
    return best_x, c, pe, re, fe


# ---------------------------------------------------------------------------
# Philox 4x32-10 normals (what `ik_solve` draws when it is given no noise)
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a constant a < 2^32 and int64
    tensors b < 2^32, without overflowing int64."""
    bh, bl = b >> 16, b & 0xFFFF
    t_hi, t_lo = a * bh, a * bl
    hi = (t_hi + (t_lo >> 16)) >> 16
    lo = (((t_hi & 0xFFFF) << 16) + t_lo) & _M32
    return hi, lo


def _seed_words(seed: int) -> Tuple[int, int]:
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _M32, (seed >> 32) & _M32


def philox_normal_plain(seed: int, N: int, iters: int, particles: int, D: int, device="cpu"):
    """Plain PyTorch version of the kernel's noise: standard normals
    (iters, particles, N, D), Philox 4x32-10 keyed by the seed with counter
    (config, iteration, particle, j); the four words give dimensions 2j and
    2j+1 by Box-Muller (cosine branch)."""
    J = (D + 1) // 2
    k0, k1 = _seed_words(seed)
    i64 = dict(dtype=torch.int64, device=device)
    it = torch.arange(iters, **i64)[:, None, None, None]
    pi = torch.arange(particles, **i64)[None, :, None, None]
    n = torch.arange(N, **i64)[None, None, :, None]
    j = torch.arange(J, **i64)[None, None, None, :]
    shape = (iters, particles, N, J)
    c0, c1, c2, c3 = (v.expand(shape).clone() for v in (n, it, pi, j))
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _M32
        k1 = (k1 + 0xBB67AE85) & _M32

    def box_muller(b1, b2):
        u1 = (b1.to(torch.float32) + 0.5) * 2.3283064365386963e-10
        u2 = (b2.to(torch.float32) + 0.5) * 2.3283064365386963e-10
        u1 = u1.clamp(1e-7, 1.0 - 1e-7)
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.2831853071795865 * u2)

    z = torch.stack([box_muller(c0, c1), box_muller(c2, c3)], dim=-1)  # (..., J, 2)
    return z.reshape(iters, particles, N, 2 * J)[..., :D].contiguous()


# ---------------------------------------------------------------------------
# CUDA side: ctypes mirrors of the C structures, library, wrappers
# ---------------------------------------------------------------------------
class _CRobot(ctypes.Structure):
    _fields_ = [
        ("link_i", ctypes.c_void_p), ("link_f", ctypes.c_void_p),
        ("sph_f", ctypes.c_void_p), ("sph_link", ctypes.c_void_p),
        ("pair_off", ctypes.c_void_p), ("pair_j", ctypes.c_void_p), ("pair_m", ctypes.c_void_p),
        ("lsph_off", ctypes.c_void_p), ("lsph", ctypes.c_void_p),
        ("dof_f", ctypes.c_void_p), ("cfg_f", ctypes.c_void_p),
        ("L", ctypes.c_int), ("S", ctypes.c_int), ("P", ctypes.c_int),
        ("D", ctypes.c_int), ("n_lsph", ctypes.c_int), ("n_tools", ctypes.c_int),
        ("tool", ctypes.c_int * IK_MAXT),
    ]


class _CWorld(ctypes.Structure):
    _fields_ = [
        ("cub", ctypes.c_void_p), ("sph", ctypes.c_void_p),
        ("cap", ctypes.c_void_p), ("cyl", ctypes.c_void_p),
        ("Kc", ctypes.c_int), ("Ks", ctypes.c_int),
        ("Kp", ctypes.c_int), ("Ky", ctypes.c_int),
    ]


class _CSolveCfg(ctypes.Structure):
    _fields_ = [
        ("warmup_iters", ctypes.c_int), ("warmup_history", ctypes.c_int),
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
        lib.ik_max_dof.argtypes = []
        lib.ik_max_dof.restype = ci
        lib.ik_cost_grad_scratch_words.argtypes = [vp, vp]
        lib.ik_cost_grad_scratch_words.restype = ci
        lib.ik_solve_scratch_words.argtypes = [vp, vp, vp]
        lib.ik_solve_scratch_words.restype = ci
        lib.ik_cost_grad_launch.argtypes = [vp] * 7 + [ci, ci, vp]
        lib.ik_cost_grad_launch.restype = ci
        lib.ik_solve_launch.argtypes = [vp] * 12 + [ci, vp]
        lib.ik_solve_launch.restype = ci
        lib.ik_philox_normal_launch.argtypes = [cu, cu, ci, ci, ci, ci, vp, vp]
        lib.ik_philox_normal_launch.restype = ci
        _lib_ready = lib
    return _lib_ready


def _check_inputs(tab: IKTables, world_tabs, goal7: torch.Tensor, q: torch.Tensor):
    if q.ndim != 2 or q.shape[1] != tab.D:
        raise ValueError(f"q must have shape (N, {tab.D}), got {tuple(q.shape)}")
    if goal7.shape != (q.shape[0], 7 * tab.T):
        raise ValueError(
            f"goal7 must have shape ({q.shape[0]}, {7 * tab.T}) ({tab.T} tool frames), "
            f"got {tuple(goal7.shape)}"
        )
    widths = (16, 5, 8, 15)
    if len(world_tabs) != 4:
        raise ValueError("world tables: expected (cub, sph, cap, cyl)")
    for t, wd in zip(world_tabs, widths):
        if t.ndim != 2 or t.shape[1] != wd or t.shape[0] < 1:
            raise ValueError(f"world table must have shape (K >= 1, {wd}), got {tuple(t.shape)}")
    named = [("goal7", goal7), ("q", q), ("robot tables", tab.link_f)]
    named += [(f"world table {i}", t) for i, t in enumerate(world_tabs)]
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")


def _c_robot(tab: IKTables) -> _CRobot:
    return _CRobot(
        tab.link_i.data_ptr(), tab.link_f.data_ptr(), tab.sph_f.data_ptr(),
        tab.sph_link.data_ptr(), tab.sph_pair_off.data_ptr(), tab.sph_pair_j.data_ptr(),
        tab.sph_pair_m.data_ptr(), tab.link_sph_off.data_ptr(), tab.link_sph.data_ptr(),
        tab.dof_f.data_ptr(), tab.cfg_f.data_ptr(),
        tab.L, tab.S, tab.P, tab.D, tab.link_sph.shape[0], tab.T,
        (ctypes.c_int * IK_MAXT)(*tab.tools),
    )


def _c_world(world_tabs) -> _CWorld:
    cub, sph, cap, cyl = world_tabs
    return _CWorld(
        cub.data_ptr(), sph.data_ptr(), cap.data_ptr(), cyl.data_ptr(),
        cub.shape[0], sph.shape[0], cap.shape[0], cyl.shape[0],
    )


def _scratch(words: int, device):
    """A launch's global buffer, where the kernel says (by its words) that a
    world or a trajectory's step state does not fit in shared memory; None
    when everything fits."""
    if words == 0:
        return None
    return torch.empty((words,), dtype=torch.float32, device=device)


def _cuda_guard(tab: IKTables, lib):
    if tab.D > lib.ik_max_dof():
        raise NotImplementedError(
            f"IK kernels give each degree of freedom a lane and take at most "
            f"{lib.ik_max_dof()}; this robot has {tab.D}"
        )


def ik_cost_grad(
    tab: IKTables, world_tabs, goal7: torch.Tensor, q: torch.Tensor, want_grad: bool = True
):
    """goal7 (N, 7 T), q (N, D) -> cost (N,), grad (N, D) (None unless asked).
    CUDA tensors go through the `ik_cost_grad` kernel, CPU tensors through
    `ik_cost_grad_plain`."""
    _check_inputs(tab, world_tabs, goal7, q)
    if q.device.type == "cpu":
        return ik_cost_grad_plain(tab, world_tabs, goal7, q, want_grad)
    lib = _lib()
    _cuda_guard(tab, lib)
    N = q.shape[0]
    goal7, q = goal7.contiguous(), q.contiguous()
    world_tabs = tuple(t.contiguous() for t in world_tabs)
    cost = torch.empty((N,), dtype=torch.float32, device=q.device)
    grad = torch.empty((N, tab.D), dtype=torch.float32, device=q.device) if want_grad else None
    with torch.cuda.device(q.device):
        rb, w = _c_robot(tab), _c_world(world_tabs)
        rbp, wp = ctypes.addressof(rb), ctypes.addressof(w)
        scratch = _scratch(lib.ik_cost_grad_scratch_words(rbp, wp), q.device)
        err = lib.ik_cost_grad_launch(
            rbp, wp, goal7.data_ptr(), q.data_ptr(),
            cost.data_ptr(), grad.data_ptr() if want_grad else None,
            None if scratch is None else scratch.data_ptr(), N, int(want_grad),
            torch.cuda.current_stream().cuda_stream,
        )
    ik_cost_grad.launches += 1
    if err != 0:
        raise RuntimeError(f"ik_cost_grad kernel launch failed: CUDA error {err}")
    return cost, grad


ik_cost_grad.launches = 0


def _check_budget(b: IKSolveBudget):
    if b.history < 1 or b.warmup_history < 1:
        raise ValueError("L-BFGS history must be >= 1")
    if min(b.warmup_iters, b.mppi_iters, b.lbfgs_iters, b.n_linesearch) < 0:
        raise ValueError("stage budgets must be >= 0")
    if b.mppi_iters > 0 and b.n_particles < 1:
        raise ValueError("n_particles must be >= 1 when the MPPI stage runs")
    if not 0.0 < b.ls_ratio:
        raise ValueError("ls_ratio must be > 0")


def ik_solve(
    tab: IKTables, world_tabs, goal7: torch.Tensor, x0: torch.Tensor,
    budget: IKSolveBudget, seed: int = 0, noise: Optional[torch.Tensor] = None,
):
    """A whole solve per configuration: goal7 (N, 7 T), x0 (N, D) ->
    (x (N, D), cost, pos_err, rot_err, feasible01 (N,)).

    `noise`, when given, is (mppi_iters, n_particles, N, D) standard normals
    used by the MPPI stage instead of the generator keyed by `seed`. CUDA
    tensors go through the `ik_solve` kernel, CPU tensors through
    `ik_solve_plain`."""
    _check_inputs(tab, world_tabs, goal7, x0)
    _check_budget(budget)
    N, D = x0.shape
    if noise is not None:
        want = (budget.mppi_iters, budget.n_particles, N, D)
        if tuple(noise.shape) != want or noise.dtype != torch.float32 or noise.device != x0.device:
            raise ValueError(
                f"noise must be float32 {want} on {x0.device}, got "
                f"{noise.dtype} {tuple(noise.shape)} on {noise.device}"
            )
    if x0.device.type == "cpu":
        return ik_solve_plain(tab, world_tabs, goal7, x0, budget, seed, noise)
    lib = _lib()
    _cuda_guard(tab, lib)
    b = budget
    goal7, x0 = goal7.contiguous(), x0.contiguous()
    world_tabs = tuple(t.contiguous() for t in world_tabs)
    if noise is not None:
        noise = noise.contiguous()
    dev = x0.device
    x = torch.empty((N, D), dtype=torch.float32, device=dev)
    outs = [torch.empty((N,), dtype=torch.float32, device=dev) for _ in range(4)]
    s_lo, s_hi = _seed_words(seed)
    cfg = _CSolveCfg(
        b.warmup_iters, b.warmup_history, b.mppi_iters, b.n_particles,
        b.init_std, b.std_decay, b.min_std, b.temperature, b.step_size,
        b.lbfgs_iters, b.history, b.max_step, b.n_linesearch, b.ls_base, b.ls_ratio,
        s_lo, s_hi,
    )
    with torch.cuda.device(dev):
        rb, w = _c_robot(tab), _c_world(world_tabs)
        rbp, wp, cfgp = ctypes.addressof(rb), ctypes.addressof(w), ctypes.addressof(cfg)
        scratch = _scratch(lib.ik_solve_scratch_words(rbp, wp, cfgp), dev)
        err = lib.ik_solve_launch(
            rbp, wp, cfgp, goal7.data_ptr(), x0.data_ptr(),
            noise.data_ptr() if noise is not None else None,
            x.data_ptr(), *(o.data_ptr() for o in outs),
            None if scratch is None else scratch.data_ptr(), N,
            torch.cuda.current_stream().cuda_stream,
        )
    ik_solve.launches += 1
    if err != 0:
        raise RuntimeError(f"ik_solve kernel launch failed: CUDA error {err}")
    return (x, *outs)


ik_solve.launches = 0


def philox_normal(seed: int, N: int, iters: int, particles: int, D: int, device):
    """The standard normals `ik_solve` draws for its MPPI stage when it is
    given no noise, (iters, particles, N, D): a debug entry of the kernel
    library on a CUDA device, `philox_normal_plain` on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_normal_plain(seed, N, iters, particles, D, device)
    lib = _lib()
    if D > lib.ik_max_dof():
        raise NotImplementedError(f"at most {lib.ik_max_dof()} dimensions, got {D}")
    out = torch.empty((iters, particles, N, D), dtype=torch.float32, device=device)
    s_lo, s_hi = _seed_words(seed)
    with torch.cuda.device(device):
        err = lib.ik_philox_normal_launch(
            s_lo, s_hi, N, iters, particles, D, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    philox_normal.launches += 1
    if err != 0:
        raise RuntimeError(f"ik_philox_normal kernel launch failed: CUDA error {err}")
    return out


philox_normal.launches = 0


# ---------------------------------------------------------------------------
# Object API (counterpart of PallasIKCost)
# ---------------------------------------------------------------------------
class IKCost:
    """Build once per (robot, cost config); call per solve with any world
    (obstacle capacities are launch arguments, nothing is rebuilt per world).

    __call__(goal7 (N, 7 T), q (N, D), world) -> (cost (N,), grad (N, D)),
    the goal holding each tool frame's [position, quaternion] in turn.
    """

    def __init__(self, params: KinematicsParams, cfg: RobotRolloutConfig, device=None):
        self.params = params
        self.cfg = cfg
        self.tables = build_ik_tables(params, cfg, device)

    def _world_tabs(self, world):
        if not world_is_supported(world):
            raise NotImplementedError("IK kernels: voxel-grid worlds are not supported")
        return pack_world_arrays(world)

    def __call__(self, goal7, q, world):
        return ik_cost_grad(self.tables, self._world_tabs(world), goal7, q, True)

    def cost_only(self, goal7, q, world):
        return ik_cost_grad(self.tables, self._world_tabs(world), goal7, q, False)[0]

    def build_solver(self, **budget):
        """solve(goal7 (N, 7 T), x0 (N, D), seed, world, noise=None) ->
        (x (N, D), cost, pos_err, rot_err, feasible01): one launch."""
        b = IKSolveBudget(**budget)
        _check_budget(b)

        def solve(goal7, x0, seed, world, noise=None):
            return ik_solve(self.tables, self._world_tabs(world), goal7, x0, b, seed, noise)

        return solve

    def build_mppi_solver(
        self, n_iters: int = 5, n_particles: int = 16, init_std: float = 0.6,
        std_decay: float = 0.9, min_std: float = 0.01, temperature: float = 0.05,
        step_size: float = 0.9,
    ):
        """The MPPI stage alone: solve(goal7, x0, seed, world, noise=None)
        -> (x (N, D), cost)."""
        full = self.build_solver(
            mppi_iters=n_iters, n_particles=n_particles, init_std=init_std,
            std_decay=std_decay, min_std=min_std, temperature=temperature,
            step_size=step_size, lbfgs_iters=0, history=1, warmup_iters=0,
        )

        def solve(goal7, x0, seed, world, noise=None):
            return full(goal7, x0, seed, world, noise)[:2]

        return solve

    def build_lbfgs_solver(
        self, n_iters: int = 28, history: int = 8, max_step: float = 1.0,
        n_linesearch: int = 6, ls_base: float = 1.5, ls_ratio: float = 0.45,
    ):
        """The L-BFGS stage alone: solve(goal7, x0, world) -> (x (N, D), cost)."""
        full = self.build_solver(
            mppi_iters=0, lbfgs_iters=n_iters, history=history, max_step=max_step,
            n_linesearch=n_linesearch, ls_base=ls_base, ls_ratio=ls_ratio, warmup_iters=0,
        )

        def solve(goal7, x0, world):
            return full(goal7, x0, 0, world)[:2]

        return solve
