"""Dense-grid TSDF mapper: depth/LiDAR -> TSDF (+RGB/features) -> ESDF ->
planning world, with raycast rendering and pose refinement.

Counterpart of `curobo_tpu/perception/mapper.py`, as eager PyTorch on the
grid's device:
- voxel-centric projective camera TSDF integration (a gather per voxel, no
  atomics), with RGB/feature accumulators fused only over the truncation band,
  compacted to `appearance_budget` voxels;
- voxel-centric LiDAR integration through a scatter-min range image, with
  free-space carving, and the legacy surface-hit path for clouds without one
  viewpoint;
- ESDF by the exact separable min-plus EDT or by jump flooding (1 + JFA + 2);
- EMA decay, obstacle stamping, a raycast depth renderer and Gauss-Newton
  camera pose refinement against the TSDF;
- checkpoints in the JAX mapper's `.npz` format, readable by either package.

Integer conversions saturate as XLA's do (`_to_i32`: NaN -> 0, out of range
-> the int32 limits), and indices are clamped before any gather, so every
index is in range on the card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from curobo_tpu_torch.geom.types import VoxelGridObstacle
from curobo_tpu_torch.math import quaternion as qm
from curobo_tpu_torch.perception.types import CameraObservation, LidarObservation
from curobo_tpu_torch.runtime import resolve_device
from curobo_tpu_torch.types.pose import Pose


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    # grid shape in voxels
    dims: Tuple[int, int, int] = (128, 128, 128)
    voxel_size: float = 0.02
    # world position of voxel (0,0,0) center
    origin: Tuple[float, float, float] = (-1.28, -1.28, -0.5)
    truncation: float = 0.06  # TSDF truncation band (m)
    max_weight: float = 64.0
    occupancy_threshold: float = 0.0  # tsdf < this => occupied
    # appearance channels
    rgb_channels: bool = False
    feature_channels: int = 0
    # voxel budget of the per-frame appearance update (None = V/8): only the
    # first this many voxels of the observed truncation band are fused
    appearance_budget: Optional[int] = None
    # ESDF algorithm: "exact" (separable min-plus, O(n^4) work), "jfa" (jump
    # flooding, O(n^3 log n)) or "auto" (exact up to 160 a side)
    esdf_mode: str = "auto"
    # LiDAR range-image bins (azimuth x elevation) and elevation field of view
    lidar_bins: Tuple[int, int] = (512, 64)
    lidar_fov_elevation: Tuple[float, float] = (-0.45, 0.45)  # radians


@dataclasses.dataclass(frozen=True)
class TSDFGrid:
    """Mapper state."""

    tsdf: torch.Tensor  # (X, Y, Z) truncated signed distance
    weight: torch.Tensor  # (X, Y, Z) integration weight
    rgb: Optional[torch.Tensor] = None  # (X, Y, Z, 3) weighted-mean color
    feature: Optional[torch.Tensor] = None  # (X, Y, Z, F)


def make_grid(cfg: MapperConfig, device=None) -> TSDFGrid:
    dev = resolve_device(device)
    dims = tuple(cfg.dims)
    return TSDFGrid(
        tsdf=torch.full(dims, cfg.truncation, dtype=torch.float32, device=dev),
        weight=torch.zeros(dims, dtype=torch.float32, device=dev),
        rgb=torch.zeros(dims + (3,), dtype=torch.float32, device=dev) if cfg.rgb_channels else None,
        feature=(torch.zeros(dims + (cfg.feature_channels,), dtype=torch.float32, device=dev)
                 if cfg.feature_channels > 0 else None),
    )


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA converts: NaN -> 0, out of range saturates."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, 2147483648.0)
    return x.to(torch.int64).clamp(-2147483648, 2147483647).to(torch.int32)


@functools.lru_cache(maxsize=8)
def _voxel_centers_cached(dims, voxel_size, origin, device) -> torch.Tensor:
    axes = [torch.arange(dims[k], device=device).to(torch.float32) * voxel_size + origin[k]
            for k in range(3)]
    X, Y, Z = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([X, Y, Z], dim=-1)  # (X, Y, Z, 3)


def _voxel_centers(cfg: MapperConfig, device) -> torch.Tensor:
    return _voxel_centers_cached(tuple(cfg.dims), float(cfg.voxel_size),
                                 tuple(float(o) for o in cfg.origin), torch.device(device))


def project(pose: Pose, intrinsics: torch.Tensor, pts: torch.Tensor, H: int, W: int):
    """World points (N, 3) -> (camera-frame z, flat pixel index, in-image
    mask), in the JAX integrators' order of operations: the inverse pose's
    `transform_points`, then x / max(z, 1e-6) * fx + cx, rounded half to even."""
    pc = pose.inverse().transform_points(pts[None])[0]
    z = pc[:, 2]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    u = pc[:, 0] / z.clamp_min(1e-6) * fx + cx
    v = pc[:, 1] / z.clamp_min(1e-6) * fy + cy
    ui = _to_i32(torch.round(u)).clamp(0, W - 1)
    vi = _to_i32(torch.round(v)).clamp(0, H - 1)
    in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 1e-3)
    return z, vi.long() * W + ui.long(), in_img


def _fuse(cfg, grid, tsdf_new, w_new) -> TSDFGrid:
    """Weighted running-mean fuse of flat (V,) updates into the grid (shared
    by the camera and LiDAR integrators)."""
    tsdf_old = grid.tsdf.reshape(-1)
    w_old = grid.weight.reshape(-1)
    w_sum = w_old + w_new
    denom = w_sum.clamp_min(1e-6)
    tsdf = torch.where(w_sum > 0, (tsdf_old * w_old + tsdf_new * w_new) / denom, tsdf_old)
    w = w_sum.clamp_max(cfg.max_weight)
    dims = tuple(cfg.dims)
    return TSDFGrid(tsdf.reshape(dims), w.reshape(dims), rgb=grid.rgb, feature=grid.feature)


def integrate_camera(cfg: MapperConfig, grid: TSDFGrid, obs: CameraObservation) -> TSDFGrid:
    """Voxel-centric projective TSDF update (one depth gather per voxel).

    Also fuses per-pixel RGB / feature channels when both the config and the
    observation carry them: only the truncation band around the observed
    surface, its first `appearance_budget` voxels in index order."""
    H, W = obs.depth.shape
    V = int(np.prod(cfg.dims))
    centers = _voxel_centers(cfg, grid.tsdf.device).reshape(-1, 3)
    z, flat_px, in_img = project(obs.pose, obs.intrinsics, centers, H, W)
    d = obs.depth.reshape(H * W)[flat_px]
    valid = in_img & (d > 0)
    sdf = d - z
    tsdf_new = sdf.clamp(-cfg.truncation, cfg.truncation)
    # integrate only within the truncation band behind the surface
    update = valid & (sdf > -cfg.truncation)
    w_new = update.to(torch.float32)
    out = _fuse(cfg, grid, tsdf_new, w_new)

    want_rgb = grid.rgb is not None and obs.rgb is not None
    want_feat = grid.feature is not None and obs.feature is not None
    if not (want_rgb or want_feat):
        return out
    near = update & (sdf.abs() <= cfg.truncation)
    budget = cfg.appearance_budget or max(V // 8, 1)
    vox = torch.nonzero(near).reshape(-1)[:budget]  # jnp.nonzero(size=budget) less its fill
    px = flat_px[vox]
    w_old = grid.weight.reshape(V)[vox]
    den = (w_old + 1.0)[:, None]  # w_new == 1 in the band
    rgb, feat = out.rgb, out.feature
    if want_rgb:
        new = obs.rgb.reshape(H * W, 3)[px]
        rgb = grid.rgb.reshape(V, 3).clone()
        rgb[vox] = (rgb[vox] * w_old[:, None] + new) / den
        rgb = rgb.reshape(grid.rgb.shape)
    if want_feat:
        F = grid.feature.shape[-1]
        new = obs.feature.reshape(H * W, F)[px]
        feat = grid.feature.reshape(V, F).clone()
        feat[vox] = (feat[vox] * w_old[:, None] + new) / den
        feat = feat.reshape(grid.feature.shape)
    return TSDFGrid(out.tsdf, out.weight, rgb=rgb, feature=feat)


# ---------------------------------------------------------------------------
# LiDAR
# ---------------------------------------------------------------------------
def _bin(x: torch.Tensor, n: int) -> torch.Tensor:
    return _to_i32(x).clamp(0, n - 1).long()


def _lidar_range_image(cfg: MapperConfig, pts_sensor: torch.Tensor) -> torch.Tensor:
    """Rasterize a sensor-frame cloud into an (n_el, n_az) range image by
    scatter-min (empty bins = +inf)."""
    n_az, n_el = cfg.lidar_bins
    r = torch.linalg.norm(pts_sensor, dim=-1)
    az = torch.atan2(pts_sensor[:, 1], pts_sensor[:, 0])  # [-pi, pi]
    el = torch.asin(pts_sensor[:, 2] / r.clamp_min(1e-6))
    lo, hi = cfg.lidar_fov_elevation
    ai = _bin((az + np.pi) / (2 * np.pi) * n_az, n_az)
    ei = _bin((el - lo) / (hi - lo) * n_el, n_el)
    valid = (r > 1e-3) & torch.isfinite(r) & (el >= lo) & (el <= hi)
    flat = ei * n_az + ai
    img = torch.full((n_el * n_az,), float("inf"), dtype=torch.float32, device=pts_sensor.device)
    img.scatter_reduce_(0, flat, torch.where(valid, r, float("inf")), "amin")
    return img.reshape(n_el, n_az)


def integrate_lidar(cfg: MapperConfig, grid: TSDFGrid, obs: LidarObservation) -> TSDFGrid:
    """Voxel-centric projective LiDAR update with free-space carving: every
    voxel reads the measured range along its own bearing and fuses
    sdf = r_meas - r_voxel like the camera path."""
    rng_img = _lidar_range_image(cfg, obs.points)
    n_az, n_el = cfg.lidar_bins
    lo, hi = cfg.lidar_fov_elevation
    centers = _voxel_centers(cfg, grid.tsdf.device).reshape(-1, 3)
    pc = obs.pose.inverse().transform_points(centers[None])[0]  # sensor frame
    r_vox = torch.linalg.norm(pc, dim=-1)
    az = torch.atan2(pc[:, 1], pc[:, 0])
    el = torch.asin(pc[:, 2] / r_vox.clamp_min(1e-6))
    ai = _bin((az + np.pi) / (2 * np.pi) * n_az, n_az)
    ei = _bin((el - lo) / (hi - lo) * n_el, n_el)
    in_fov = (el >= lo) & (el <= hi) & (r_vox > 1e-3)
    r_meas = rng_img[ei, ai]
    sdf = r_meas - r_vox
    valid = in_fov & torch.isfinite(r_meas)
    tsdf_new = sdf.clamp(-cfg.truncation, cfg.truncation)
    update = valid & (sdf > -cfg.truncation)
    return _fuse(cfg, grid, tsdf_new, update.to(torch.float32))


def integrate_lidar_points(cfg: MapperConfig, grid: TSDFGrid, obs: LidarObservation) -> TSDFGrid:
    """Legacy path: world points become surface hits only (no carving), for
    clouds without a meaningful single viewpoint."""
    pts = obs.world_points()
    dev = pts.device
    org = torch.tensor(cfg.origin, dtype=torch.float32, device=dev)
    dims = torch.tensor(cfg.dims, device=dev)
    idx = _to_i32(torch.round((pts - org) / cfg.voxel_size)).long()
    valid = ((idx >= 0) & (idx < dims)).all(dim=-1)
    idx = torch.minimum(idx.clamp_min(0), dims - 1)
    flat = idx[:, 0] * cfg.dims[1] * cfg.dims[2] + idx[:, 1] * cfg.dims[2] + idx[:, 2]
    hits = torch.zeros(int(np.prod(cfg.dims)), dtype=grid.tsdf.dtype, device=dev)
    hits.index_add_(0, flat, valid.to(grid.tsdf.dtype))
    hit = (hits > 0).reshape(tuple(cfg.dims))
    tsdf = torch.where(hit, -cfg.voxel_size, grid.tsdf)
    w = torch.where(hit, grid.weight.clamp_min(1.0), grid.weight)
    return TSDFGrid(tsdf, w, rgb=grid.rgb, feature=grid.feature)


# ---------------------------------------------------------------------------
# Decay / stamping
# ---------------------------------------------------------------------------
def decay(cfg: MapperConfig, grid: TSDFGrid, factor: float) -> TSDFGrid:
    """EMA weight decay: old observations fade so moving obstacles clear.
    Voxels whose weight drops below 1e-3 reset to unobserved."""
    w = grid.weight * factor
    dead = w < 1e-3
    return TSDFGrid(tsdf=torch.where(dead, cfg.truncation, grid.tsdf),
                    weight=torch.where(dead, 0.0, w), rgb=grid.rgb, feature=grid.feature)


def stamp_obstacles(cfg: MapperConfig, grid: TSDFGrid, world) -> TSDFGrid:
    """Stamp known world obstacles into the TSDF: voxels inside any obstacle
    become surface hits at full weight."""
    from curobo_tpu_torch.geom import world as world_mod

    centers = _voxel_centers(cfg, grid.tsdf.device).reshape(-1, 3)
    sd = world_mod.sphere_sdf(world, centers).reshape(tuple(cfg.dims))
    inside = sd <= 0.0
    tsdf = torch.where(inside, sd.clamp_min(-cfg.truncation), grid.tsdf)
    w = torch.where(inside, cfg.max_weight, grid.weight)
    return TSDFGrid(tsdf, w, rgb=grid.rgb, feature=grid.feature)


# ---------------------------------------------------------------------------
# ESDF: exact separable min-plus EDT + JFA
# ---------------------------------------------------------------------------
def _edt_1d_pass(dist2: torch.Tensor, cell: float) -> torch.Tensor:
    """Min-plus transform along the LAST axis: out[i] = min_j dist2[j] +
    ((i - j) * cell)^2, as an (n, n) broadcast min-reduction."""
    n = dist2.shape[-1]
    i = torch.arange(n, device=dist2.device)
    offs = ((i[:, None] - i[None, :]).to(torch.float32) * cell) ** 2  # (n_out, n_src)
    return (dist2[..., None, :] + offs).amin(dim=-1)


def exact_edt(occupied: torch.Tensor, cell: float, cap: float = 1.0e6) -> torch.Tensor:
    """Exact Euclidean distance transform of a boolean grid -> distances (m)."""
    d2 = torch.where(occupied, 0.0, cap)
    for _ in range(3):  # each pass moves the next axis last
        d2 = _edt_1d_pass(torch.movedim(d2, 0, -1), cell)
    return torch.sqrt(d2.clamp_min(0.0))


def _shift_fill(a: torch.Tensor, off: Tuple[int, int, int], fill: float) -> torch.Tensor:
    """out[i] = a[i - off] where that is inside the grid, else `fill` (the JFA
    neighbour fetch)."""
    out = torch.full_like(a, fill)
    dst, src = [], []
    for o, n in zip(off, a.shape):
        if o >= 0:
            dst.append(slice(o, n))
            src.append(slice(0, n - o))
        else:
            dst.append(slice(0, n + o))
            src.append(slice(-o, n))
    out[tuple(dst)] = a[tuple(src)]
    return out


def jfa_schedule(n: int):
    """1 + JFA + 2: step 1, then n/2, n/4, ..., 1, then 2, 1."""
    schedule = [1]
    k = 1
    while k < n:
        k *= 2
    k //= 2
    while k >= 1:
        schedule.append(k)
        k //= 2
    return schedule + [2, 1]


_JFA_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
                if (dx, dy, dz) != (0, 0, 0)]


def jfa_edt(occupied: torch.Tensor, cell: float) -> torch.Tensor:
    """Jump-flooding EDT (1 + JFA + 2 schedule): nearest-site coordinates
    propagate through rounds of 26 static-offset neighbour fetches, taken on a
    strict `<` in the JAX package's offset order."""
    X, Y, Z = occupied.shape
    dev = occupied.device
    gx, gy, gz = torch.meshgrid(*(torch.arange(n, device=dev, dtype=torch.float32)
                                  for n in (X, Y, Z)), indexing="ij")
    BIG = 1e9
    sx = torch.where(occupied, gx, BIG)
    sy = torch.where(occupied, gy, BIG)
    sz = torch.where(occupied, gz, BIG)
    best = torch.where(occupied, 0.0, BIG)
    for k in jfa_schedule(max(X, Y, Z)):
        for dx, dy, dz in _JFA_OFFSETS:
            off = (dx * k, dy * k, dz * k)
            cx = _shift_fill(sx, off, BIG)
            cy = _shift_fill(sy, off, BIG)
            cz = _shift_fill(sz, off, BIG)
            d2 = torch.where(cx < BIG, (gx - cx) ** 2 + (gy - cy) ** 2 + (gz - cz) ** 2, BIG)
            take = d2 < best
            sx = torch.where(take, cx, sx)
            sy = torch.where(take, cy, sy)
            sz = torch.where(take, cz, sz)
            best = torch.where(take, d2, best)
    return torch.sqrt(best.clamp_max(BIG)) * cell


def compute_esdf(cfg: MapperConfig, grid: TSDFGrid) -> torch.Tensor:
    """Signed ESDF grid (X, Y, Z): positive outside obstacles. Unobserved
    space (weight 0) counts as free."""
    occupied = (grid.weight > 0) & (grid.tsdf < cfg.occupancy_threshold)
    mode = cfg.esdf_mode
    if mode == "auto":
        mode = "exact" if max(cfg.dims) <= 160 else "jfa"
    edt = exact_edt if mode == "exact" else jfa_edt
    d_out = edt(occupied, cfg.voxel_size)
    d_in = edt(~occupied, cfg.voxel_size)
    return torch.where(occupied, -d_in, d_out)


# ---------------------------------------------------------------------------
# Rendering + pose refinement
# ---------------------------------------------------------------------------
def _sample_trilinear(cfg: MapperConfig, vol: torch.Tensor, pts: torch.Tensor):
    """Trilinear sample of a (X, Y, Z) volume at world points (..., 3).
    Out-of-grid points clamp to the border. Returns (values, in_bounds)."""
    dev = pts.device
    org = torch.tensor(cfg.origin, dtype=torch.float32, device=dev)
    dims = torch.tensor(cfg.dims, device=dev)
    g = (pts - org) / cfg.voxel_size
    inb = ((g >= 0) & (g <= dims - 1)).all(dim=-1)
    g = torch.minimum(g.clamp_min(0.0), (dims - 1) - 1e-4)
    i0 = torch.floor(g).to(torch.int64)
    f = g - i0
    i1 = torch.minimum(i0 + 1, dims - 1)
    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    fx, fy, fz = f.unbind(-1)
    c00 = vol[x0, y0, z0] * (1 - fx) + vol[x1, y0, z0] * fx
    c10 = vol[x0, y1, z0] * (1 - fx) + vol[x1, y1, z0] * fx
    c01 = vol[x0, y0, z1] * (1 - fx) + vol[x1, y0, z1] * fx
    c11 = vol[x0, y1, z1] * (1 - fx) + vol[x1, y1, z1] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz, inb


def render_depth(
    cfg: MapperConfig,
    grid: TSDFGrid,
    intrinsics: torch.Tensor,
    pose: Pose,  # camera-to-world
    shape: Tuple[int, int],
    n_steps: int = 192,
    t_near: float = 0.05,
    t_far: Optional[float] = None,
) -> torch.Tensor:
    """Raymarch the TSDF to a depth image (H, W); 0 where no surface. A fixed
    number of steps, the first zero crossing refined linearly between the two
    samples that straddle it."""
    H, W = shape
    dev = grid.tsdf.device
    if t_far is None:
        t_far = float(max(cfg.dims) * cfg.voxel_size * 1.8)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    v, u = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    dirs_cam = torch.stack([(u - cx) / fx, (v - cy) / fy,
                            torch.ones((H, W), dtype=torch.float32, device=dev)], dim=-1)
    R = pose.rotation_matrix()
    dirs_w = torch.einsum("ij,hwj->hwi", R, dirs_cam)
    ts = torch.linspace(t_near, t_far, n_steps, device=dev)
    pts = pose.position + ts[:, None, None, None] * dirs_w[None]  # (S, H, W, 3)
    val, inb = _sample_trilinear(cfg, grid.tsdf, pts)
    wgt, _ = _sample_trilinear(cfg, grid.weight, pts)
    val = torch.where(inb & (wgt > 0), val, cfg.truncation)
    prev = torch.cat([val[:1], val[:-1]], dim=0)
    crossing = (val <= 0.0) & (prev > 0.0)
    any_hit = crossing.any(dim=0)
    first = crossing.to(torch.uint8).argmax(dim=0)  # first crossing
    s0 = (first - 1).clamp_min(0)
    v0 = torch.gather(val, 0, s0[None])[0]
    v1 = torch.gather(val, 0, first[None])[0]
    t0, t1 = ts[s0], ts[first]
    a = v0 / (v0 - v1).clamp_min(1e-9)
    return torch.where(any_hit, t0 + a * (t1 - t0), 0.0)


def _aa_quat(aa: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> quaternion with a series sinc near zero, so the
    derivative is finite at aa = 0. (The norm keeps a dimension: forward-mode
    derivatives of a 0-d tensor plus a Python float come out in float64.)"""
    t2 = (aa * aa).sum(dim=-1, keepdim=True)
    t = torch.sqrt(t2 + 1e-18)
    s = torch.where(t < 1e-4, 0.5 - t2 / 48.0, torch.sin(t / 2.0) / t)
    return torch.cat([torch.cos(t / 2.0), aa * s])


def refine_camera_pose(
    cfg: MapperConfig,
    grid: TSDFGrid,
    obs: CameraObservation,
    n_iters: int = 20,
    step: float = 0.5,
    max_points: int = 4096,
) -> Pose:
    """Refine the observation's camera pose against the map: Gauss-Newton on
    the TSDF at the back-projected depth points over an SE(3) perturbation
    (translation, left-applied rotation vector), a fixed number of steps with
    no host read inside the loop. Returns the corrected camera-to-world Pose."""
    H, W = obs.depth.shape
    dev = obs.depth.device
    stride = max(1, int(np.ceil(np.sqrt(H * W / max_points))))
    depth = obs.depth[::stride, ::stride]
    h, w = depth.shape
    fx, fy = obs.intrinsics[0, 0], obs.intrinsics[1, 1]
    cx, cy = obs.intrinsics[0, 2], obs.intrinsics[1, 2]
    v, u = torch.meshgrid(torch.arange(h, device=dev) * stride, torch.arange(w, device=dev) * stride,
                          indexing="ij")
    z = depth
    pts_cam = torch.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], dim=-1).reshape(-1, 3)
    valid = (z > 0).reshape(-1)
    p0, q0 = obs.pose.position, obs.pose.quaternion

    def residuals(delta):
        # batched quaternions: their components stay 1-d (see `_aa_quat`)
        dq = _aa_quat(delta[3:])
        Rm = qm.quat_to_matrix(qm.quat_multiply(dq[None], q0[None]))[0]
        pts_w = torch.einsum("ij,nj->ni", Rm, pts_cam) + (p0 + delta[:3])
        val, inb = _sample_trilinear(cfg, grid.tsdf, pts_w)
        wgt, _ = _sample_trilinear(cfg, grid.weight, pts_w)
        # only residuals inside the truncation band carry geometry
        m = valid & inb & (wgt > 0) & (val.abs() < cfg.truncation * 0.99)
        return torch.where(m, val, 0.0)

    jac_fn = torch.func.jacfwd(residuals)
    eye = torch.eye(6, dtype=torch.float32, device=dev)
    delta = torch.zeros(6, dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        r = residuals(delta)
        J = jac_fn(delta)  # (N, 6)
        Hm = J.T @ J + 1e-6 * eye
        delta = delta - step * torch.linalg.solve(Hm, J.T @ r)
    return Pose(p0 + delta[:3], qm.quat_multiply(_aa_quat(delta[3:]), q0))


class Mapper:
    """Mapper state and config behind the JAX package's `Mapper` surface
    (integrate / compute_esdf / render / refine_pose / decay / stamp /
    get_voxel_grid / save & load).

    storage="sparse" backs the map with the block-sparse pool
    (`block_sparse.py`): camera integration touches only the observed surface
    band; dense reads (`grid`, ESDF, render) are rasterized from the pool over
    this config's dims/origin window on demand. ``device=None`` is the CUDA
    device (raises when there is none)."""

    def __init__(self, cfg: MapperConfig = MapperConfig(), storage: str = "dense", device=None):
        if storage not in ("dense", "sparse"):
            raise ValueError(f"storage must be 'dense' or 'sparse', got {storage!r}")
        self.cfg = cfg
        self.storage = storage
        self.device = resolve_device(device)
        self._sparse = None
        if storage == "sparse":
            from curobo_tpu_torch.perception.block_sparse import BlockSparseConfig, BlockSparseMapper

            self._sparse = BlockSparseMapper(
                BlockSparseConfig(
                    voxel_size=cfg.voxel_size, truncation=cfg.truncation,
                    max_weight=cfg.max_weight, occupancy_threshold=cfg.occupancy_threshold,
                    rgb_channels=cfg.rgb_channels, feature_channels=cfg.feature_channels,
                ),
                device=self.device,
            )
        self._dense_grid = make_grid(cfg, self.device) if storage == "dense" else None

    @property
    def grid(self) -> TSDFGrid:
        """Dense view of the map (rasterized from the pool in sparse mode)."""
        if self.storage == "sparse":
            return self._sparse.extract_dense(self.cfg.dims, self.cfg.origin)
        return self._dense_grid

    @grid.setter
    def grid(self, value: TSDFGrid) -> None:
        if self.storage == "sparse":
            raise AttributeError(
                "sparse-backed Mapper: the dense grid is a rasterized view; "
                "mutate through integrate()/decay()/load()"
            )
        self._dense_grid = value

    def reset(self):
        if self.storage == "sparse":
            self._sparse.reset()
        else:
            self._dense_grid = make_grid(self.cfg, self.device)

    def integrate(self, obs, carve: bool = True) -> None:
        if self.storage == "sparse":
            if not isinstance(obs, CameraObservation):
                raise TypeError(
                    "sparse-backed Mapper integrates CameraObservation only; "
                    "use storage='dense' for LiDAR carving"
                )
            self._sparse.integrate(obs)
            return
        if isinstance(obs, CameraObservation):
            self.grid = integrate_camera(self.cfg, self.grid, obs)
        elif isinstance(obs, LidarObservation):
            fn = integrate_lidar if carve else integrate_lidar_points
            self.grid = fn(self.cfg, self.grid, obs)
        else:
            raise TypeError(f"unsupported observation type {type(obs)}")

    def integrate_set(self, observations) -> None:
        """Integrate a multi-camera rig frame: one fused pool pass in sparse
        storage, the cameras in turn in dense storage."""
        if self.storage == "sparse":
            self._sparse.integrate_set(observations)
            return
        for o in observations:
            self.integrate(o)

    def decay(self, factor: float = 0.95) -> None:
        if self.storage == "sparse":
            self._sparse.decay(factor)
        else:
            self.grid = decay(self.cfg, self.grid, factor)

    def stamp(self, world) -> None:
        if self.storage == "sparse":
            raise TypeError(
                "sparse-backed Mapper: obstacle stamping operates on the "
                "dense grid; use storage='dense'"
            )
        self.grid = stamp_obstacles(self.cfg, self.grid, world)

    def compute_esdf(self) -> torch.Tensor:
        return compute_esdf(self.cfg, self.grid)

    def render_depth(self, intrinsics, pose, shape, **kw) -> torch.Tensor:
        return render_depth(self.cfg, self.grid, intrinsics, pose, shape, **kw)

    def refine_pose(self, obs: CameraObservation, **kw) -> Pose:
        return refine_camera_pose(self.cfg, self.grid, obs, **kw)

    def query_rgb(self, pts: torch.Tensor) -> torch.Tensor:
        """Trilinear RGB at world points (..., 3)."""
        grid = self.grid
        if grid.rgb is None:
            raise ValueError("mapper built without rgb_channels")
        return torch.stack([_sample_trilinear(self.cfg, grid.rgb[..., c], pts)[0]
                            for c in range(3)], dim=-1)

    def get_voxel_grid(self, name: str = "esdf") -> VoxelGridObstacle:
        """The ESDF as a planning-world obstacle. The mapper's origin is voxel
        (0,0,0)'s centre; a `VoxelGridObstacle` centres its grid on its pose."""
        cfg = self.cfg
        esdf = self.compute_esdf().cpu().numpy()
        dims_m = tuple(d * cfg.voxel_size for d in cfg.dims)
        center = tuple(cfg.origin[i] + (cfg.dims[i] - 1) * cfg.voxel_size / 2.0 for i in range(3))
        return VoxelGridObstacle(name=name, pose=[*center, 1.0, 0.0, 0.0, 0.0], dims=dims_m,
                                 voxel_size=cfg.voxel_size, data=esdf)

    def stats(self) -> dict:
        """Storage statistics (sparse: pool occupancy and drop counters;
        dense: grid footprint)."""
        if self.storage == "sparse":
            return self._sparse.stats()
        g = self._dense_grid
        arrays = [a for a in (g.tsdf, g.weight, g.rgb, g.feature) if a is not None]
        return {"dims": tuple(self.cfg.dims),
                "bytes": int(sum(a.numel() * a.element_size() for a in arrays))}

    # ---- checkpoints: the JAX mapper's .npz format, metadata validated ----
    def save(self, path: str) -> None:
        if self.storage == "sparse":
            self._sparse.save(path)
            return
        g = self.grid
        extra = {}
        if g.rgb is not None:
            extra["rgb"] = g.rgb.cpu().numpy()
        if g.feature is not None:
            extra["feature"] = g.feature.cpu().numpy()
        np.savez_compressed(
            path, tsdf=g.tsdf.cpu().numpy(), weight=g.weight.cpu().numpy(),
            dims=np.asarray(self.cfg.dims), voxel_size=self.cfg.voxel_size,
            origin=np.asarray(self.cfg.origin), **extra,
        )

    def load(self, path: str) -> None:
        if self.storage == "sparse":
            self._sparse.load(path)
            return
        d = np.load(path)
        if tuple(int(x) for x in d["dims"]) != tuple(self.cfg.dims):
            raise ValueError(f"checkpoint dims {tuple(d['dims'])} != mapper dims {self.cfg.dims}")
        if abs(float(d["voxel_size"]) - self.cfg.voxel_size) > 1e-9:
            raise ValueError(
                f"checkpoint voxel_size {float(d['voxel_size'])} != "
                f"mapper voxel_size {self.cfg.voxel_size}"
            )
        if not np.allclose(np.asarray(d["origin"]), np.asarray(self.cfg.origin)):
            raise ValueError("checkpoint origin mismatch")

        def t(a):
            return torch.as_tensor(np.asarray(a), device=self.device)

        self.grid = TSDFGrid(t(d["tsdf"]), t(d["weight"]),
                             rgb=t(d["rgb"]) if "rgb" in d else None,
                             feature=t(d["feature"]) if "feature" in d else None)
