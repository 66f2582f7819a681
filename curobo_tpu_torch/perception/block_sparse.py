"""Block-sparse TSDF: a fixed pool of voxel blocks behind an open-address
spatial hash table.

Counterpart of `curobo_tpu/perception/block_sparse.py`, with the same state
bit for bit: a pool of `pool_blocks` blocks of `block_size`^3 voxels and a
power-of-two table of `table_size` slots mapping encoded block coordinates to
pool slots (Fibonacci hash, `_MAX_PROBE` linear probes). Lookups are
vectorised over query points on the device.

Inserts differ in design, not in result. The JAX package inserts every
candidate key in a sequential device loop; here the keys already in the table
are dropped by one vectorised lookup, and only the new keys are inserted, in
ascending order, on a host copy of the table (`_insert_new`). A key already in
the table is a no-op in the JAX loop and two distinct keys never match each
other, so the table, the pool coordinates and both counters come out the same.

The deduplicated candidate set keeps JAX's order and truncation: keys sorted
ascending with the empty sentinel (-1) first, cut to the budget, padded with
the sentinel (`_unique_padded`). Allocation runs on the decoded set as in the
JAX package, where the sentinel decodes to block (511, 511, 511), a valid key:
that block is allocated whenever the set holds a sentinel and some key is new.

Per frame, only the active blocks (those of the observed truncation band that
hold a pool slot) are gathered, updated and written back; the fill entries of
the JAX package's static-size compactions are never computed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from curobo_tpu_torch.perception.mapper import TSDFGrid, _to_i32, project
from curobo_tpu_torch.perception.types import CameraObservation
from curobo_tpu_torch.runtime import resolve_device

# block coords live in [-COORD_OFF, COORD_OFF); 10 bits per axis
_COORD_OFF = 512
_FREE = -1  # hash-slot "empty" sentinel (valid keys are >= 0)
_MAX_PROBE = 16
_HASH_K = 2654435761  # Knuth's multiplicative constant


@dataclasses.dataclass(frozen=True)
class BlockSparseConfig:
    block_size: int = 8  # voxels per block side
    pool_blocks: int = 2048  # block capacity
    table_size: int = 8192  # hash slots (power of two, >= 2*pool_blocks)
    voxel_size: float = 0.02
    truncation: float = 0.06
    max_weight: float = 64.0
    occupancy_threshold: float = 0.0
    # dedup budget of the candidate blocks of one camera frame
    max_new_blocks_per_frame: int = 1024
    # active-set cap of the fused multi-camera path; 0 = the rig's dedup budget
    max_active_blocks: int = 0
    # depth-image subsample stride for block discovery
    discovery_stride: int = 4
    # appearance accumulators, stored per pool block
    rgb_channels: bool = False
    feature_channels: int = 0

    def __post_init__(self):
        if self.table_size & (self.table_size - 1):
            raise ValueError("table_size must be a power of two")
        if self.table_size < 2 * self.pool_blocks:
            raise ValueError("table_size must be >= 2 * pool_blocks")

    @property
    def block_extent(self) -> float:
        return self.block_size * self.voxel_size


@dataclasses.dataclass(frozen=True)
class BlockSparseTSDF:
    """Block-sparse mapper state (the JAX package's fields and dtypes)."""

    table_key: torch.Tensor  # (T,) int32 encoded block coord or _FREE
    table_slot: torch.Tensor  # (T,) int32 pool index
    pool_coords: torch.Tensor  # (P, 3) int32 block coords of each pool slot
    n_alloc: torch.Tensor  # () int32 allocated blocks
    dropped_blocks: torch.Tensor  # () int32 candidates dropped at capacity
    # () int32 frame-active blocks beyond max_active_blocks (fused path): they
    # received no update that frame
    dropped_active: torch.Tensor
    tsdf: torch.Tensor  # (P, b, b, b) f32
    weight: torch.Tensor  # (P, b, b, b) f32
    rgb: Optional[torch.Tensor] = None  # (P, b, b, b, 3) f32 weighted mean
    feature: Optional[torch.Tensor] = None  # (P, b, b, b, F) f32

    @property
    def nbytes(self) -> int:
        arrays = (self.table_key, self.table_slot, self.pool_coords, self.tsdf, self.weight,
                  self.rgb, self.feature)
        return int(sum(a.numel() * a.element_size() for a in arrays if a is not None))


def make_sparse_grid(cfg: BlockSparseConfig, device=None) -> BlockSparseTSDF:
    dev = resolve_device(device)
    b, P, T = cfg.block_size, cfg.pool_blocks, cfg.table_size

    def i32(v, shape=()):
        return torch.full(shape, v, dtype=torch.int32, device=dev)

    return BlockSparseTSDF(
        table_key=i32(_FREE, (T,)), table_slot=i32(-1, (T,)), pool_coords=i32(0, (P, 3)),
        n_alloc=i32(0), dropped_blocks=i32(0), dropped_active=i32(0),
        tsdf=torch.full((P, b, b, b), cfg.truncation, dtype=torch.float32, device=dev),
        weight=torch.zeros((P, b, b, b), dtype=torch.float32, device=dev),
        rgb=torch.zeros((P, b, b, b, 3), dtype=torch.float32, device=dev) if cfg.rgb_channels else None,
        feature=(torch.zeros((P, b, b, b, cfg.feature_channels), dtype=torch.float32, device=dev)
                 if cfg.feature_channels > 0 else None),
    )


# ---------------------------------------------------------------------------
# hash table
# ---------------------------------------------------------------------------
def _encode(bc: torch.Tensor) -> torch.Tensor:
    """Block coords (..., 3) int -> encoded key (...,) int64. Out-of-range
    coords map to _FREE (never matched, never inserted)."""
    bc = bc.long()
    inb = ((bc >= -_COORD_OFF) & (bc < _COORD_OFF)).all(dim=-1)
    x, y, z = (bc + _COORD_OFF).unbind(-1)
    key = (x << 20) | (y << 10) | z
    return torch.where(inb, key, _FREE)


def _decode(key: torch.Tensor) -> torch.Tensor:
    """Encoded key (...,) -> block coords (..., 3); _FREE decodes to (511,
    511, 511), as the JAX package's arithmetic shift gives."""
    key = key.long()
    return torch.stack([(key >> 20) & 1023, (key >> 10) & 1023, key & 1023], dim=-1) - _COORD_OFF


def _hash(keys: torch.Tensor, table_size: int) -> torch.Tensor:
    """Fibonacci hash -> [0, table_size), in uint32 arithmetic with
    wrap-around, computed in int64 (the product split in two 16-bit halves of
    the constant so that no intermediate leaves int64)."""
    tbits = table_size.bit_length() - 1
    u = keys.long() & 0xFFFFFFFF
    u = u ^ (u >> 16)
    lo = u * (_HASH_K & 0xFFFF)
    hi = ((u * (_HASH_K >> 16)) & 0xFFFF) << 16
    u = (lo + hi) & 0xFFFFFFFF
    return u >> (32 - tbits)


def _lookup(cfg: BlockSparseConfig, grid: BlockSparseTSDF, keys: torch.Tensor) -> torch.Tensor:
    """Vectorised probe: keys (...,) -> pool slot (...,) int64 or -1."""
    mask = cfg.table_size - 1
    keys = keys.long()
    h0 = _hash(keys, cfg.table_size)
    slot = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    tk, ts = grid.table_key.long(), grid.table_slot.long()
    for i in range(_MAX_PROBE):
        idx = (h0 + i) & mask
        hit = (tk[idx] == keys) & (keys != _FREE) & (slot < 0)
        slot = torch.where(hit, ts[idx], slot)
    return slot


def _unique_padded(keys: torch.Tensor, size: int) -> torch.Tensor:
    """`jnp.unique(keys, size=size, fill_value=_FREE)`: the sorted distinct
    keys (the sentinel first when present), cut to `size`, padded with the
    sentinel."""
    u = torch.unique(keys.long(), sorted=True)[:size]
    if u.numel() < size:
        u = torch.cat([u, u.new_full((size - u.numel(),), _FREE)])
    return u


def _insert_new(cfg: BlockSparseConfig, grid: BlockSparseTSDF, new_keys: torch.Tensor) -> BlockSparseTSDF:
    """Insert distinct keys that are not in the table, in the given order, on
    a host copy of the table: each takes the first free slot of its probe
    sequence and the next pool slot, or is dropped when neither is left."""
    if new_keys.numel() == 0:
        return grid
    dev = grid.table_key.device
    mask = cfg.table_size - 1
    keys = new_keys.cpu().tolist()
    h0s = _hash(new_keys, cfg.table_size).cpu().tolist()
    tk = grid.table_key.cpu().numpy().copy()
    ts = grid.table_slot.cpu().numpy().copy()
    pc = grid.pool_coords.cpu().numpy().copy()
    n, dropped = int(grid.n_alloc), int(grid.dropped_blocks)
    for key, h0 in zip(keys, h0s):
        free = next((idx for idx in ((h0 + p) & mask for p in range(_MAX_PROBE))
                     if tk[idx] == _FREE), None)
        if free is None or n >= cfg.pool_blocks:
            dropped += 1
            continue
        tk[free], ts[free] = key, n
        pc[n] = ((key >> 20) & 1023, (key >> 10) & 1023, key & 1023)
        pc[n] -= _COORD_OFF
        n += 1

    def i32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)

    return dataclasses.replace(grid, table_key=i32(tk), table_slot=i32(ts), pool_coords=i32(pc),
                               n_alloc=i32(n), dropped_blocks=i32(dropped))


def allocate_blocks(cfg: BlockSparseConfig, grid: BlockSparseTSDF, block_coords: torch.Tensor
                    ) -> BlockSparseTSDF:
    """Insert candidate block coords (N, 3) (duplicates fine) into the table,
    with the JAX package's result: the distinct keys in ascending order."""
    uniq = _unique_padded(_encode(block_coords), block_coords.shape[0])
    live = uniq != _FREE
    new = live & (_lookup(cfg, grid, uniq) < 0)
    return _insert_new(cfg, grid, uniq[new])


def _allocate_if_new(cfg: BlockSparseConfig, grid: BlockSparseTSDF, uniq: torch.Tensor
                     ) -> BlockSparseTSDF:
    """The JAX integrators' allocation step: skipped unless the frame saw a
    new block (one host read), then run on the decoded candidate set."""
    pre = _lookup(cfg, grid, uniq)
    if not bool(((pre < 0) & (uniq != _FREE)).any()):
        return grid
    return allocate_blocks(cfg, grid, _decode(uniq))


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------
def _discover_blocks(cfg: BlockSparseConfig, obs: CameraObservation) -> torch.Tensor:
    """Candidate block coords (M, 3) from a depth frame: a pixel subsample
    back-projected at the surface and +- truncation along each ray."""
    s = cfg.discovery_stride
    depth = obs.depth[::s, ::s]
    h, w = depth.shape
    dev = depth.device
    fx, fy = obs.intrinsics[0, 0], obs.intrinsics[1, 1]
    cx, cy = obs.intrinsics[0, 2], obs.intrinsics[1, 2]
    v, u = torch.meshgrid(torch.arange(h, device=dev) * s, torch.arange(w, device=dev) * s,
                          indexing="ij")
    z = depth.reshape(-1)
    ray = torch.stack([(u.reshape(-1) - cx) / fx, (v.reshape(-1) - cy) / fy, torch.ones_like(z)],
                      dim=-1)
    valid = z > 0
    pc = torch.cat([ray * torch.where(valid, z + dz, -1e6)[:, None]
                    for dz in (-cfg.truncation, 0.0, cfg.truncation)], dim=0)
    pw = obs.pose.transform_points(pc[None])[0]
    return _to_i32(torch.floor(pw / cfg.block_extent))


def _block_centers(cfg: BlockSparseConfig, coords: torch.Tensor) -> torch.Tensor:
    """Voxel centres (A*b^3, 3) of blocks with coords (A, 3)."""
    b = cfg.block_size
    offs = (torch.arange(b, device=coords.device).to(torch.float32) + 0.5) * cfg.voxel_size
    ox, oy, oz = torch.meshgrid(offs, offs, offs, indexing="ij")
    local = torch.stack([ox, oy, oz], dim=-1)
    centers = coords.to(torch.float32)[:, None, None, None, :] * cfg.block_extent + local[None]
    return centers.reshape(-1, 3)


def _pixel_table(obs: CameraObservation, rgb: bool, feat: bool) -> torch.Tensor:
    """Depth (+ rgb) (+ features) as one (H*W, C) table, gathered once."""
    H, W = obs.depth.shape
    cols = [obs.depth.reshape(H * W, 1)]
    if rgb:
        cols.append(obs.rgb.reshape(H * W, 3))
    if feat:
        cols.append(obs.feature.reshape(H * W, -1))
    return torch.cat(cols, dim=-1)


class _Payload:
    """The active blocks' voxels, gathered from the pool; fused camera by
    camera, then written back."""

    def __init__(self, cfg, grid, slots, want_rgb, want_feat):
        self.cfg, self.grid, self.slots = cfg, grid, slots
        self.flat = _block_centers(cfg, grid.pool_coords[slots])
        self.t = grid.tsdf[slots].reshape(-1)
        self.w = grid.weight[slots].reshape(-1)
        self.rgb = grid.rgb[slots].reshape(-1, 3) if want_rgb else None
        self.feat = grid.feature[slots].reshape(-1, grid.feature.shape[-1]) if want_feat else None

    def fuse(self, obs: CameraObservation, o_rgb: bool, o_feat: bool) -> None:
        cfg = self.cfg
        H, W = obs.depth.shape
        z, flat_px, in_img = project(obs.pose, obs.intrinsics, self.flat, H, W)
        gath = _pixel_table(obs, o_rgb, o_feat)[flat_px]
        d = gath[:, 0]
        sdf = d - z
        update = in_img & (d > 0) & (sdf > -cfg.truncation)
        tsdf_new = sdf.clamp(-cfg.truncation, cfg.truncation)
        w_new = update.to(torch.float32)
        w_sum = self.w + w_new
        denom = w_sum.clamp_min(1e-6)
        self.t = torch.where(w_sum > 0, (self.t * self.w + tsdf_new * w_new) / denom, self.t)
        if o_rgb or o_feat:
            band = (update & (sdf.abs() <= cfg.truncation))[:, None]
            c0 = 1
            if o_rgb:
                self.rgb = torch.where(
                    band, (self.rgb * self.w[:, None] + gath[:, 1:4] * w_new[:, None]) / denom[:, None],
                    self.rgb)
                c0 = 4
            if o_feat:
                self.feat = torch.where(
                    band, (self.feat * self.w[:, None] + gath[:, c0:] * w_new[:, None]) / denom[:, None],
                    self.feat)
        self.w = w_sum.clamp_max(cfg.max_weight)

    def write(self) -> BlockSparseTSDF:
        g, s = self.grid, self.slots
        b = self.cfg.block_size
        blk = (s.numel(), b, b, b)

        def put(pool, vals, tail=()):
            out = pool.clone()
            out[s] = vals.reshape(blk + tail)
            return out

        out = dataclasses.replace(g, tsdf=put(g.tsdf, self.t), weight=put(g.weight, self.w))
        if self.rgb is not None:
            out = dataclasses.replace(out, rgb=put(g.rgb, self.rgb, (3,)))
        if self.feat is not None:
            out = dataclasses.replace(out, feature=put(g.feature, self.feat, (g.feature.shape[-1],)))
        return out


def integrate_camera_sparse(cfg: BlockSparseConfig, grid: BlockSparseTSDF, obs: CameraObservation
                            ) -> BlockSparseTSDF:
    """Allocate blocks in the observed band, then run the voxel-centric
    projective update (dense `mapper.integrate_camera` semantics with RGB and
    feature fusion) over the frame-active blocks only."""
    uniq = _unique_padded(_encode(_discover_blocks(cfg, obs)), cfg.max_new_blocks_per_frame)
    grid = _allocate_if_new(cfg, grid, uniq)
    slots = _lookup(cfg, grid, uniq)
    slots = slots[(uniq != _FREE) & (slots >= 0)]
    want_rgb = grid.rgb is not None and obs.rgb is not None
    want_feat = grid.feature is not None and obs.feature is not None
    pay = _Payload(cfg, grid, slots, want_rgb, want_feat)
    pay.fuse(obs, want_rgb, want_feat)
    return pay.write()


def integrate_cameras_sparse(cfg: BlockSparseConfig, grid: BlockSparseTSDF, observations
                             ) -> BlockSparseTSDF:
    """Fused multi-camera integrate: one discovery and allocation over the
    rig, one payload gather and write-back, the cameras fused in turn.

    The rig's dedup budget is n_cameras * max_new_blocks_per_frame; distinct
    candidates past it add to `dropped_blocks`. The active pool slots are
    taken in ascending slot order up to `max_active_blocks`; the rest get no
    update that frame and add to `dropped_active`. Both counters zero means
    the result equals integrating the cameras one after another."""
    observations = list(observations)
    keys = _encode(torch.cat([_discover_blocks(cfg, o) for o in observations], dim=0))
    U = len(observations) * cfg.max_new_blocks_per_frame
    uniq = _unique_padded(keys, U)
    dedup_overflow = max(int(torch.unique(keys).numel()) - U, 0)
    grid = _allocate_if_new(cfg, grid, uniq)
    grid = dataclasses.replace(grid, dropped_blocks=grid.dropped_blocks + dedup_overflow)

    P = cfg.pool_blocks
    A = cfg.max_active_blocks or U
    uslot = _lookup(cfg, grid, uniq)
    mask = torch.zeros(P, dtype=torch.bool, device=uslot.device)
    mask[uslot[uslot >= 0]] = True
    slots = torch.nonzero(mask).reshape(-1)
    grid = dataclasses.replace(grid, dropped_active=grid.dropped_active + max(slots.numel() - A, 0))
    slots = slots[:A]

    # per-camera appearance flags: a camera without rgb/features skips only
    # its own appearance fuse
    want_rgb = grid.rgb is not None and any(o.rgb is not None for o in observations)
    want_feat = grid.feature is not None and any(o.feature is not None for o in observations)
    pay = _Payload(cfg, grid, slots, want_rgb, want_feat)
    for obs in observations:
        pay.fuse(obs, want_rgb and obs.rgb is not None, want_feat and obs.feature is not None)
    return pay.write()


# ---------------------------------------------------------------------------
# queries / export
# ---------------------------------------------------------------------------
def _fetch(cfg, grid, vi: torch.Tensor):
    """Pool slot (or -1) and the intra-block index of integer voxel coords."""
    b = cfg.block_size
    bc = torch.div(vi, b, rounding_mode="floor")
    li = vi - bc * b
    slot = _lookup(cfg, grid, _encode(bc))
    return slot, li


def sample_sdf_sparse(cfg: BlockSparseConfig, grid: BlockSparseTSDF, pts: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear TSDF at world points (..., 3) -> (values, observed). Each of
    the 8 corners does its own hash lookup; unobserved corners contribute
    +truncation and clear `observed`."""
    g = pts / cfg.voxel_size - 0.5  # voxel centres at (i + .5) * vs
    i0 = _to_i32(torch.floor(g)).long()
    f = g - i0
    total, obs_all = 0, None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                vi = i0 + torch.tensor([dx, dy, dz], device=pts.device)
                slot, li = _fetch(cfg, grid, vi)
                ok = slot >= 0
                s = torch.where(ok, slot, 0)
                val = grid.tsdf[s, li[..., 0], li[..., 1], li[..., 2]]
                wgt = grid.weight[s, li[..., 0], li[..., 1], li[..., 2]]
                seen = ok & (wgt > 0)
                val = torch.where(seen, val, cfg.truncation)
                wx = f[..., 0] if dx == 1 else 1 - f[..., 0]
                wy = f[..., 1] if dy == 1 else 1 - f[..., 1]
                wz = f[..., 2] if dz == 1 else 1 - f[..., 2]
                total = total + val * wx * wy * wz
                obs_all = seen if obs_all is None else (obs_all & seen)
    return total, obs_all


def extract_dense(cfg: BlockSparseConfig, grid: BlockSparseTSDF, dims: Tuple[int, int, int],
                  origin: Tuple[float, float, float]) -> TSDFGrid:
    """Rasterize a region to a dense `mapper.TSDFGrid` (voxel (0,0,0) centre
    at `origin`), the nearest pool voxel at each centre."""
    dev = grid.tsdf.device
    axes = [torch.arange(dims[k], device=dev).to(torch.float32) * cfg.voxel_size + origin[k]
            for k in range(3)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    vi = _to_i32(torch.round(pts / cfg.voxel_size - 0.5)).long()
    slot, li = _fetch(cfg, grid, vi)
    ok = slot >= 0
    s = torch.where(ok, slot, 0)
    at = (s, li[..., 0], li[..., 1], li[..., 2])
    rgb = feat = None
    if grid.rgb is not None:
        rgb = torch.where(ok[..., None], grid.rgb[at], 0.0)
    if grid.feature is not None:
        feat = torch.where(ok[..., None], grid.feature[at], 0.0)
    return TSDFGrid(tsdf=torch.where(ok, grid.tsdf[at], cfg.truncation),
                    weight=torch.where(ok, grid.weight[at], 0.0), rgb=rgb, feature=feat)


def decay_sparse(cfg: BlockSparseConfig, grid: BlockSparseTSDF, factor: float) -> BlockSparseTSDF:
    """EMA weight decay over the pool. Blocks are not freed (the pool is
    append-only for the life of the map); dead voxels reset to unobserved."""
    w = grid.weight * factor
    dead = w < 1e-3
    return dataclasses.replace(grid, tsdf=torch.where(dead, cfg.truncation, grid.tsdf),
                               weight=torch.where(dead, 0.0, w))


class BlockSparseMapper:
    """Block-sparse storage behind the `Mapper` surface. ``device=None`` is
    the CUDA device (raises when there is none)."""

    def __init__(self, cfg: BlockSparseConfig = BlockSparseConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.grid = make_sparse_grid(cfg, self.device)

    def reset(self):
        self.grid = make_sparse_grid(self.cfg, self.device)

    def integrate(self, obs: CameraObservation) -> None:
        self.grid = integrate_camera_sparse(self.cfg, self.grid, obs)

    def integrate_set(self, observations) -> None:
        """Fused multi-camera integrate (one pool pass for the whole rig)."""
        self.grid = integrate_cameras_sparse(self.cfg, self.grid, observations)

    def decay(self, factor: float = 0.95) -> None:
        self.grid = decay_sparse(self.cfg, self.grid, factor)

    def sample_sdf(self, pts: torch.Tensor):
        return sample_sdf_sparse(self.cfg, self.grid, pts)

    def extract_dense(self, dims, origin) -> TSDFGrid:
        return extract_dense(self.cfg, self.grid, dims, origin)

    def stats(self) -> dict:
        return {
            "allocated_blocks": int(self.grid.n_alloc),
            "pool_blocks": self.cfg.pool_blocks,
            "dropped_blocks": int(self.grid.dropped_blocks),
            "dropped_active": int(self.grid.dropped_active),
            "bytes": self.grid.nbytes,
        }

    # ---- checkpoints: the JAX mapper's .npz format, metadata validated ----
    def save(self, path: str) -> None:
        g = self.grid
        extra = {}
        if g.rgb is not None:
            extra["rgb"] = g.rgb.cpu().numpy()
        if g.feature is not None:
            extra["feature"] = g.feature.cpu().numpy()
        np.savez_compressed(
            path, table_key=g.table_key.cpu().numpy(), table_slot=g.table_slot.cpu().numpy(),
            pool_coords=g.pool_coords.cpu().numpy(), n_alloc=g.n_alloc.cpu().numpy(),
            dropped=g.dropped_blocks.cpu().numpy(), dropped_active=g.dropped_active.cpu().numpy(),
            tsdf=g.tsdf.cpu().numpy(), weight=g.weight.cpu().numpy(),
            block_size=self.cfg.block_size, voxel_size=self.cfg.voxel_size, **extra,
        )

    def load(self, path: str) -> None:
        d = np.load(path)
        if int(d["block_size"]) != self.cfg.block_size:
            raise ValueError(
                f"checkpoint block_size {int(d['block_size'])} != {self.cfg.block_size}"
            )
        if abs(float(d["voxel_size"]) - self.cfg.voxel_size) > 1e-9:
            raise ValueError("checkpoint voxel_size mismatch")
        if d["tsdf"].shape != tuple(self.grid.tsdf.shape):
            raise ValueError(
                f"checkpoint pool shape {d['tsdf'].shape} != {tuple(self.grid.tsdf.shape)}"
            )
        self.grid = block_sparse_from_arrays(
            {k: d[k] for k in d.files if k not in ("block_size", "voxel_size")}, self.device)


def block_sparse_from_arrays(d: dict, device) -> BlockSparseTSDF:
    """A `BlockSparseTSDF` from numpy arrays under the checkpoint's names
    (`dropped` for `dropped_blocks`; `dropped_active` optional)."""
    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return BlockSparseTSDF(
        table_key=t(d["table_key"], torch.int32), table_slot=t(d["table_slot"], torch.int32),
        pool_coords=t(d["pool_coords"], torch.int32), n_alloc=t(d["n_alloc"], torch.int32),
        dropped_blocks=t(d["dropped"], torch.int32),
        dropped_active=t(d.get("dropped_active", 0), torch.int32),
        tsdf=t(d["tsdf"], torch.float32), weight=t(d["weight"], torch.float32),
        rgb=t(d["rgb"], torch.float32) if "rgb" in d else None,
        feature=t(d["feature"], torch.float32) if "feature" in d else None,
    )
