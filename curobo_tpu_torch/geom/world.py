"""Device-side collision world: fixed-shape obstacle tables + batched queries.

Counterpart of `curobo_tpu/geom/world.py`: every obstacle type is a padded
struct-of-arrays with an ``enabled`` mask, and each dense SDF grid (an ESDF
from a depth camera: `VoxelGridObstacle`) is one `VoxelGridData`, sampled
trilinearly. Mesh and point-cloud obstacles are baked into such grids on the
host when the scene is compiled (`geom/mesh.py`), as in the JAX package. `stack_worlds`
adds a leading axis (one world per MPC tick or environment); `world_at`
slices it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from curobo_tpu_torch.geom import sdf as sdf_mod
from curobo_tpu_torch.geom import types as gt
from curobo_tpu_torch.math import quaternion as qm

BIG = 1.0e6


@dataclasses.dataclass(frozen=True)
class CuboidData:
    rot: torch.Tensor  # (N, 3, 3) obstacle->world
    pos: torch.Tensor  # (N, 3)
    half_dims: torch.Tensor  # (N, 3)
    enabled: torch.Tensor  # (N,) float 0/1
    names: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SphereData:
    center: torch.Tensor  # (N, 3)
    radius: torch.Tensor  # (N,)
    enabled: torch.Tensor
    names: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class CapsuleData:
    rot: torch.Tensor
    pos: torch.Tensor
    base: torch.Tensor  # (N, 3) local endpoint
    tip: torch.Tensor  # (N, 3) local endpoint
    radius: torch.Tensor
    enabled: torch.Tensor
    names: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class CylinderData:
    rot: torch.Tensor
    pos: torch.Tensor
    radius: torch.Tensor
    half_height: torch.Tensor
    enabled: torch.Tensor
    names: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class VoxelGridData:
    """Dense SDF grid: ``data[x, y, z]`` is the signed distance at the voxel's
    centre; ``origin`` is the grid-frame position of voxel (0, 0, 0)'s centre;
    the pose maps grid -> world."""

    rot: torch.Tensor  # (3, 3)
    pos: torch.Tensor  # (3,)
    origin: torch.Tensor  # (3,)
    cell_size: torch.Tensor  # () scalar
    data: torch.Tensor  # (X, Y, Z)
    enabled: torch.Tensor  # () scalar 0/1
    name: str = ""


@dataclasses.dataclass(frozen=True)
class WorldData:
    cuboids: CuboidData
    spheres: SphereData
    capsules: CapsuleData
    cylinders: CylinderData
    voxel_grids: Tuple[VoxelGridData, ...] = ()

    @property
    def device(self) -> torch.device:
        return self.cuboids.pos.device

    # -- updates (return a new WorldData; tables are copied, not aliased) --
    def _type_of(self, name: str):
        for field in ("cuboids", "spheres", "capsules", "cylinders"):
            store = getattr(self, field)
            if name in store.names:
                return field, store.names.index(name)
        for i, vg in enumerate(self.voxel_grids):
            if vg.name == name:
                return "voxel_grids", i
        raise ValueError(f"obstacle {name!r} not in world")

    def _with_grid(self, idx: int, **fields) -> "WorldData":
        grids = list(self.voxel_grids)
        grids[idx] = dataclasses.replace(grids[idx], **fields)
        return dataclasses.replace(self, voxel_grids=tuple(grids))

    def update_obstacle_pose(self, name: str, position, quaternion) -> "WorldData":
        field, idx = self._type_of(name)
        dev = self.device
        R = qm.quat_to_matrix(torch.as_tensor(quaternion, dtype=torch.float32, device=dev))
        p = torch.as_tensor(position, dtype=torch.float32, device=dev)
        if field == "voxel_grids":
            return self._with_grid(idx, rot=R, pos=p)
        store = getattr(self, field)
        if field == "spheres":
            center = store.center.clone()
            center[idx] = p
            store = dataclasses.replace(store, center=center)
        else:
            rot, pos = store.rot.clone(), store.pos.clone()
            rot[idx], pos[idx] = R, p
            store = dataclasses.replace(store, rot=rot, pos=pos)
        return dataclasses.replace(self, **{field: store})

    def enable_obstacle(self, name: str, enabled: bool) -> "WorldData":
        field, idx = self._type_of(name)
        if field == "voxel_grids":
            return self._with_grid(idx, enabled=torch.tensor(
                1.0 if enabled else 0.0, device=self.device))
        store = getattr(self, field)
        en = store.enabled.clone()
        en[idx] = 1.0 if enabled else 0.0
        return dataclasses.replace(self, **{field: dataclasses.replace(store, enabled=en)})

    def update_voxel_data(self, name: str, data: torch.Tensor) -> "WorldData":
        """Swap the SDF contents of a voxel grid (the perception feed path)."""
        field, idx = self._type_of(name)
        if field != "voxel_grids":
            raise ValueError(f"{name!r} is not a voxel grid")
        vg = self.voxel_grids[idx]
        if tuple(data.shape) != tuple(vg.data.shape):
            raise ValueError(
                f"voxel data shape {tuple(data.shape)} != grid shape {tuple(vg.data.shape)}"
            )
        return self._with_grid(idx, data=torch.as_tensor(data, dtype=vg.data.dtype,
                                                         device=vg.data.device))


# ---------------------------------------------------------------------------
# Scene -> WorldData compilation
# ---------------------------------------------------------------------------
def _pose_Rp(pose) -> Tuple[np.ndarray, np.ndarray]:
    pose = np.asarray(pose, dtype=np.float32)
    w, x, y, z = pose[3:7] / max(np.linalg.norm(pose[3:7]), 1e-9)
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )
    return R, pose[:3]


def _pad(n: int, cap: Optional[int]) -> int:
    if cap is not None:
        if cap < n:
            raise ValueError(f"capacity {cap} < obstacle count {n}")
        return cap
    return n


def compile_scene(
    scene: gt.Scene,
    capacities: Optional[Dict[str, int]] = None,
    device=None,
    dtype=torch.float32,
) -> WorldData:
    """Bake a host Scene into the fixed-shape device world.

    ``capacities`` optionally over-allocates per type ({"cuboid": 32, ...})
    so obstacles can be added later by enabling padded slots.
    ``device=None`` is the CUDA device (raises when there is none).
    """
    from curobo_tpu_torch.runtime import resolve_device

    device = resolve_device(device)
    caps = capacities or {}

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    # Cuboids
    cubs = scene.by_type(gt.Cuboid)
    n_cub = _pad(len(cubs), caps.get("cuboid"))
    rot = np.tile(np.eye(3, dtype=np.float32), (n_cub, 1, 1))
    pos = np.full((n_cub, 3), BIG, dtype=np.float32)
    half = np.full((n_cub, 3), 0.01, dtype=np.float32)
    en = np.zeros((n_cub,), dtype=np.float32)
    names = []
    for i, o in enumerate(cubs):
        rot[i], pos[i] = _pose_Rp(o.pose)
        half[i] = np.asarray(o.dims, dtype=np.float32) / 2.0
        en[i] = float(o.enabled)
        names.append(o.name)
    names += [f"_cuboid_slot_{i}" for i in range(len(cubs), n_cub)]
    cuboids = CuboidData(tensor(rot), tensor(pos), tensor(half), tensor(en), tuple(names))

    # Spheres
    sphs = scene.by_type(gt.SphereObstacle)
    n_sph = _pad(len(sphs), caps.get("sphere"))
    c = np.full((n_sph, 3), BIG, dtype=np.float32)
    r = np.full((n_sph,), 0.01, dtype=np.float32)
    en = np.zeros((n_sph,), dtype=np.float32)
    names = []
    for i, o in enumerate(sphs):
        _, c[i] = _pose_Rp(o.pose)
        r[i] = o.radius
        en[i] = float(o.enabled)
        names.append(o.name)
    names += [f"_sphere_slot_{i}" for i in range(len(sphs), n_sph)]
    spheres = SphereData(tensor(c), tensor(r), tensor(en), tuple(names))

    # Capsules
    capsl = scene.by_type(gt.Capsule)
    n_cap = _pad(len(capsl), caps.get("capsule"))
    rot = np.tile(np.eye(3, dtype=np.float32), (n_cap, 1, 1))
    pos = np.full((n_cap, 3), BIG, dtype=np.float32)
    base = np.zeros((n_cap, 3), dtype=np.float32)
    tip = np.tile(np.asarray([0, 0, 0.01], dtype=np.float32), (n_cap, 1))
    r = np.full((n_cap,), 0.01, dtype=np.float32)
    en = np.zeros((n_cap,), dtype=np.float32)
    names = []
    for i, o in enumerate(capsl):
        rot[i], pos[i] = _pose_Rp(o.pose)
        base[i] = np.asarray(o.base, dtype=np.float32)
        tip[i] = np.asarray(o.tip, dtype=np.float32)
        r[i] = o.radius
        en[i] = float(o.enabled)
        names.append(o.name)
    names += [f"_capsule_slot_{i}" for i in range(len(capsl), n_cap)]
    capsules = CapsuleData(
        tensor(rot), tensor(pos), tensor(base), tensor(tip), tensor(r), tensor(en),
        tuple(names),
    )

    # Cylinders
    cyls = scene.by_type(gt.Cylinder)
    n_cyl = _pad(len(cyls), caps.get("cylinder"))
    rot = np.tile(np.eye(3, dtype=np.float32), (n_cyl, 1, 1))
    pos = np.full((n_cyl, 3), BIG, dtype=np.float32)
    r = np.full((n_cyl,), 0.01, dtype=np.float32)
    hh = np.full((n_cyl,), 0.01, dtype=np.float32)
    en = np.zeros((n_cyl,), dtype=np.float32)
    names = []
    for i, o in enumerate(cyls):
        rot[i], pos[i] = _pose_Rp(o.pose)
        r[i] = o.radius
        hh[i] = o.height / 2.0
        en[i] = float(o.enabled)
        names.append(o.name)
    names += [f"_cylinder_slot_{i}" for i in range(len(cyls), n_cyl)]
    cylinders = CylinderData(
        tensor(rot), tensor(pos), tensor(r), tensor(hh), tensor(en), tuple(names)
    )

    # Voxel grids, centred on the obstacle pose
    grids = []
    for o in scene.by_type(gt.VoxelGridObstacle):
        R, p = _pose_Rp(o.pose)
        shape = tuple(int(round(d / o.voxel_size)) for d in o.dims)
        data = (np.asarray(o.data, dtype=np.float32) if o.data is not None
                else np.full(shape, 10.0, dtype=np.float32))
        origin = -(np.asarray(o.dims, dtype=np.float32) / 2.0) + o.voxel_size / 2.0
        grids.append(VoxelGridData(
            tensor(R), tensor(p), tensor(origin), tensor(o.voxel_size), tensor(data),
            tensor(float(o.enabled)), o.name,
        ))
    # Meshes and point clouds bake to SDF grids in the obstacle's frame on the
    # host (`geom/mesh.py`), then take the voxel-grid route
    from curobo_tpu_torch.geom import mesh as mesh_mod

    for cls, bake in ((gt.MeshObstacle, mesh_mod.mesh_to_sdf_grid),
                      (gt.PointCloudObstacle, mesh_mod.points_to_sdf_grid)):
        for o in scene.by_type(cls):
            sdf_grid, origin, cell = bake(o)
            R, p = _pose_Rp(o.pose)
            grids.append(VoxelGridData(
                tensor(R), tensor(p), tensor(origin), tensor(cell), tensor(sdf_grid),
                tensor(float(o.enabled)), o.name,
            ))

    return WorldData(cuboids, spheres, capsules, cylinders, tuple(grids))


def empty_world(device=None) -> WorldData:
    return compile_scene(gt.Scene(), device=device)


def _map_store(fn, stores):
    """fn over each tensor field of one store (one per world); the names
    come from the first."""
    return dataclasses.replace(stores[0], **{
        f.name: fn(*(getattr(s, f.name) for s in stores))
        for f in dataclasses.fields(stores[0]) if f.name not in ("names", "name")
    })


def _map_tables(fn, *worlds: WorldData) -> WorldData:
    """Apply fn to each obstacle table's tensors (one per world); names come
    from the first world."""
    w0 = worlds[0]
    stores = {field: _map_store(fn, [getattr(w, field) for w in worlds])
              for field in ("cuboids", "spheres", "capsules", "cylinders")}
    grids = tuple(_map_store(fn, list(gs)) for gs in zip(*(w.voxel_grids for w in worlds)))
    return dataclasses.replace(w0, voxel_grids=grids, **stores)


def stack_worlds(worlds) -> WorldData:
    """Stack worlds along a leading axis (one world per tick or environment).

    All worlds must share capacities (compile the scenes with the same
    ``capacities``); obstacle names are taken from the first. `world_at`
    slices one world back out, on the device.
    """
    worlds = list(worlds)
    if not worlds:
        raise ValueError("stack_worlds: no worlds given")
    if any(len(w.voxel_grids) != len(worlds[0].voxel_grids) for w in worlds):
        raise ValueError("worlds must hold the same number of voxel grids to stack")

    def stack(*ts):
        if any(t.shape != ts[0].shape for t in ts):
            raise ValueError(
                "worlds must share obstacle capacities/types to stack "
                "(compile with the same `capacities`)"
            )
        return torch.stack(ts)

    return _map_tables(stack, *worlds)


def world_at(worlds: WorldData, t: int) -> WorldData:
    """World t of a `stack_worlds` stack (views, no copy)."""
    return _map_tables(lambda a: a[t], worlds)


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------
def sphere_sdf(world: WorldData, x: torch.Tensor) -> torch.Tensor:
    """Min signed distance from query points to all obstacles.

    x: (..., S, 3) -> (..., S). Differentiable; disabled/padded obstacles
    contribute +BIG.
    """
    parts = []

    if world.cuboids.pos.shape[0] > 0:
        cb = world.cuboids
        # (..., S, N, 3) local points: R^T (x - p)
        xl = torch.einsum("nji,...snj->...sni", cb.rot, x[..., None, :] - cb.pos)
        d = sdf_mod.sdf_box(xl, cb.half_dims)
        parts.append(torch.where(cb.enabled > 0, d, BIG))

    if world.spheres.center.shape[0] > 0:
        sp = world.spheres
        d = sdf_mod.sdf_sphere(x[..., None, :], sp.center, sp.radius)
        parts.append(torch.where(sp.enabled > 0, d, BIG))

    if world.capsules.pos.shape[0] > 0:
        cp = world.capsules
        a = (cp.rot @ cp.base[..., None])[..., 0] + cp.pos
        b = (cp.rot @ cp.tip[..., None])[..., 0] + cp.pos
        d = sdf_mod.sdf_capsule(x[..., None, :], a, b, cp.radius)
        parts.append(torch.where(cp.enabled > 0, d, BIG))

    if world.cylinders.pos.shape[0] > 0:
        cy = world.cylinders
        xl = torch.einsum("nji,...snj->...sni", cy.rot, x[..., None, :] - cy.pos)
        d = sdf_mod.sdf_cylinder(xl, cy.radius, cy.half_height)
        parts.append(torch.where(cy.enabled > 0, d, BIG))

    for vg in world.voxel_grids:
        xl = torch.einsum("ji,...sj->...si", vg.rot, x - vg.pos)
        d = sdf_mod.sample_voxel_grid(vg.data, xl, vg.origin, vg.cell_size, outside_value=10.0)
        parts.append(torch.where(vg.enabled > 0, d, BIG)[..., None])

    if not parts:
        return torch.full(x.shape[:-1], BIG, dtype=x.dtype, device=x.device)
    return torch.cat(parts, dim=-1).amin(dim=-1)


def sphere_clearance(world: WorldData, spheres: torch.Tensor) -> torch.Tensor:
    """Signed clearance (sdf - radius) for robot spheres (..., S, 4)."""
    return sphere_sdf(world, spheres[..., :3]) - spheres[..., 3]


def collision_cost(
    world: WorldData, spheres: torch.Tensor, activation_distance: float = 0.025
) -> torch.Tensor:
    """Per-sphere activated penetration cost (..., S): max(0, activation -
    clearance), zero for disabled robot spheres (negative radius)."""
    clearance = sphere_clearance(world, spheres)
    live = spheres[..., 3] >= 0
    return torch.where(live, (activation_distance - clearance).clamp_min(0.0),
                       torch.zeros_like(clearance))
