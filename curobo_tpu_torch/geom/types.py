"""Host-side obstacle types and Scene container.

Own copy of `curobo_tpu/geom/types.py`. These are plain Python dataclasses
used to *describe* a world; `curobo_tpu_torch.geom.world.compile_scene` turns
a Scene into the fixed-shape device tables used by collision queries.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from curobo_tpu_torch.util.config_io import load_yaml, write_yaml


@dataclasses.dataclass
class Obstacle:
    name: str
    # world pose: [x, y, z, qw, qx, qy, qz]
    pose: Sequence[float] = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)
    enabled: bool = True


@dataclasses.dataclass
class Cuboid(Obstacle):
    dims: Sequence[float] = (0.1, 0.1, 0.1)  # full extents x, y, z


@dataclasses.dataclass
class SphereObstacle(Obstacle):
    radius: float = 0.1


@dataclasses.dataclass
class Capsule(Obstacle):
    radius: float = 0.1
    # endpoints in the obstacle's local frame
    base: Sequence[float] = (0.0, 0.0, 0.0)
    tip: Sequence[float] = (0.0, 0.0, 0.1)


@dataclasses.dataclass
class Cylinder(Obstacle):
    radius: float = 0.1
    height: float = 0.2


@dataclasses.dataclass
class MeshObstacle(Obstacle):
    file_path: str = ""
    scale: Sequence[float] = (1.0, 1.0, 1.0)
    # voxelization resolution used when baking the mesh to an SDF grid
    voxel_size: float = 0.02
    vertices: Optional[np.ndarray] = None  # (V, 3) alternative to file_path
    faces: Optional[np.ndarray] = None  # (F, 3) int


@dataclasses.dataclass
class VoxelGridObstacle(Obstacle):
    """Dense ESDF voxel grid (e.g. produced by the perception mapper)."""

    dims: Sequence[float] = (1.0, 1.0, 1.0)  # metric extents
    voxel_size: float = 0.05
    # SDF values, shape inferred from dims/voxel_size; +10 = far/free
    data: Optional[np.ndarray] = None


@dataclasses.dataclass
class PointCloudObstacle(Obstacle):
    """Point cloud voxelized into a dense SDF grid at compile time
    (parity: reference point-cloud-to-voxel world entry,
    `curobo/_src/geom/types.py:736`)."""

    points: Optional[np.ndarray] = None  # (N, 3), obstacle-local frame
    point_radius: float = 0.01
    voxel_size: float = 0.02  # bake resolution


@dataclasses.dataclass
class Scene:
    """A named collection of obstacles (the planning world description).

    Parity: reference `SceneCfg` (`geom/types.py`), public `curobo.scene`.
    """

    name: str = "scene"
    obstacles: List[Obstacle] = dataclasses.field(default_factory=list)

    # -- edit ----------------------------------------------------------
    def add(self, *obstacles: Obstacle) -> "Scene":
        for o in obstacles:
            if any(e.name == o.name for e in self.obstacles):
                raise ValueError(f"obstacle {o.name!r} already in scene")
            self.obstacles.append(o)
        return self

    def remove(self, name: str) -> "Scene":
        before = len(self.obstacles)
        self.obstacles = [o for o in self.obstacles if o.name != name]
        if len(self.obstacles) == before:
            raise ValueError(f"obstacle {name!r} not in scene")
        return self

    def get(self, name: str) -> Obstacle:
        for o in self.obstacles:
            if o.name == name:
                return o
        raise ValueError(f"obstacle {name!r} not in scene")

    def by_type(self, cls) -> List[Obstacle]:
        return [o for o in self.obstacles if type(o) is cls]

    # -- io ------------------------------------------------------------
    def to_dict(self) -> dict:
        out = {"name": self.name, "obstacles": []}
        for o in self.obstacles:
            d = {"type": type(o).__name__, "name": o.name, "pose": list(map(float, o.pose))}
            if isinstance(o, Cuboid):
                d["dims"] = list(map(float, o.dims))
            elif isinstance(o, SphereObstacle):
                d["radius"] = float(o.radius)
            elif isinstance(o, Capsule):
                d.update(radius=float(o.radius), base=list(map(float, o.base)), tip=list(map(float, o.tip)))
            elif isinstance(o, Cylinder):
                d.update(radius=float(o.radius), height=float(o.height))
            elif isinstance(o, MeshObstacle):
                d.update(file_path=o.file_path, scale=list(map(float, o.scale)), voxel_size=float(o.voxel_size))
            out["obstacles"].append(d)
        return out

    def save(self, path: str) -> None:
        write_yaml(self.to_dict(), path)

    @staticmethod
    def from_dict(d: dict) -> "Scene":
        # Accept both this framework's format and the reference YAML world
        # format ({"cuboid": {name: {dims, pose}}, ...}) as data.
        scene = Scene(name=d.get("name", "scene"))
        if "obstacles" in d:
            ctor = {
                "Cuboid": Cuboid,
                "SphereObstacle": SphereObstacle,
                "Capsule": Capsule,
                "Cylinder": Cylinder,
                "MeshObstacle": MeshObstacle,
            }
            for od in d["obstacles"]:
                od = dict(od)
                cls = ctor[od.pop("type")]
                scene.add(cls(**od))
            return scene
        for name, spec in (d.get("cuboid") or {}).items():
            scene.add(Cuboid(name=name, pose=spec["pose"], dims=spec["dims"]))
        for name, spec in (d.get("sphere") or {}).items():
            scene.add(
                SphereObstacle(
                    name=name,
                    pose=list(spec.get("position", spec.get("pose", [0, 0, 0])[:3]))
                    + [1.0, 0.0, 0.0, 0.0],
                    radius=spec["radius"],
                )
            )
        for name, spec in (d.get("capsule") or {}).items():
            scene.add(
                Capsule(
                    name=name, pose=spec["pose"], radius=spec["radius"],
                    base=spec.get("base", (0, 0, 0)), tip=spec.get("tip", (0, 0, 0.1)),
                )
            )
        for name, spec in (d.get("cylinder") or {}).items():
            scene.add(
                Cylinder(name=name, pose=spec["pose"], radius=spec["radius"], height=spec["height"])
            )
        for name, spec in (d.get("mesh") or {}).items():
            scene.add(MeshObstacle(name=name, pose=spec["pose"], file_path=spec.get("file_path", "")))
        return scene

    @staticmethod
    def from_yaml(path: str) -> "Scene":
        return Scene.from_dict(load_yaml(path))
