"""State carried across from the JAX package: its `KinematicsParams`,
`WorldData` and mapper states (`TSDFGrid`, `BlockSparseTSDF`), given as
dictionaries of numpy arrays and static fields (the dataclass fields passed
through `np.asarray`), become this package's.

The package loads the same YAML itself (`Kinematics.from_robot_yaml`,
`compile_scene`); these converters exist so that a model or a world built by
the JAX package can be handed over without going through files.
"""

from __future__ import annotations

import numpy as np
import torch

from curobo_tpu_torch.geom import world as world_mod
from curobo_tpu_torch.robot.params import JointLimits, KinematicsParams, SelfCollisionParams
from curobo_tpu_torch.runtime import resolve_device

_PARAM_TENSORS = (
    "fixed_rot", "fixed_pos", "joint_axis", "mimic_mult", "mimic_offset",
    "sphere_centers", "sphere_radii", "retract_config", "cspace_weight",
    "null_space_weight", "link_mass", "link_com", "link_inertia",
)
_PARAM_STATIC = (
    "link_names", "joint_names", "parent_idx", "joint_type", "dof_idx",
    "sphere_link_idx", "tool_frame_names", "tool_frame_idx",
)


def _tensor(a, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def kinematics_params_from_numpy(d: dict, device=None) -> KinematicsParams:
    """d: field name -> numpy array / static value of the JAX package's
    `KinematicsParams`, with `joint_limits` and `self_collision` as nested
    dictionaries."""
    device = resolve_device(device)
    lim = d["joint_limits"]
    sc = d["self_collision"]
    return KinematicsParams(
        **{k: _tensor(d[k], device) for k in _PARAM_TENSORS},
        joint_limits=JointLimits(
            **{
                k: _tensor(lim[k], device)
                for k in ("lower", "upper", "velocity", "acceleration", "jerk", "effort")
            }
        ),
        self_collision=SelfCollisionParams(
            pair_a=_tensor(sc["pair_a"], device, torch.int32),
            pair_b=_tensor(sc["pair_b"], device, torch.int32),
            pair_margin=_tensor(sc["pair_margin"], device),
            pair_buffer=_tensor(sc["pair_buffer"], device),
        ),
        **{k: tuple(d[k]) for k in _PARAM_STATIC},
        levels=tuple(tuple(lv) for lv in d["levels"]),
        base_link=str(d["base_link"]),
        robot_name=str(d["robot_name"]),
    )


def world_from_numpy(d: dict, device=None) -> world_mod.WorldData:
    """d: 'cuboids' / 'spheres' / 'capsules' / 'cylinders' -> dictionaries of
    the JAX package's per-type stores (arrays + names); 'voxel_grids' -> a
    list of dictionaries, one per grid (arrays + name)."""
    device = resolve_device(device)

    def store(cls, src, fields):
        return cls(
            **{k: _tensor(src[k], device) for k in fields},
            names=tuple(src.get("names", ())),
        )

    return world_mod.WorldData(
        cuboids=store(world_mod.CuboidData, d["cuboids"], ("rot", "pos", "half_dims", "enabled")),
        spheres=store(world_mod.SphereData, d["spheres"], ("center", "radius", "enabled")),
        capsules=store(
            world_mod.CapsuleData, d["capsules"],
            ("rot", "pos", "base", "tip", "radius", "enabled"),
        ),
        cylinders=store(
            world_mod.CylinderData, d["cylinders"],
            ("rot", "pos", "radius", "half_height", "enabled"),
        ),
        voxel_grids=tuple(
            world_mod.VoxelGridData(
                **{k: _tensor(g[k], device)
                   for k in ("rot", "pos", "origin", "cell_size", "data", "enabled")},
                name=str(g.get("name", "")),
            )
            for g in d.get("voxel_grids", ())
        ),
    )


def tsdf_grid_from_numpy(d: dict, device=None):
    """d: the JAX package's `TSDFGrid` fields ('tsdf', 'weight', and 'rgb' /
    'feature' or None) -> this package's `TSDFGrid`."""
    from curobo_tpu_torch.perception.mapper import TSDFGrid

    device = resolve_device(device)

    def opt(k):
        return _tensor(d[k], device) if d.get(k) is not None else None

    return TSDFGrid(_tensor(d["tsdf"], device), _tensor(d["weight"], device),
                    rgb=opt("rgb"), feature=opt("feature"))


def block_sparse_from_numpy(d: dict, device=None):
    """d: the JAX package's `BlockSparseTSDF` fields (table, pool, counters;
    'rgb' / 'feature' or None) -> this package's `BlockSparseTSDF`."""
    from curobo_tpu_torch.perception.block_sparse import block_sparse_from_arrays

    arrays = {k: v for k, v in d.items() if v is not None and k != "dropped_blocks"}
    arrays["dropped"] = d["dropped_blocks"]
    return block_sparse_from_arrays(arrays, resolve_device(device))
