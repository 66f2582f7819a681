"""Device mesh: place the problems and seeds of a batch on a grid of devices.

Counterpart of `curobo_tpu/parallel/mesh.py`, whose layer shards the problems
axis (and, for IK, the seeds axis) over TPU chips with `jax.sharding`. Here a
mesh is a grid of `torch.device`s, (dp,) or (dp, sp), in which a device may
repeat: one H100 gives a 2 x 2 mesh of ``cuda:0``. The placement functions
cut a batch into the mesh's slices and move each to its device.

`solve_ik_sharded` keeps the JAX API and its results: each (B/dp, S/sp)
block of problems x seeds is solved on its device, and the block winners are
re-scored with the JAX package's selection rule. The blocks run ONE AFTER
ANOTHER (also when their devices differ); on one card this adds no speed
over the unsharded solve, only the launches of smaller blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from curobo_tpu_torch.runtime import resolve_device

BATCH_AXIS = "dp"
SEED_AXIS = "sp"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """`devices`: an object array of `torch.device`s, one axis per name."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _device_grid(devices, shape) -> np.ndarray:
    flat = [resolve_device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
    grid = np.empty(len(flat), dtype=object)
    grid[:] = flat
    return grid.reshape(shape)


def _visible_cuda_devices():
    resolve_device(None)  # raises where there is no CUDA device
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = BATCH_AXIS) -> DeviceMesh:
    """1-D data-parallel mesh over `devices` (default: every visible CUDA
    device; raises where there is none)."""
    devs = list(_visible_cuda_devices() if devices is None else devices)
    return DeviceMesh(_device_grid(devs, (len(devs),)), (axis_name,))


def make_mesh_2d(
    dp: int,
    sp: int,
    devices: Optional[Sequence] = None,
    dp_axis: str = BATCH_AXIS,
    sp_axis: str = SEED_AXIS,
) -> DeviceMesh:
    """2-D (problems, seeds) mesh over dp * sp devices, given flat or shaped
    (dp, sp); default: the first dp * sp visible CUDA devices."""
    devs = _visible_cuda_devices() if devices is None else list(
        np.asarray(devices, dtype=object).reshape(-1))
    if dp * sp > len(devs) or (devices is not None and dp * sp != len(devs)):
        raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} devices, have {len(devs)}")
    return DeviceMesh(_device_grid(devs[: dp * sp], (dp, sp)), (dp_axis, sp_axis))


def _tree_map(fn, tree):
    """fn over every tensor of a tensor, dataclass, dict, list or tuple."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _axis_positions(mesh: DeviceMesh, axis_name: str):
    """(index along `axis_name`, device) of every mesh position, in the
    mesh's order, and the axis's size."""
    ax = mesh.axis_names.index(axis_name)
    return [(idx[ax], mesh.devices[idx]) for idx in np.ndindex(mesh.devices.shape)], \
        mesh.devices.shape[ax]


def shard_problems(tree, mesh: DeviceMesh, axis_name: str = BATCH_AXIS) -> list:
    """One copy of `tree` per mesh position (in the mesh's order), each
    tensor cut along its leading axis into the `axis_name` slices and moved
    to the position's device. A 0-d tensor, or one whose leading axis does not
    divide evenly, is placed whole (replicated), as in the JAX package."""
    positions, n = _axis_positions(mesh, axis_name)

    def piece(k, dev):
        def place(x):
            if x.ndim == 0 or x.shape[0] % n:
                return x.to(dev)
            step = x.shape[0] // n
            return x[k * step:(k + 1) * step].to(dev)

        return _tree_map(place, tree)

    return [piece(k, dev) for k, dev in positions]


def replicate(tree, mesh: DeviceMesh) -> list:
    """One whole copy of `tree` per mesh position, on its device."""
    return [_tree_map(lambda x, d=dev: x.to(d), tree) for dev in mesh.devices.reshape(-1)]


def global_problems(tree, mesh: DeviceMesh, axis_name: str = BATCH_AXIS) -> list:
    """The JAX package's multi-host input assembly. This package runs in one
    process, whose batch is the whole batch, so this is `shard_problems`."""
    return shard_problems(tree, mesh, axis_name)


# ---------------------------------------------------------------------------
# 2-D problems x seeds blocks and the cross-block winner
# ---------------------------------------------------------------------------

_BIG = 1.0e6


def solve_ik_sharded(
    solver,
    world,
    goal,
    seeds: torch.Tensor,  # (B, S, D)
    generator: Optional[torch.Generator],
    mesh: DeviceMesh,
    dp_axis: str = BATCH_AXIS,
    sp_axis: str = SEED_AXIS,
):
    """IK solve with problems cut over `dp` and seeds over `sp`.

    Each mesh block runs the solve `IKSolver.solve_pose` would run (the
    kernel route where it applies) on its (B/dp, S/sp) seed slice, on its
    device, one block after another. The block winners are re-scored with the
    JAX package's rule (``success ? cost : 1e6 + position_error``, argmin over
    the seed blocks, the first on a tie), so the result matches an unsharded
    solve over the same seeds on the deterministic path (no particle stage):
    bit for bit wherever a seed converged; a problem that no seed solves takes
    the block winner of least position error. The particle stage of block
    (i, j) is keyed by one integer drawn from `generator` plus j (the JAX
    package folds the seed-block index into its key).

    Returns an `IKResult` on the mesh's first device, `seed_solutions` and
    `seed_success` in the seeds' order. Requires B % dp == 0 and S % sp == 0.
    """
    from curobo_tpu_torch.solver.ik import IKResult, IKSolver

    B, S, D = seeds.shape
    dp = mesh.shape[dp_axis]
    sp = mesh.shape[sp_axis]
    if B % dp or S % sp:
        raise ValueError(f"batch {B} / seeds {S} must divide mesh {dp}x{sp}")
    b, s = B // dp, S // sp
    base = int(torch.randint(0, 2**30, (1,), generator=generator,
                             device=None if generator is None else generator.device))
    axes = (mesh.axis_names.index(dp_axis), mesh.axis_names.index(sp_axis))
    out_dev = mesh.devices.reshape(-1)[0]
    solvers = {solver.device: solver}

    def cut(x, i, dev):
        return (x[i * b:(i + 1) * b] if x.ndim > 0 and x.shape[0] == B else x).to(dev)

    rows = []
    for i in range(dp):
        blocks = []
        for j in range(sp):
            idx = [0] * mesh.devices.ndim
            idx[axes[0]], idx[axes[1]] = i, j
            dev = mesh.devices[tuple(idx)]
            if dev not in solvers:
                solvers[dev] = IKSolver(solver.params, solver.cfg, device=dev)
            res = solvers[dev]._solve_seeds(
                _tree_map(lambda x: x.to(dev), world),
                _tree_map(lambda x: cut(x, i, dev), goal),
                seeds[i * b:(i + 1) * b, j * s:(j + 1) * s].to(dev),
                base + j,
            )
            blocks.append(_tree_map(lambda x: x.to(out_dev), res))
        score = torch.stack([torch.where(r.success, r.cost, _BIG + r.position_error)
                             for r in blocks])  # (sp, b)
        best = torch.argmin(score, dim=0)  # (b,), the first minimum

        def pick(name):
            xs = torch.stack([getattr(r, name) for r in blocks])  # (sp, b, ...)
            i_b = best.reshape((1, b) + (1,) * (xs.ndim - 2)).expand((1,) + xs.shape[1:])
            return torch.gather(xs, 0, i_b)[0]

        rows.append(IKResult(
            solution=pick("solution"),
            success=pick("success"),
            position_error=pick("position_error"),
            rotation_error=pick("rotation_error"),
            cost=pick("cost"),
            seed_solutions=torch.cat([r.seed_solutions for r in blocks], dim=1),
            seed_success=torch.cat([r.seed_success for r in blocks], dim=1),
        ))
    return IKResult(**{f.name: torch.cat([getattr(r, f.name) for r in rows], dim=0)
                       for f in dataclasses.fields(IKResult)})
