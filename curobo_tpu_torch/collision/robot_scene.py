"""Robot-vs-scene collision convenience API.

Counterpart of `curobo_tpu/collision/robot_scene.py`: joint-space distance
queries and batched sample/validate/validate_trajectory, and
`AttachmentManager`, which fills the robot's reserved sphere slots with a
grasped object (new params: a solver built from them builds its kernels'
tables from the new spheres and margins).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from curobo_tpu_torch.geom import world as world_mod
from curobo_tpu_torch.geom.self_collision import self_collision_distance
from curobo_tpu_torch.robot import kinematics as kin_mod
from curobo_tpu_torch.robot.params import KinematicsParams
from curobo_tpu_torch.util.sampling import halton_sequence


@dataclasses.dataclass(frozen=True)
class CollisionQueryResult:
    """Per-config distances."""

    scene_clearance: torch.Tensor  # (...,) min signed clearance to the world
    self_violation: torch.Tensor  # (...,) max self-collision violation (0 = clear)
    in_collision: torch.Tensor  # (...,) bool (scene or self)
    out_of_bounds: torch.Tensor  # (...,) bool
    valid: torch.Tensor  # (...,) bool: collision-free and inside limits


class RobotSceneCollision:
    """Joint-space collision queries against a world (plain PyTorch ops on
    the device the robot parameters live on)."""

    def __init__(self, params: KinematicsParams, margin: float = 0.0):
        self.params = params
        self.margin = margin

    def query(self, world: world_mod.WorldData, q: torch.Tensor) -> CollisionQueryResult:
        """q (..., D) -> per-config result (trajectories fold into batch)."""
        p = self.params
        st = kin_mod.compute_kinematics(p, q)
        clear = world_mod.sphere_clearance(world, st.spheres)
        live = st.spheres[..., 3] >= 0
        min_clear = torch.where(live, clear, torch.full_like(clear, 1.0e6)).amin(dim=-1)
        self_v = self_collision_distance(p.self_collision, st.spheres)
        lim = p.joint_limits
        oob = torch.any((q < lim.lower) | (q > lim.upper), dim=-1)
        in_col = (min_clear < self.margin) | (self_v > 0)
        return CollisionQueryResult(
            scene_clearance=min_clear,
            self_violation=self_v,
            in_collision=in_col,
            out_of_bounds=oob,
            valid=~(in_col | oob),
        )

    def validate(self, world: world_mod.WorldData, q: torch.Tensor) -> torch.Tensor:
        """bool per config."""
        return self.query(world, q).valid

    def validate_trajectory(
        self, world: world_mod.WorldData, traj_q: torch.Tensor, substeps: int = 4
    ) -> torch.Tensor:
        """(..., H, D) -> (...,) bool: every step and `substeps` interpolated
        configurations before it are valid."""
        prev = torch.cat([traj_q[..., :1, :], traj_q[..., :-1, :]], dim=-2)
        alphas = torch.linspace(1.0 / substeps, 1.0, substeps, dtype=traj_q.dtype,
                                device=traj_q.device)[:, None, None]
        interp = prev[..., None, :, :] * (1 - alphas) + traj_q[..., None, :, :] * alphas
        ok = self.query(world, interp).valid  # (..., K, H)
        return ok.all(dim=-1).all(dim=-1)

    def sample(
        self, world: world_mod.WorldData, n: int, max_attempts: int = 10
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Collision-free config sampling: (configs (n, D), valid (n,)),
        Halton-sampled configs with a validity mask; deterministic."""
        p = self.params
        dev = p.device
        lo = p.joint_limits.lower.detach().cpu().numpy()
        hi = p.joint_limits.upper.detach().cpu().numpy()
        lo_c = np.maximum(lo, -np.pi)
        hi_c = np.minimum(hi, np.pi)
        out = np.zeros((n, p.n_dof), dtype=np.float32)
        ok = np.zeros(n, dtype=bool)
        skip = 11
        got = 0
        for attempt in range(max_attempts):
            h = halton_sequence(n, p.n_dof, skip=skip + attempt * n)
            q_np = (lo_c + (hi_c - lo_c) * h).astype(np.float32)
            valid = self.validate(world, torch.as_tensor(q_np, device=dev)).cpu().numpy()
            take = np.where(valid)[0]
            k = min(len(take), n - got)
            out[got : got + k] = q_np[take[:k]]
            ok[got : got + k] = True
            got += k
            if got >= n:
                break
        return torch.as_tensor(out, device=dev), torch.as_tensor(ok, device=dev)


class AttachmentManager:
    """Attach and detach grasped objects as extra collision spheres.

    The robot model reserves disabled placeholder spheres on a link
    (``extra_collision_spheres`` in the robot YAML); attaching fills them and
    recomputes the self-collision margins. Every call returns new params and
    leaves the given ones untouched; the tensors stay on their device.
    """

    def __init__(self, params: KinematicsParams, link_name: str = "attached_object"):
        self.base_params = params
        self.link_name = link_name
        li = params.link_names.index(link_name)
        self._slots = [i for i, l in enumerate(params.sphere_link_idx) if l == li]
        if not self._slots:
            raise ValueError(f"link {link_name!r} has no reserved collision sphere slots")

    @property
    def n_slots(self) -> int:
        return len(self._slots)

    @staticmethod
    def _set(params: KinematicsParams, idx, centers, radii) -> KinematicsParams:
        dev = params.device
        c = params.sphere_centers.clone()
        r = params.sphere_radii.clone()
        idx = torch.as_tensor(idx, dtype=torch.long, device=dev)
        c[idx] = torch.as_tensor(centers, dtype=c.dtype, device=dev)
        r[idx] = torch.as_tensor(radii, dtype=r.dtype, device=dev)
        params = params.update_spheres(c, r)
        return dataclasses.replace(
            params, self_collision=params.self_collision.recompute_margins(r)
        )

    def attach_spheres(self, params: KinematicsParams, centers, radii) -> KinematicsParams:
        """centers (K, 3) in the attach-link frame, radii (K,), K <= n_slots."""
        K = centers.shape[0]
        if K > len(self._slots):
            raise ValueError(f"{K} spheres > {len(self._slots)} reserved slots")
        return self._set(params, self._slots[:K], centers, radii)

    def attach_box(self, params: KinematicsParams, half_dims, offset=(0.0, 0.0, 0.0)) -> KinematicsParams:
        """Approximate a box payload with the reserved spheres along its
        longest axis (cheap sphere fit)."""
        h = np.asarray(half_dims, dtype=np.float32)
        n = len(self._slots)
        axis = int(np.argmax(h))
        r = float(np.sqrt(sum(h[i] ** 2 for i in range(3) if i != axis) + 1e-12))
        span = max(h[axis] - r, 0.0)
        ts = np.linspace(-span, span, n) if n > 1 else np.zeros(1)
        centers = np.tile(np.asarray(offset, dtype=np.float32), (n, 1))
        centers[:, axis] += ts
        return self.attach_spheres(params, centers, np.full((n,), r, dtype=np.float32))

    def detach(self, params: KinematicsParams) -> KinematicsParams:
        n = len(self._slots)
        return self._set(params, self._slots, np.zeros((n, 3), np.float32),
                         np.full((n,), -10.0, np.float32))
