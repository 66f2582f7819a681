"""Recursive Newton-Euler inverse dynamics (Featherstone), batched PyTorch.

Counterpart of `curobo_tpu/robot/dynamics.py`: tau = ID(q, qd, qdd, gravity).
The velocities and accelerations run base -> tip over the links, one link at
a time (each needs its parent's); the inertial wrenches of all links are then
formed at once, and the forces run tip -> base, each link gathering its
children's. Mimic joints scale the joint rates and the torque written back
(`mimic_mult`), so two links driven by one dof both add to its torque, through
a fixed link -> dof matrix rather than an in-place write. Batched over any
leading axes; the gradient comes from autograd, as the JAX package's comes
from autodiff. The JAX package runs this as XLA, with no Pallas kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from curobo_tpu_torch.robot import kinematics as kin_mod
from curobo_tpu_torch.robot.params import (
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    KinematicsParams,
    dof_one_hot,
)

GRAVITY = (0.0, 0.0, -9.81)


@functools.lru_cache(maxsize=32)
def _dof_matrix(dof_idx: Tuple[int, ...], n_dof: int, device: torch.device) -> torch.Tensor:
    """(n_links, n_dof) one-hot of the dof that drives each link's joint,
    copied to `device` once per robot topology."""
    return torch.as_tensor(dof_one_hot(dof_idx, n_dof), device=device)


@functools.lru_cache(maxsize=8)
def _gravity(gravity: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """The gravity vector on `device`, copied there once: a host-to-device
    copy waits for the device's queue, and the torque term runs RNEA per
    evaluation."""
    return torch.tensor(gravity, dtype=torch.float32, device=device)


def _rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (R @ v[..., None])[..., 0]


def compute_inverse_dynamics(
    params: KinematicsParams,
    q: torch.Tensor,  # (..., D)
    qd: torch.Tensor,  # (..., D)
    qdd: torch.Tensor,  # (..., D)
    gravity=GRAVITY,
    external_wrench: Optional[torch.Tensor] = None,  # (..., L, 6) [force, torque], world frame
) -> torch.Tensor:
    """Joint torques (..., D)."""
    R_loc, p_loc = kin_mod._local_transforms(params, kin_mod.joint_values(params, q))
    RT_loc = R_loc.transpose(-1, -2)
    L = params.n_links
    jt = params.joint_type
    parents = params.parent_idx
    cross = torch.linalg.cross
    gather, rev, prism = kin_mod._index_tables(params.dof_idx, params.joint_type, q.device)
    dof_m = _dof_matrix(params.dof_idx, params.n_dof, q.device)
    # per-link joint rates, mimic-aware; 0 where no dof drives the link
    mult = params.mimic_mult * dof_m.sum(dim=-1)
    S = params.joint_axis  # (L, 3) in the link frame
    Sqd = S * (mult * qd[..., gather])[..., None]  # (..., L, 3)
    Sqdd = S * (mult * qdd[..., gather])[..., None]
    g = _gravity(tuple(float(x) for x in gravity), q.device).to(q.dtype)

    # ---- forward pass: base -> tip (link-frame quantities) ---------------
    w, al, a = [None] * L, [None] * L, [None] * L
    for i in range(L):
        RT = RT_loc[..., i, :, :]
        pi = parents[i]
        if pi < 0:  # the base accelerates upward (gravity trick), at rest
            w_in = al_in = torch.zeros_like(Sqd[..., i, :])
            a_in = _rotate(RT, -g)
        else:
            r = p_loc[..., i, :]
            w_p, al_p, a_p = w[pi], al[pi], a[pi]
            w_in = _rotate(RT, w_p)
            al_in = _rotate(RT, al_p)
            a_in = _rotate(RT, a_p + cross(al_p, r) + cross(w_p, cross(w_p, r)))
        if jt[i] == JOINT_REVOLUTE:
            w[i] = w_in + Sqd[..., i, :]
            al[i] = al_in + Sqdd[..., i, :] + cross(w_in, Sqd[..., i, :])
            a[i] = a_in
        elif jt[i] == JOINT_PRISMATIC:
            w[i], al[i] = w_in, al_in
            a[i] = a_in + Sqdd[..., i, :] + 2.0 * cross(w_in, Sqd[..., i, :])
        else:
            w[i], al[i], a[i] = w_in, al_in, a_in

    # inertial wrench of every link at its CoM, then about its origin
    W, AL, A = torch.stack(w, dim=-2), torch.stack(al, dim=-2), torch.stack(a, dim=-2)
    c = params.link_com.expand(W.shape)
    a_c = A + cross(AL, c) + cross(W, cross(W, c))
    Fc = params.link_mass[:, None] * a_c
    I = params.link_inertia
    Nc = _rotate(I, AL) + cross(W, _rotate(I, W))
    n_self = Nc + cross(c, Fc)
    if external_wrench is not None:
        Rw, _ = kin_mod.link_transforms(params, q)
        RwT = Rw.transpose(-1, -2)
        Fc = Fc - _rotate(RwT, external_wrench[..., :3])
        n_self = n_self - _rotate(RwT, external_wrench[..., 3:])

    # ---- backward pass: tip -> base ----------------------------------------
    children = [[] for _ in range(L)]
    for i in range(L):
        if parents[i] >= 0:
            children[parents[i]].append(i)
    f, n = [None] * L, [None] * L
    for i in range(L - 1, -1, -1):
        fi, ni = Fc[..., i, :], n_self[..., i, :]
        for ch in children[i]:
            f_ch = _rotate(R_loc[..., ch, :, :], f[ch])
            fi = fi + f_ch
            ni = ni + _rotate(R_loc[..., ch, :, :], n[ch]) + cross(p_loc[..., ch, :], f_ch)
        f[i], n[i] = fi, ni

    # joint torque of each link (revolute: about the axis; prismatic: along
    # it), scaled by its mimic multiplier and summed onto its dof
    F, N = torch.stack(f, dim=-2), torch.stack(n, dim=-2)
    t = rev * (N * S).sum(dim=-1) + prism * (F * S).sum(dim=-1)  # (..., L)
    return (t * mult) @ dof_m


class Dynamics:
    """Inverse dynamics of one robot. ``device=None`` is the CUDA device and
    raises when there is none."""

    def __init__(self, params: KinematicsParams, gravity=GRAVITY, device=None):
        from curobo_tpu_torch.runtime import resolve_device

        self.params = params.to(resolve_device(device))
        self.gravity = gravity

    def compute_inverse_dynamics(self, q, qd, qdd, external_wrench=None):
        return compute_inverse_dynamics(self.params, q, qd, qdd, self.gravity, external_wrench)

    def gravity_compensation(self, q):
        z = torch.zeros_like(q)
        return compute_inverse_dynamics(self.params, q, z, z, self.gravity)
