"""Defensive input validation at public API boundaries.

Counterpart of `curobo_tpu/util/checks.py`: fail fast at the Python boundary
with the argument's name and the expectation spelled out, before anything
reaches a kernel (a raw CUDA kernel fed a wrong-shaped tensor corrupts
memory). Accepts torch tensors and numpy arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _dtype_kind(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bool:
            return "b"
        return "f" if dtype.is_floating_point else "i"
    return np.dtype(dtype).kind


def check_array(
    name: str,
    x,
    *,
    shape: Optional[Sequence[Optional[int]]] = None,
    ndim: Optional[Tuple[int, ...]] = None,
    last_dim: Optional[int] = None,
    kind: Optional[str] = None,  # 'f' float, 'i' int, 'b' bool
):
    """Validate an array-like argument; raises ValueError naming it.

    shape: expected dims, None entries are wildcards (e.g. (None, 7)).
    ndim: acceptable ranks. last_dim: required trailing dimension.
    """
    if x is None:
        raise ValueError(f"{name} is required (got None)")
    if not hasattr(x, "shape"):
        try:
            x = np.asarray(x)
        except Exception:
            raise ValueError(f"{name} is not array-like (got {type(x).__name__})")
    if ndim is not None and x.ndim not in ndim:
        raise ValueError(
            f"{name} must have rank {' or '.join(map(str, ndim))}, "
            f"got shape {tuple(x.shape)}"
        )
    if shape is not None:
        ok = len(x.shape) == len(shape) and all(
            want is None or got == want for got, want in zip(x.shape, shape)
        )
        if not ok:
            want_s = "(" + ", ".join("*" if w is None else str(w) for w in shape) + ")"
            raise ValueError(f"{name} must have shape {want_s}, got {tuple(x.shape)}")
    if last_dim is not None and (x.ndim == 0 or x.shape[-1] != last_dim):
        raise ValueError(
            f"{name} must have trailing dimension {last_dim}, got shape {tuple(x.shape)}"
        )
    if kind is not None:
        k = _dtype_kind(x.dtype)
        names = {"f": "floating", "i": "integer", "b": "boolean"}
        if k != kind and not (kind == "i" and k == "u"):
            raise ValueError(
                f"{name} must be {names.get(kind, kind)}, got dtype {x.dtype}"
            )
    return x


def check_joint_config(name: str, q, n_dof: int):
    """(…, n_dof) float configuration array."""
    q = check_array(name, q, last_dim=n_dof, kind="f")
    return q


def check_pose_batch(name: str, pose):
    """A `Pose` whose position/quaternion agree in batch shape."""
    pos = check_array(f"{name}.position", pose.position, last_dim=3, kind="f")
    quat = check_array(f"{name}.quaternion", pose.quaternion, last_dim=4, kind="f")
    if tuple(pos.shape[:-1]) != tuple(quat.shape[:-1]):
        raise ValueError(
            f"{name}: position batch {tuple(pos.shape[:-1])} != "
            f"quaternion batch {tuple(quat.shape[:-1])}"
        )
    if pos.ndim < 2:
        raise ValueError(
            f"{name} must be batched (shape (B, 3)/(B, T, 3)/(B, G, T, 3)), "
            f"got position shape {tuple(pos.shape)}"
        )
    return pose
