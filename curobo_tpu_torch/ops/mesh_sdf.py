"""Host library for mesh signed distances: `ops/csrc/mesh_sdf.cpp` (an AABB
tree with branch-and-bound closest-triangle queries and even-odd ray parity,
OpenMP over query points), built with `g++` at first use and loaded with
ctypes.

The library is built into the same directory as the CUDA libraries
(`ops/build.py:build_dir`), named after a hash of the source and the flags.
A missing source, a missing compiler, a failed build or a failed load
raises: nothing moves to the numpy bake on its own
(`geom/mesh.py:mesh_to_sdf_grid(..., plain=True)` is that bake, taken only
when the caller asks for it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

import numpy as np

from curobo_tpu_torch.ops.build import CSRC_DIR, build_dir

SOURCE = os.path.join(CSRC_DIR, "mesh_sdf.cpp")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def library_path(src: str) -> str:
    """Where the library of `src` is built: a hash of the source and flags."""
    with open(src, "rb") as fh:
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + fh.read()).hexdigest()[:16]
    return os.path.join(build_dir(), f"mesh_sdf-{h}.so")


def build_library(src: str) -> str:
    """Compile `src` unless its library exists; returns the library's path.
    Raises FileNotFoundError for a missing source or compiler, RuntimeError
    with the compiler's output for a failed build."""
    if not os.path.isfile(src):
        raise FileNotFoundError(f"mesh SDF source not found: {src}")
    out = library_path(src)
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found on PATH; the mesh SDF library cannot be built")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [gxx, *GXX_FLAGS, src, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {src} failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # concurrent builds converge on one file
    return out


def load_library(src: str = None) -> ctypes.CDLL:
    """The loaded library of `src` (default `SOURCE`), built first if needed."""
    src = os.path.abspath(src or SOURCE)
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = ctypes.CDLL(build_library(src))
            dbl_p = ctypes.POINTER(ctypes.c_double)
            i64, i64_p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            f32_p = ctypes.POINTER(ctypes.c_float)
            lib.curobo_mesh_sdf.argtypes = [dbl_p, i64, i64_p, i64, dbl_p, i64, f32_p]
            lib.curobo_mesh_sdf.restype = ctypes.c_int
            _libs[src] = lib
    return lib


def _as_c(verts: np.ndarray, faces: np.ndarray, points: np.ndarray):
    v = np.ascontiguousarray(verts, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int64)
    p = np.ascontiguousarray(points, dtype=np.float64)
    for name, a in (("verts", v), ("faces", f), ("points", p)):
        if a.ndim != 2 or a.shape[1] != 3:
            raise ValueError(f"{name} must be (N, 3), got {a.shape}")
    return v, f, p


def mesh_sdf(verts: np.ndarray, faces: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Signed distance (negative inside, even-odd parity) -> (P,) float32."""
    lib = load_library()
    v, f, p = _as_c(verts, faces, points)
    out = np.empty(len(p), dtype=np.float32)
    rc = lib.curobo_mesh_sdf(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(f),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise RuntimeError(f"curobo_mesh_sdf failed with code {rc}")
    return out
