"""Builds the CUDA sources under `csrc/` into shared libraries and loads them.

Every `csrc/<name>.cu` becomes `<build dir>/<name>-<hash>.so` with a plain C
interface, compiled by `nvcc` for `sm_90a` and loaded with `ctypes`. The hash
covers every file under `csrc/` and the flags, so a changed source is rebuilt
and an unchanged one is reused. The build happens at the first launch (or
through `build_all`, which starts one `nvcc` per source at once), never at
import. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")

# No --use_fast_math: the kernels keep IEEE division, sqrt and accurate sin/cos.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 when reused)
build_seconds: Dict[str, float] = {}


def build_dir() -> str:
    return os.environ.get("CUROBO_TORCH_BUILD_DIR", os.path.join(_HERE, "_build"))


def source_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _find_nvcc() -> str:
    cands = [
        os.path.join(os.environ[v], "bin", "nvcc")
        for v in ("CUDA_HOME", "CUDA_PATH")
        if v in os.environ
    ]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin); "
        "the CUDA kernels of curobo_tpu_torch cannot be built on this machine"
    )


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC_DIR)):
        if f.endswith((".cu", ".cuh")):
            h.update(f.encode())
            with open(os.path.join(CSRC_DIR, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(build_dir(), f"{name}-{_sources_hash()}.so")


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path)."""
    out = library_path(name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, cmd


def _finish_build(name: str, proc, tmp: str, out: str, cmd) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"building {name}.cu failed (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}"
        )
    with open(out[:-3] + ".log", "w") as fh:
        fh.write(log)
    os.replace(tmp, out)


def build_all(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Build every library that is not built yet, all compilers started
    together. Returns seconds per library (0.0 for one that was reused)."""
    import time

    names = source_names() if names is None else names
    with _lock:
        started = []
        t0 = time.perf_counter()
        for n in names:
            if os.path.exists(library_path(n)):
                build_seconds.setdefault(n, 0.0)
            else:
                started.append((n, *_start_build(n)))
        for n, proc, tmp, out, cmd in started:
            _finish_build(n, proc, tmp, out, cmd)
            build_seconds[n] = time.perf_counter() - t0
    return {n: build_seconds[n] for n in names}


def build_log(name: str) -> str:
    """What the compiler printed for `name` (registers, spills per kernel)."""
    path = library_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(library_path(name))
                _libs[name] = lib
    return lib
