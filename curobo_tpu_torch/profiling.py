"""Profiling facade: device timers and trace capture.

Counterpart of `curobo_tpu/profiling.py`: `DeviceTimer` (wall clock around
work that ends in a synchronisation of the CUDA device the result lies on),
`trace` (a `torch.profiler` capture written as a Chrome trace), and
`annotate` / `named_scope` (ranges named in the profiler's trace,
`torch.profiler.record_function`).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _cuda_devices(out):
    """The CUDA devices of the tensors in `out` (a tensor, or a dataclass,
    list, tuple or dict of them)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    elif hasattr(out, "__dataclass_fields__"):
        out = [getattr(out, f) for f in out.__dataclass_fields__]
    if isinstance(out, (list, tuple)):
        return set().union(*(_cuda_devices(o) for o in out)) if out else set()
    return set()


class DeviceTimer:
    """Wall-clock timer that synchronizes the result's CUDA device at stop.

    with DeviceTimer() as t:
        out = solve(...)
        t.sync(out)          # wait for the result before stopping
    print(t.elapsed_ms)
    """

    def __init__(self):
        self.elapsed_ms: Optional[float] = None
        self._t0: Optional[float] = None
        self._out = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def sync(self, out):
        self._out = out
        return out

    def __exit__(self, *exc):
        for dev in _cuda_devices(self._out):
            torch.cuda.synchronize(dev)
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1000.0
        return False


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `torch.profiler` trace (the CPU, and the CUDA device where
    there is one) and write it to ``log_dir/trace.json`` (Chrome / Perfetto
    format)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range in profiler traces (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)


named_scope = annotate
