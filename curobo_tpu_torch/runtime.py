"""Module-level runtime helpers of the PyTorch/CUDA package.

Counterpart of `curobo_tpu/runtime.py`. There is no flag that turns a kernel
off: a tensor on a CUDA device goes through the hand-written kernel or the
call raises; a tensor on the CPU goes through the kernel's plain PyTorch
version. The device is chosen by the caller and never changed silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the CUDA device and raises when there is none; nothing
    moves to the CPU on its own. Tests pass ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "curobo_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' explicitly to use the plain "
                "PyTorch versions of the kernels"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
