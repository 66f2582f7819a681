"""Low-discrepancy samplers (numpy, host side).

Own copy of the numpy part of `curobo_tpu/util/sampling.py`: the Halton
sequence and its inverse-CDF normals are float64 numpy in both packages, so
the IK seeds are bit-identical and the MPPI bank agrees to float32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

_PRIMES = np.array(
    [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
     71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139,
     149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223,
     227, 229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293],
    dtype=np.int64,
)


def halton_sequence(n: int, dim: int, skip: int = 20) -> np.ndarray:
    """(n, dim) Halton points in (0, 1). Host-side numpy, deterministic."""
    if dim > len(_PRIMES):
        raise ValueError(f"halton dim {dim} > {len(_PRIMES)} supported")
    out = np.zeros((n, dim), dtype=np.float64)
    idx = np.arange(skip, skip + n, dtype=np.int64)
    for d in range(dim):
        b = _PRIMES[d]
        i = idx.copy()
        f = np.ones(n)
        r = np.zeros(n)
        while np.any(i > 0):
            f = f / b
            r = r + f * (i % b)
            i = i // b
        out[:, d] = r
    return out


def halton_gaussian(n: int, dim: int, skip: int = 20) -> np.ndarray:
    """(n, dim) standard-normal quasi-random samples: the inverse normal CDF
    of the Halton points, in float64 as the JAX package draws them."""
    from scipy.special import erfinv

    u = np.clip(halton_sequence(n, dim, skip), 1e-6, 1 - 1e-6)
    return np.sqrt(2.0) * erfinv(2.0 * u - 1.0)


def gaussian_halton_bank(
    n: int, dim: int, skip: int = 20, device="cpu", dtype=torch.float32
) -> torch.Tensor:
    """Device tensor of quasi-random normals, reused across optimizer
    iterations (the reference's `SampleBuffer` pattern)."""
    return torch.as_tensor(halton_gaussian(n, dim, skip), dtype=dtype, device=device)
