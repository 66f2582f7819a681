"""Self-collision pair kernels: the hinge sum, its gradient and the largest
violation over a robot's sphere-pair list, per candidate configuration.

Counterpart of the matmul mode of `curobo_tpu/ops/pallas_ik.py`, which
`PallasIKCost` takes above 2048 live pairs: `sc_matmul_cost` (:710, with its
custom_vjp) and `sc_matmul_viol` (:789). Three CUDA kernels written by hand for
`sm_90a` (`ops/csrc/self_collision.cu`) stand in for them:

- `sc_pair_cost`: per candidate, the sum over live pairs of
  max(margin + activation - dist, 0);
- `sc_pair_grad`: its gradient with respect to the sphere positions, scaled by
  the upstream gradient of each candidate, gathered per sphere from an
  incidence list (no atomics, the same bits at every launch);
- `sc_pair_viol`: per candidate, the largest max(margin - dist, 0).

They take the positions sphere-major, (S, 3, N), and the live pairs of a
`PairTables`, built once per robot and device (`pair_tables`). The distance
is the generic path's sqrt(max(d2, 1e-12)).

Beside them stand their plain PyTorch versions over the same tables: the
chunked hinge sum, its chunked scatter gradient and the chunked violation of
the generic objective (`sc_pair_cost_plain`, `sc_pair_grad_plain`,
`sc_pair_viol_plain`: the pairs in chunks of `_CHUNK`, as the JAX package's
`lax.scan` does, since a humanoid's pair list gathered at once at an
optimizer's batch is tens of GB), and the gradient gathered per sphere in the
kernel's order (`sc_pair_grad_gather_plain`). A wrapper takes the plain
version only for a tensor that lies on the CPU; for a CUDA tensor it launches
the kernel or raises. Each wrapper counts its launches in `.launches`. The
generic objective (`geom/self_collision.py`) calls `pair_hinge_sum`, an
autograd Function over the cost and gradient wrappers, and `pair_violation`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from curobo_tpu_torch.robot.params import SelfCollisionParams

_LIB_NAME = "self_collision"

# Pairs per chunk of the plain versions: the JAX package's 4096 on the card,
# where a block streams through memory whatever its size and fewer chunks mean
# fewer launches; on the CPU as many as keep a (chunk, 3, N) block near
# _CPU_BLOCK_FLOATS, which stays in cache (twice as fast as 4096 at the test
# suite's batch sizes).
_CHUNK = 4096
_CPU_BLOCK_FLOATS = 1 << 20


def _chunk_size(pt: torch.Tensor) -> int:
    if pt.device.type != "cpu":
        return _CHUNK
    return max(256, min(_CHUNK, _CPU_BLOCK_FLOATS // (3 * pt.shape[-1])))


def _sphere_major(spheres: torch.Tensor) -> torch.Tensor:
    """(..., S, 4) -> positions (S, 3, N), N the flattened leading axes."""
    S = spheres.shape[-2]
    return spheres[..., :3].reshape(-1, S, 3).permute(1, 2, 0).contiguous()


def _chunk_dist(pt: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor):
    """Pair difference (C, 3, N), squared distance and distance (C, N) of one
    chunk of pairs; pt (S, 3, N)."""
    d = pt.index_select(0, ia).sub_(pt.index_select(0, ib))
    d2 = d[:, 0] * d[:, 0]
    d2.addcmul_(d[:, 1], d[:, 1]).addcmul_(d[:, 2], d[:, 2])
    return d, d2, d2.clamp_min(1e-12).sqrt_()


def _hinge_sum_chunks(pt, pair_a, pair_b, margin, activation: float) -> torch.Tensor:
    """sum over pairs of max(margin + activation - dist, 0): (N,)."""
    acc = pt.new_zeros((pt.shape[-1],))
    C = _chunk_size(pt)
    for s in range(0, pair_a.shape[0], C):
        e = s + C
        _, _, dist = _chunk_dist(pt, pair_a[s:e], pair_b[s:e])
        acc.add_(torch.sub((margin[s:e] + activation)[:, None], dist).clamp_min_(0.0).sum(dim=0))
    return acc


def _hinge_grad_chunks(pt, pair_a, pair_b, margin, activation: float, grad_out) -> torch.Tensor:
    """d(sum_n grad_out[n] hinge_sum[n]) / d pt, (S, 3, N): each chunk's
    distances and active pairs recomputed, their gradient scattered into the
    positions (`index_add_`). Peak transient memory is a few (chunk, 3, N)
    blocks whatever the pair count."""
    grad = torch.zeros_like(pt)
    C = _chunk_size(pt)
    for s in range(0, pair_a.shape[0], C):
        e = s + C
        ia, ib = pair_a[s:e], pair_b[s:e]
        d, d2, dist = _chunk_dist(pt, ia, ib)
        live = (dist < (margin[s:e] + activation)[:, None]).logical_and_(d2 > 1e-12)
        # d(-dist)/d(ca) = -(ca - cb) / dist, and the opposite for cb
        d.mul_(torch.where(live, grad_out / dist, 0.0).unsqueeze(1))
        grad.index_add_(0, ib, d)
        grad.index_add_(0, ia, d, alpha=-1.0)
    return grad


def _violation_chunks(pt, pair_a, pair_b, margin) -> torch.Tensor:
    """Largest max(margin - dist, 0) over the pairs: (N,). No gradient."""
    acc = pt.new_zeros((pt.shape[-1],))
    C = _chunk_size(pt)
    with torch.no_grad():
        for s in range(0, pair_a.shape[0], C):
            e = s + C
            _, _, dist = _chunk_dist(pt, pair_a[s:e], pair_b[s:e])
            torch.maximum(acc, torch.sub(margin[s:e, None], dist).amax(dim=0), out=acc)
    return acc


# ---------------------------------------------------------------------------
# Pair tables of the kernels
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PairTables:
    """The live pairs of a robot (finite margin) in pair order, and per sphere
    its incidence list in CSR form: entries [inc_off[s], inc_off[s + 1]) hold
    the index of each live pair that sphere s is an end of, in pair order,
    and the end's sign (+1 first end, -1 second)."""

    pair_a: torch.Tensor  # (P,) int32
    pair_b: torch.Tensor  # (P,) int32
    margin: torch.Tensor  # (P,) float32
    inc_off: torch.Tensor  # (S + 1,) int32
    inc_pair: torch.Tensor  # (2 P,) int32
    inc_sign: torch.Tensor  # (2 P,) int8
    S: int

    @property
    def P(self) -> int:
        return self.pair_a.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pair_a.device


def incidence_lists(S: int, pa: np.ndarray, pb: np.ndarray):
    """Per sphere, the pairs it is an end of, in pair order: (offsets (S + 1,),
    pair index (2 P,), sign (2 P,): +1 where the sphere is the pair's first
    end, -1 where it is the second)."""
    P = pa.shape[0]
    src = np.concatenate([pa, pb]).astype(np.int64)
    k = np.concatenate([np.arange(P), np.arange(P)])
    sign = np.concatenate([np.ones(P, np.int8), -np.ones(P, np.int8)])
    order = np.lexsort((k, src))
    off = np.zeros(S + 1, np.int32)
    np.cumsum(np.bincount(src, minlength=S), out=off[1:])
    return off, k[order].astype(np.int32), sign[order]


# pair_margin -> {device: (pair_a, tables)}; an entry goes with its margin
# tensor
_TABLES = WeakIdKeyDictionary()


def pair_tables(sc: SelfCollisionParams, n_spheres: int, device) -> PairTables:
    """The kernels' tables of `sc` on `device`, built once per robot and
    device (a new margin tensor, as `recompute_margins` makes, is a new
    robot)."""
    device = torch.device(device)
    per_device = _TABLES.setdefault(sc.pair_margin, {})
    hit = per_device.get(str(device))
    if hit is not None and hit[0] is sc.pair_a:
        return hit[1]
    margin = sc.pair_margin.detach().cpu().numpy().astype(np.float32)
    live = np.isfinite(margin)
    pa = sc.pair_a.cpu().numpy().astype(np.int32)[live]
    pb = sc.pair_b.cpu().numpy().astype(np.int32)[live]
    off, k, sign = incidence_lists(n_spheres, pa, pb)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    tab = PairTables(pair_a=t(pa), pair_b=t(pb), margin=t(margin[live]), inc_off=t(off),
                     inc_pair=t(k), inc_sign=t(sign), S=int(n_spheres))
    per_device[str(device)] = (sc.pair_a, tab)
    return tab


# ---------------------------------------------------------------------------
# Plain versions over a PairTables
# ---------------------------------------------------------------------------
def sc_pair_cost_plain(tab: PairTables, pt: torch.Tensor, activation: float) -> torch.Tensor:
    return _hinge_sum_chunks(pt, tab.pair_a, tab.pair_b, tab.margin, float(activation))


def sc_pair_viol_plain(tab: PairTables, pt: torch.Tensor) -> torch.Tensor:
    return _violation_chunks(pt, tab.pair_a, tab.pair_b, tab.margin)


def sc_pair_grad_plain(
    tab: PairTables, pt: torch.Tensor, grad_out: torch.Tensor, activation: float
) -> torch.Tensor:
    """The chunked scatter: each chunk of pairs adds its gradient into both
    ends (`index_add_`)."""
    return _hinge_grad_chunks(pt, tab.pair_a, tab.pair_b, tab.margin, float(activation), grad_out)


def sc_pair_grad_gather_plain(
    tab: PairTables, pt: torch.Tensor, grad_out: torch.Tensor, activation: float
) -> torch.Tensor:
    """The gradient in the kernel's order: every sphere sums its incidence
    list's terms in pair order; a live pair adds -(g / dist) d to its first
    end and +(g / dist) d to its second, d = p_a - p_b. Chunks of entries are
    added in order (the CPU's `index_add_` runs over its index in order)."""
    sphere = torch.repeat_interleave(
        torch.arange(tab.S, device=pt.device), (tab.inc_off[1:] - tab.inc_off[:-1]).long()
    )
    grad = torch.zeros_like(pt)
    C = _chunk_size(pt)
    for s in range(0, tab.inc_pair.shape[0], C):
        e = s + C
        k = tab.inc_pair[s:e].long()
        d, d2, dist = _chunk_dist(pt, tab.pair_a[k], tab.pair_b[k])
        live = (dist < (tab.margin[k] + activation)[:, None]).logical_and_(d2 > 1e-12)
        d.mul_(torch.where(live, grad_out / dist, 0.0).unsqueeze(1))
        d.mul_(-tab.inc_sign[s:e].to(pt.dtype)[:, None, None])
        grad.index_add_(0, sphere[s:e], d)
    return grad


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------
_lib_ready = None


def _lib():
    """The built library with argument types set (first use builds it)."""
    global _lib_ready
    if _lib_ready is None:
        from curobo_tpu_torch.ops.build import load_library

        lib = load_library(_LIB_NAME)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sc_forward_scratch_words.argtypes = [ci, ci]
        lib.sc_forward_scratch_words.restype = ctypes.c_longlong
        lib.sc_pair_cost_launch.argtypes = [vp] * 4 + [cf, ci, ci, vp, vp, vp]
        lib.sc_pair_cost_launch.restype = ci
        lib.sc_pair_viol_launch.argtypes = [vp] * 4 + [ci, ci, vp, vp, vp]
        lib.sc_pair_viol_launch.restype = ci
        lib.sc_pair_grad_launch.argtypes = [vp] * 8 + [cf, ci, ci, vp, vp]
        lib.sc_pair_grad_launch.restype = ci
        _lib_ready = lib
    return _lib_ready


def _check(tab: PairTables, pt: torch.Tensor, grad_out=None):
    if pt.ndim != 3 or pt.shape[0] != tab.S or pt.shape[1] != 3:
        raise ValueError(f"positions must have shape ({tab.S}, 3, N), got {tuple(pt.shape)}")
    named = [("positions", pt)] + ([] if grad_out is None else [("grad_out", grad_out)])
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != tab.device:
            raise ValueError(f"{name} lie on {t.device}, the pair tables on {tab.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if grad_out is not None and grad_out.shape != (pt.shape[2],):
        raise ValueError(f"grad_out must have shape ({pt.shape[2]},), got {tuple(grad_out.shape)}")


def _stream(pt: torch.Tensor):
    return torch.cuda.current_stream(pt.device).cuda_stream


def _forward_scratch(lib, tab: PairTables, pt: torch.Tensor):
    words = lib.sc_forward_scratch_words(pt.shape[2], tab.P)
    return None if words == 0 else torch.empty((words,), dtype=torch.float32, device=pt.device)


def sc_pair_cost(tab: PairTables, pt: torch.Tensor, activation: float) -> torch.Tensor:
    """pt (S, 3, N) -> the pair hinge sum (N,). CUDA tensors go through the
    `sc_pair_cost` kernel, CPU tensors through `sc_pair_cost_plain`."""
    _check(tab, pt)
    if pt.device.type == "cpu":
        return sc_pair_cost_plain(tab, pt, activation)
    lib = _lib()
    N = pt.shape[2]
    cost = torch.empty((N,), dtype=torch.float32, device=pt.device)
    with torch.cuda.device(pt.device):
        scratch = _forward_scratch(lib, tab, pt)
        err = lib.sc_pair_cost_launch(
            pt.data_ptr(), tab.pair_a.data_ptr(), tab.pair_b.data_ptr(), tab.margin.data_ptr(),
            float(activation), N, tab.P, None if scratch is None else scratch.data_ptr(),
            cost.data_ptr(), _stream(pt),
        )
    sc_pair_cost.launches += 1
    if err != 0:
        raise RuntimeError(f"sc_pair_cost kernel launch failed: CUDA error {err}")
    return cost


sc_pair_cost.launches = 0


def sc_pair_grad(
    tab: PairTables, pt: torch.Tensor, grad_out: torch.Tensor, activation: float
) -> torch.Tensor:
    """pt (S, 3, N), grad_out (N,) -> d(sum_n grad_out[n] cost[n]) / d pt,
    (S, 3, N). CUDA tensors go through the `sc_pair_grad` kernel, CPU tensors
    through `sc_pair_grad_plain`."""
    _check(tab, pt, grad_out)
    if pt.device.type == "cpu":
        return sc_pair_grad_plain(tab, pt, grad_out, activation)
    lib = _lib()
    S, _, N = pt.shape
    grad = torch.empty_like(pt)
    with torch.cuda.device(pt.device):
        err = lib.sc_pair_grad_launch(
            pt.data_ptr(), grad_out.data_ptr(), tab.pair_a.data_ptr(), tab.pair_b.data_ptr(),
            tab.margin.data_ptr(), tab.inc_off.data_ptr(), tab.inc_pair.data_ptr(),
            tab.inc_sign.data_ptr(), float(activation), N, S, grad.data_ptr(), _stream(pt),
        )
    sc_pair_grad.launches += 1
    if err != 0:
        raise RuntimeError(f"sc_pair_grad kernel launch failed: CUDA error {err}")
    return grad


sc_pair_grad.launches = 0


def sc_pair_viol(tab: PairTables, pt: torch.Tensor) -> torch.Tensor:
    """pt (S, 3, N) -> the largest pair violation (N,), 0 = clear. CUDA
    tensors go through the `sc_pair_viol` kernel, CPU tensors through
    `sc_pair_viol_plain`."""
    _check(tab, pt)
    if pt.device.type == "cpu":
        return sc_pair_viol_plain(tab, pt)
    lib = _lib()
    N = pt.shape[2]
    viol = torch.empty((N,), dtype=torch.float32, device=pt.device)
    with torch.cuda.device(pt.device):
        scratch = _forward_scratch(lib, tab, pt)
        err = lib.sc_pair_viol_launch(
            pt.data_ptr(), tab.pair_a.data_ptr(), tab.pair_b.data_ptr(), tab.margin.data_ptr(),
            N, tab.P, None if scratch is None else scratch.data_ptr(), viol.data_ptr(),
            _stream(pt),
        )
    sc_pair_viol.launches += 1
    if err != 0:
        raise RuntimeError(f"sc_pair_viol kernel launch failed: CUDA error {err}")
    return viol


sc_pair_viol.launches = 0


class _PairHingeSum(torch.autograd.Function):
    """The differentiable pair sum: forward `sc_pair_cost`, backward
    `sc_pair_grad` (which recomputes the distances from the saved positions).
    Each wrapper picks the kernel or its plain version by the tensor's
    device."""

    @staticmethod
    def forward(ctx, pt, tab, activation):
        ctx.save_for_backward(pt)
        ctx.tab, ctx.activation = tab, activation
        return sc_pair_cost(tab, pt, activation)

    @staticmethod
    def backward(ctx, grad_out):
        (pt,) = ctx.saved_tensors
        return sc_pair_grad(ctx.tab, pt, grad_out.contiguous(), ctx.activation), None, None


# ---------------------------------------------------------------------------
# What the generic objective calls
# ---------------------------------------------------------------------------
def pair_hinge_sum(sc: SelfCollisionParams, pt: torch.Tensor, activation: float) -> torch.Tensor:
    """Differentiable pair hinge sum (N,) of positions pt (S, 3, N)."""
    return _PairHingeSum.apply(pt, pair_tables(sc, pt.shape[0], pt.device), float(activation))


def pair_violation(sc: SelfCollisionParams, pt: torch.Tensor) -> torch.Tensor:
    """Largest pair violation (N,) of positions pt (S, 3, N), no gradient."""
    with torch.no_grad():
        return sc_pair_viol(pair_tables(sc, pt.shape[0], pt.device), pt)
