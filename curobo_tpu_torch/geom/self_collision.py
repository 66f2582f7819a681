"""Self-collision distance over a precomputed sphere-pair list (PyTorch).

Counterpart of `curobo_tpu/geom/self_collision.py`: gather + pairwise
distance + masked reduction with index tensors. The pair distance is
``sqrt(max(d2, 1e-12))`` as in the JAX generic path (the kernels use
``sqrt(d2 + 1e-12)``).

The pairs are taken in chunks of `_CHUNK`, as the JAX package's `lax.scan`
does: a humanoid's pair list (the G1's 162 111 pairs) gathered at once at an
optimizer's batch is tens of GB. The cost is a `torch.autograd.Function`
whose forward sums the chunks and keeps only the sphere positions and the
pair tables, and whose backward recomputes each chunk's distances and active
pairs and scatters their gradient into the positions (`index_add_`); the
distance (a metric) runs the same loop without a graph. Peak transient memory
is a few (chunk, 3, batch) blocks whatever the pair count. The positions are
laid out sphere-major, (S, 3, batch), so that a chunk's gather and scatter
move whole rows and its sums run over contiguous slices. Chunks are slices
of the pair list (the last one shorter, no dead padding).
"""

from __future__ import annotations

import torch

from curobo_tpu_torch.robot.params import SelfCollisionParams

# Pairs per chunk: the JAX package's 4096 on the card, where a block streams
# through memory whatever its size and fewer chunks mean fewer launches; on the
# CPU as many as keep a (chunk, 3, N) block near _CPU_BLOCK_FLOATS, which stays
# in cache (twice as fast as 4096 at the test suite's batch sizes).
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


class _PairHingeSum(torch.autograd.Function):
    """sum over pairs of max(margin + activation - dist, 0): (N,), from
    sphere-major positions pt (S, 3, N)."""

    @staticmethod
    def forward(ctx, pt, pair_a, pair_b, margin, activation):
        acc = None
        C = _chunk_size(pt)
        for s in range(0, pair_a.shape[0], C):
            e = s + C
            _, _, dist = _chunk_dist(pt, pair_a[s:e], pair_b[s:e])
            c = torch.sub((margin[s:e] + activation)[:, None], dist).clamp_min_(0.0).sum(dim=0)
            acc = c if acc is None else acc.add_(c)
        ctx.save_for_backward(pt, pair_a, pair_b, margin)
        ctx.activation = activation
        return acc

    @staticmethod
    def backward(ctx, grad_out):
        pt, pair_a, pair_b, margin = ctx.saved_tensors
        grad = torch.zeros_like(pt)
        C = _chunk_size(pt)
        for s in range(0, pair_a.shape[0], C):
            e = s + C
            ia, ib = pair_a[s:e], pair_b[s:e]
            d, d2, dist = _chunk_dist(pt, ia, ib)
            live = (dist < (margin[s:e] + ctx.activation)[:, None]).logical_and_(d2 > 1e-12)
            # d(-dist)/d(ca) = -(ca - cb) / dist, and the opposite for cb
            d.mul_(torch.where(live, grad_out / dist, 0.0).unsqueeze(1))
            grad.index_add_(0, ib, d)
            grad.index_add_(0, ia, d, alpha=-1.0)
        return grad, None, None, None, None


def self_collision_distance(sc: SelfCollisionParams, spheres: torch.Tensor) -> torch.Tensor:
    """Max pairwise violation (...,): margin - distance, clipped at 0.
    spheres: (..., S, 4). 0 = clear. A metric: no gradient."""
    if sc.pair_a.shape[0] == 0:
        return spheres.new_zeros(spheres.shape[:-2])
    with torch.no_grad():
        pt = _sphere_major(spheres)
        acc = None
        C = _chunk_size(pt)
        for s in range(0, sc.pair_a.shape[0], C):
            e = s + C
            _, _, dist = _chunk_dist(pt, sc.pair_a[s:e], sc.pair_b[s:e])
            v = torch.sub(sc.pair_margin[s:e, None], dist).clamp_min_(0.0).amax(dim=0)
            acc = v if acc is None else torch.maximum(acc, v)
    return acc.reshape(spheres.shape[:-2])


def self_collision_cost(
    sc: SelfCollisionParams, spheres: torch.Tensor, activation_distance: float = 0.0
) -> torch.Tensor:
    """Summed pair violation (...,) for optimization: sum over pairs of
    max(margin + activation - distance, 0)."""
    if sc.pair_a.shape[0] == 0:
        return spheres.new_zeros(spheres.shape[:-2])
    c = _PairHingeSum.apply(
        _sphere_major(spheres), sc.pair_a, sc.pair_b, sc.pair_margin, float(activation_distance)
    )
    return c.reshape(spheres.shape[:-2])
