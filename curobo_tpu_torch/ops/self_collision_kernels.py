"""Self-collision pair kernels: the hinge sum, its gradient and the largest
violation over a robot's sphere-pair list, per candidate configuration.

Counterpart of the matmul mode of `curobo_tpu/ops/pallas_ik.py`, which
`PallasIKCost` takes above 2048 live pairs: `sc_matmul_cost` (:710, with its
custom_vjp) and `sc_matmul_viol` (:789). Three CUDA kernels written by hand for
`sm_90a` (`ops/csrc/self_collision.cu`) stand in for them:

- `sc_pair_cost`: per candidate, the sum over live pairs of
  max(margin + activation - dist, 0);
- `sc_pair_grad`: its gradient with respect to the sphere positions, scaled by
  the upstream gradient of each candidate, gathered per sphere tile from its
  partner tiles (no atomics, the same bits at every launch);
- `sc_pair_viol`: per candidate, the largest max(margin - dist, 0).

They take the positions sphere-major, (S, 3, N), and the tile tables of a
`PairTables`, built once per robot and device (`pair_tables`): the spheres cut
into tiles of `SC_TS`, the live tile pairs with a dense margin block each
(`tile_tables`). How a launch is cut into blocks (`launch_geometry`) depends on
N, S and the tables' shape only. The distance is the generic path's
sqrt(max(d2, 1e-12)).

Beside them stand their plain PyTorch versions: the chunked hinge sum, its
chunked scatter gradient and the chunked violation of the generic objective
over the live-pair list (`sc_pair_cost_plain`, `sc_pair_grad_plain`,
`sc_pair_viol_plain`: the pairs in chunks of `_CHUNK`, as the JAX package's
`lax.scan` does, since a humanoid's pair list gathered at once at an
optimizer's batch is tens of GB), the gradient gathered per sphere from an
incidence list (`sc_pair_grad_gather_plain`), and the three walked over the
tile tables in the kernels' order of tiles, groups and splits
(`sc_pair_cost_tiled_plain`, `sc_pair_grad_tiled_plain`,
`sc_pair_viol_tiled_plain`). A wrapper takes the plain version only for a
tensor that lies on the CPU; for a CUDA tensor it launches the kernel or
raises. Each wrapper counts its launches in `.launches`. The generic objective
(`geom/self_collision.py`) calls `pair_hinge_sum`, an autograd Function over
the cost and gradient wrappers, and `pair_violation`.
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
# Spheres per tile of the kernels (SC_TS, ops/csrc/self_collision.cu).
SC_TS = 32


@dataclasses.dataclass(frozen=True)
class PairTables:
    """The live pairs of a robot (finite margin) in pair order; per sphere its
    incidence list in CSR form: entries [inc_off[s], inc_off[s + 1]) hold the
    index of each live pair that sphere s is an end of, in pair order, and the
    end's sign (+1 first end, -1 second); and the kernels' tile tables
    (`tile_tables`)."""

    pair_a: torch.Tensor  # (P,) int32
    pair_b: torch.Tensor  # (P,) int32
    margin: torch.Tensor  # (P,) float32
    inc_off: torch.Tensor  # (S + 1,) int32
    inc_pair: torch.Tensor  # (2 P,) int32
    inc_sign: torch.Tensor  # (2 P,) int8
    tile_ij: torch.Tensor  # (L, 2) int32: live tiles (I, J), I <= J, in (I, J) order
    tile_margin: torch.Tensor  # (L, SC_TS, SC_TS) float32, [j][i]
    nb_off: torch.Tensor  # (T + 1,) int32: partners of sphere tile I at [nb_off[I], nb_off[I + 1])
    nb_tile: torch.Tensor  # (2 L - diagonal tiles,) int32: the partner tile J, in order
    nb_margin: torch.Tensor  # (same, SC_TS, SC_TS) float32, [j][i]
    S: int
    max_partners: int  # the longest partner list of a sphere tile

    @property
    def P(self) -> int:
        return self.pair_a.shape[0]

    @property
    def L(self) -> int:
        return self.tile_ij.shape[0]

    @property
    def n_tiles(self) -> int:
        return self.nb_off.shape[0] - 1

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


def tile_tables(S: int, pa: np.ndarray, pb: np.ndarray, margin: np.ndarray, ts: int = SC_TS):
    """The kernels' tables of the live pairs (pa, pb, margin), spheres cut
    into T = ceil(S / ts) tiles:

    - tile_ij (L, 2): the tiles (I, J), I <= J, that hold a live pair, in
      (I, J) order; tile_margin (L, ts, ts): at [k, j, i] the margin of the
      pair (I ts + i, J ts + j), -inf where there is none (a pair within one
      tile sits at i < j);
    - per sphere tile I its partner tiles in order (a CSR, nb_off (T + 1,),
      nb_tile): every tile that shares a live tile with I, I itself once;
      nb_margin at [e, j, i] the margin of the pair {I ts + i, J ts + j}.

    Raises on a pair of a sphere with itself or a pair listed twice."""
    T = -(-S // ts)
    a = np.minimum(pa, pb).astype(np.int64)
    b = np.maximum(pa, pb).astype(np.int64)
    if np.any(a == b):
        raise ValueError("the pair list holds a pair of a sphere with itself")
    ta, tb = a // ts, b // ts
    keys, tile_of = np.unique(ta * T + tb, return_inverse=True)
    L = keys.shape[0]
    tile_ij = np.stack([keys // T, keys % T], axis=1).astype(np.int32) if L else np.zeros((0, 2), np.int32)
    slot = (tile_of.reshape(-1) * ts + b % ts) * ts + a % ts
    if np.unique(slot).shape[0] != slot.shape[0]:
        raise ValueError("the pair list holds a sphere pair twice")
    fwd = np.full((L, ts, ts), -np.inf, np.float32)
    fwd.reshape(-1)[slot] = margin
    I, J = tile_ij[:, 0].astype(np.int64), tile_ij[:, 1].astype(np.int64)
    off_diag = np.flatnonzero(I != J)
    # each live tile once from its row tile I and, off the diagonal, once
    # from its column tile J with the block transposed
    rows = np.concatenate([I, J[off_diag]])
    cols = np.concatenate([J, I[off_diag]])
    src = np.concatenate([np.arange(L), off_diag])
    trans = np.concatenate([np.zeros(L, bool), np.ones(off_diag.shape[0], bool)])
    order = np.lexsort((cols, rows))
    rows, cols, src, trans = rows[order], cols[order], src[order], trans[order]
    blk = fwd[src]
    blk_t = blk.transpose(0, 2, 1)
    diag = rows == cols
    nb_margin = np.where(trans[:, None, None], blk_t, blk)
    nb_margin[diag] = np.maximum(blk[diag], blk_t[diag])  # the two halves are disjoint
    nb_off = np.zeros(T + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=T), out=nb_off[1:])
    return dict(tile_ij=tile_ij, tile_margin=fwd, nb_off=nb_off, nb_tile=cols.astype(np.int32),
                nb_margin=np.ascontiguousarray(nb_margin, dtype=np.float32))


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
    tiles = tile_tables(int(n_spheres), pa, pb, margin[live])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    tab = PairTables(pair_a=t(pa), pair_b=t(pb), margin=t(margin[live]), inc_off=t(off),
                     inc_pair=t(k), inc_sign=t(sign), S=int(n_spheres),
                     max_partners=int(np.diff(tiles["nb_off"]).max(initial=0)),
                     **{name: t(a) for name, a in tiles.items()})
    per_device[str(device)] = (sc.pair_a, tab)
    return tab


# ---------------------------------------------------------------------------
# Launch geometry
# ---------------------------------------------------------------------------
# Blocks one wave of the card holds: 132 SMs x 5 resident blocks (44 KB of
# shared memory each, ops/csrc/self_collision.cu). The forward aims at
# _FWD_WAVES waves so that its last wave is short; the gradient splits a
# sphere tile's partner list only until one wave is full, since every split
# adds a partial of the whole gradient.
_WAVE_BLOCKS = 132 * 5
_FWD_WAVES = 4


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    cw: int  # candidates per warp: the smallest power of two >= N, at most 32
    columns: int  # blocks along the candidates, ceil(N / cw)
    groups: int  # forward: runs of per_group live tiles, one block row each
    per_group: int
    splits: int  # gradient: runs of a sphere tile's partner list


def launch_geometry(N: int, S: int, n_live_tiles: int, max_partners: int) -> LaunchGeometry:
    """How the pair kernels cut a launch of N candidates over S spheres: a
    function of the shapes only, so the bits of a result are too."""
    cw = 32 if N >= 32 else 1 << max(0, N - 1).bit_length()
    columns = -(-N // cw)
    L = max(1, n_live_tiles)
    g = min(L, max(1, -(-_FWD_WAVES * _WAVE_BLOCKS // max(1, columns))))
    per = -(-L // g)
    T = max(1, -(-S // SC_TS))
    splits = min(max(1, max_partners), max(1, -(-_WAVE_BLOCKS // (T * max(1, columns)))))
    return LaunchGeometry(cw=cw, columns=columns, groups=-(-L // per), per_group=per, splits=splits)


def geometry_of(tab: PairTables, N: int) -> LaunchGeometry:
    return launch_geometry(N, tab.S, tab.L, tab.max_partners)


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
    """The gradient gathered per sphere: every sphere sums its incidence
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


def _tile_positions(tab: PairTables, pt: torch.Tensor) -> torch.Tensor:
    """pt (S, 3, N) -> (T, SC_TS, 3, N), zeros past the last sphere."""
    T, N = tab.n_tiles, pt.shape[2]
    if T * SC_TS == tab.S:
        return pt.reshape(T, SC_TS, 3, N)
    out = pt.new_zeros((T * SC_TS, 3, N))
    out[: tab.S] = pt
    return out.reshape(T, SC_TS, 3, N)


def _tile_dist(pi: torch.Tensor, pj: torch.Tensor):
    """Differences p_i - p_j (SC_TS j, SC_TS i, 3, N), squared distance and
    distance (j, i, N) of two tiles' spheres."""
    d = pi.unsqueeze(0) - pj.unsqueeze(1)
    d2 = d[:, :, 0] * d[:, :, 0]
    d2.addcmul_(d[:, :, 1], d[:, :, 1]).addcmul_(d[:, :, 2], d[:, :, 2])
    return d, d2, d2.clamp_min(1e-12).sqrt()


def _forward_tiled(tab: PairTables, pt: torch.Tensor, activation: float, is_max: bool) -> torch.Tensor:
    """The forward over the tile tables in the kernel's order: the live tiles
    cut into the launch's groups, each group's tiles in (I, J) order, the
    groups added (or maxed) in order. A dead slot (-inf margin) adds 0."""
    N = pt.shape[2]
    geo = geometry_of(tab, N)
    tp = _tile_positions(tab, pt)
    tiles = tab.tile_ij.tolist()
    out = pt.new_zeros((N,))
    with torch.no_grad():
        for g in range(geo.groups):
            acc = pt.new_zeros((N,))
            for k in range(g * geo.per_group, min(tab.L, (g + 1) * geo.per_group)):
                I, J = tiles[k]
                _, _, dist = _tile_dist(tp[I], tp[J])
                h = (tab.tile_margin[k] + activation).unsqueeze(-1) - dist
                if is_max:
                    acc = torch.maximum(acc, h.amax(dim=(0, 1)))
                else:
                    acc = acc + h.clamp_min(0.0).sum(dim=(0, 1))
            out = torch.maximum(out, acc) if is_max else out + acc
    return out


def sc_pair_cost_tiled_plain(tab: PairTables, pt: torch.Tensor, activation: float) -> torch.Tensor:
    """The hinge sum walked over the tile tables in `sc_pair_cost`'s order of
    tiles and groups (within a tile, PyTorch's order)."""
    return _forward_tiled(tab, pt, float(activation), False)


def sc_pair_viol_tiled_plain(tab: PairTables, pt: torch.Tensor) -> torch.Tensor:
    """The largest violation walked over the tile tables as `sc_pair_viol`
    walks them."""
    return _forward_tiled(tab, pt, 0.0, True)


def sc_pair_grad_tiled_plain(
    tab: PairTables, pt: torch.Tensor, grad_out: torch.Tensor, activation: float
) -> torch.Tensor:
    """The gradient walked over the tile tables in `sc_pair_grad`'s order:
    per sphere tile I its partner tiles in order, cut into the launch's
    splits, the splits added in order. A live pair (dist < margin + act,
    d2 > 1e-12) adds -(g / dist) (p_s - p_q) to each end s, q the other."""
    S, _, N = pt.shape
    geo = geometry_of(tab, N)
    tp = _tile_positions(tab, pt)
    off, partner = tab.nb_off.tolist(), tab.nb_tile.tolist()
    grad = pt.new_zeros((tab.n_tiles, SC_TS, 3, N))
    with torch.no_grad():
        for I in range(tab.n_tiles):
            e0, e1 = off[I], off[I + 1]
            per = -(-(e1 - e0) // geo.splits)
            for sp in range(geo.splits):
                acc = pt.new_zeros((SC_TS, 3, N))
                for e in range(min(e1, e0 + sp * per), min(e1, e0 + (sp + 1) * per)):
                    d, d2, dist = _tile_dist(tp[I], tp[partner[e]])
                    live = (dist < (tab.nb_margin[e] + activation).unsqueeze(-1)) & (d2 > 1e-12)
                    c = torch.where(live, grad_out / dist, 0.0)
                    acc = acc - (c.unsqueeze(2) * d).sum(dim=0)
                grad[I] += acc
    return grad.reshape(-1, 3, N)[:S].contiguous()


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
        lib.sc_pair_cost_launch.argtypes = [vp] * 3 + [cf] + [ci] * 6 + [vp] * 3
        lib.sc_pair_cost_launch.restype = ci
        lib.sc_pair_viol_launch.argtypes = [vp] * 3 + [ci] * 6 + [vp] * 3
        lib.sc_pair_viol_launch.restype = ci
        lib.sc_pair_grad_launch.argtypes = [vp] * 5 + [cf] + [ci] * 5 + [vp] * 3
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


def _scratch(words: int, pt: torch.Tensor):
    return None if words == 0 else torch.empty((words,), dtype=torch.float32, device=pt.device)


def _forward(name: str, tab: PairTables, pt: torch.Tensor, activation) -> torch.Tensor:
    """Launch `sc_pair_cost` (activation a float) or `sc_pair_viol` (None):
    the groups' partials go to scratch and a second pass adds them."""
    lib = _lib()
    N = pt.shape[2]
    geo = geometry_of(tab, N)
    out = torch.empty((N,), dtype=torch.float32, device=pt.device)
    with torch.cuda.device(pt.device):
        scratch = _scratch(geo.groups * N if geo.groups > 1 else 0, pt)
        args = [pt.data_ptr(), tab.tile_ij.data_ptr(), tab.tile_margin.data_ptr()]
        args += [] if activation is None else [float(activation)]
        args += [N, tab.S, tab.L, geo.cw, geo.groups, geo.per_group,
                 None if scratch is None else scratch.data_ptr(), out.data_ptr(), _stream(pt)]
        err = getattr(lib, name + "_launch")(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def sc_pair_cost(tab: PairTables, pt: torch.Tensor, activation: float) -> torch.Tensor:
    """pt (S, 3, N) -> the pair hinge sum (N,). CUDA tensors go through the
    `sc_pair_cost` kernel, CPU tensors through `sc_pair_cost_plain`."""
    _check(tab, pt)
    if pt.device.type == "cpu":
        return sc_pair_cost_plain(tab, pt, activation)
    cost = _forward("sc_pair_cost", tab, pt, float(activation))
    sc_pair_cost.launches += 1
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
    geo = geometry_of(tab, N)
    grad = torch.empty_like(pt)
    with torch.cuda.device(pt.device):
        scratch = _scratch(geo.splits * pt.numel() if geo.splits > 1 else 0, pt)
        err = lib.sc_pair_grad_launch(
            pt.data_ptr(), grad_out.data_ptr(), tab.nb_off.data_ptr(), tab.nb_tile.data_ptr(),
            tab.nb_margin.data_ptr(), float(activation), N, S, tab.L, geo.cw, geo.splits,
            None if scratch is None else scratch.data_ptr(), grad.data_ptr(), _stream(pt),
        )
    if err != 0:
        raise RuntimeError(f"sc_pair_grad kernel launch failed: CUDA error {err}")
    sc_pair_grad.launches += 1
    return grad


sc_pair_grad.launches = 0


def sc_pair_viol(tab: PairTables, pt: torch.Tensor) -> torch.Tensor:
    """pt (S, 3, N) -> the largest pair violation (N,), 0 = clear. CUDA
    tensors go through the `sc_pair_viol` kernel, CPU tensors through
    `sc_pair_viol_plain`."""
    _check(tab, pt)
    if pt.device.type == "cpu":
        return sc_pair_viol_plain(tab, pt)
    viol = _forward("sc_pair_viol", tab, pt, None)
    sc_pair_viol.launches += 1
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
