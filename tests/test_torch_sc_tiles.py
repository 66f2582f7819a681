"""The tile tables and launch geometry of the pair kernels
(`curobo_tpu_torch/ops/self_collision_kernels.py`: `tile_tables`,
`launch_geometry`) and the plain versions that walk the tiles in the kernels'
order (`sc_pair_*_tiled_plain`), on the CPU.

The tables are checked on the robots whose pair sums run the kernels (the
Unitree G1, the retargeting G1) and on the Franka (whose placeholder spheres
for attachments are disabled: 124 of its 818 pairs carry a -inf margin), and
on a dual UR10e with one more sphere disabled. The tiled versions are held
against the chunked plain versions over the live-pair list at small batches
(7 candidates, where the lanes of a warp take several partner spheres and the
gradient splits its partner lists, and 40), with the tolerances of
`tests/test_torch_self_collision_kernels.py`, which also holds them against
the JAX package's matmul mode.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu_torch.ops import self_collision_kernels as sck

TS = sck.SC_TS
COST_RTOL = 1e-5
GRAD_MED, GRAD_P99, GRAD_MAX_REL = 1e-4, 1e-2, 1e-5
VIOL_ATOL = 1e-6
# the four shapes of `chip_smoke.py` phase `sc_kernels`: (robot, candidates)
CHIP_SHAPES = (("unitree_g1", 4800), ("unitree_g1_29dof_retarget", 768),
               ("unitree_g1_29dof_retarget", 7), ("franka", 3200))

_KIN = {}


def _kin(name):
    if name not in _KIN:
        _KIN[name] = ct.Kinematics.from_robot_yaml(ct.robot_config_path(name), device="cpu")
    return _KIN[name]


def _disabled_dual():
    """The dual UR10e with sphere 5 disabled, as a negative radius does: every
    pair of it gets a -inf margin."""
    kt = _kin("dual_ur10e")
    sc = kt.params.self_collision
    off = (sc.pair_a == 5) | (sc.pair_b == 5)
    assert bool(off.any())
    margin = torch.where(off, torch.full_like(sc.pair_margin, -float("inf")), sc.pair_margin)
    return type(sc)(pair_a=sc.pair_a, pair_b=sc.pair_b, pair_margin=margin,
                    pair_buffer=sc.pair_buffer), kt.params.n_spheres


def _robot_sc(name):
    if name == "dual_ur10e_disabled":
        return _disabled_dual()
    kt = _kin(name)
    return kt.params.self_collision, kt.params.n_spheres


def _pairs_of(tab):
    """The live pairs of the tables' pair list: {(a, b): margin}, a < b."""
    pa, pb, m = tab.pair_a.numpy(), tab.pair_b.numpy(), tab.margin.numpy()
    return {(min(a, b), max(a, b)): float(v) for a, b, v in zip(pa, pb, m)}


@pytest.mark.parametrize("name", ["unitree_g1", "unitree_g1_29dof_retarget", "franka",
                                  "dual_ur10e_disabled"])
def test_tile_tables_list_every_live_pair_once(name):
    sc, S = _robot_sc(name)
    tab = sck.pair_tables(sc, S, "cpu")
    live = torch.isfinite(sc.pair_margin)
    assert tab.P == int(live.sum())
    if name == "franka":
        assert tab.P == 694 < sc.pair_a.shape[0] == 818
    if name == "dual_ur10e_disabled":
        assert tab.P < sc.pair_a.shape[0]
        assert not ((tab.pair_a == 5) | (tab.pair_b == 5)).any()
    want = _pairs_of(tab)
    T = -(-S // TS)
    assert tab.n_tiles == T
    ij = tab.tile_ij.numpy()
    # live tiles only, I <= J, in (I, J) order, each once
    assert np.all(ij[:, 0] <= ij[:, 1])
    keys = ij[:, 0] * T + ij[:, 1]
    assert np.all(np.diff(keys) > 0)
    if name == "unitree_g1":
        assert tab.L <= 253
    if name == "unitree_g1_29dof_retarget":
        assert tab.L <= 91
    # the forward blocks: every live pair exactly once, with its margin; no
    # dead pair; a pair within one tile at i < j
    got = {}
    blocks = tab.tile_margin.numpy()
    for k, (I, J) in enumerate(ij):
        jj, ii = np.nonzero(np.isfinite(blocks[k]))
        assert jj.size > 0, "a listed tile holds no live pair"
        if I == J:
            assert np.all(ii < jj)
        for j, i in zip(jj, ii):
            a, b = I * TS + i, J * TS + j
            assert (a, b) not in got
            got[(a, b)] = float(blocks[k, j, i])
    assert got == want
    # the gradient's partner lists: per sphere tile its partners in order, a
    # live pair once from each end with its margin
    off, partner, nb = tab.nb_off.numpy(), tab.nb_tile.numpy(), tab.nb_margin.numpy()
    assert off[0] == 0 and off[-1] == partner.shape[0] == 2 * tab.L - int((ij[:, 0] == ij[:, 1]).sum())
    assert tab.max_partners == int(np.diff(off).max())
    ends = {}
    for I in range(T):
        ps = partner[off[I]:off[I + 1]]
        assert np.all(np.diff(ps) > 0)
        for e, J in zip(range(off[I], off[I + 1]), ps):
            jj, ii = np.nonzero(np.isfinite(nb[e]))
            for j, i in zip(jj, ii):
                s, q = I * TS + i, J * TS + j
                key = (s, (min(s, q), max(s, q)))
                assert key not in ends
                ends[key] = float(nb[e, j, i])
    assert len(ends) == 2 * tab.P
    for (s, pair), m in ends.items():
        assert s in pair and want[pair] == m


def test_tile_tables_refuse_a_repeated_or_self_pair():
    pa, pb, m = np.array([0, 3]), np.array([3, 0]), np.ones(2, np.float32)
    with pytest.raises(ValueError):
        sck.tile_tables(8, pa, pb, m)
    with pytest.raises(ValueError):
        sck.tile_tables(8, np.array([2]), np.array([2]), np.ones(1, np.float32))
    empty = sck.tile_tables(8, np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32))
    assert empty["tile_ij"].shape == (0, 2) and empty["nb_off"].tolist() == [0, 0]


def test_launch_geometry_depends_on_the_shapes_only():
    """The same shapes give the same geometry whatever the margins; a warp's
    lanes hold the candidates with fewer than half idle; the groups cover the
    live tiles; the splits stay within the partner lists."""
    kt = _kin("unitree_g1_29dof_retarget")
    sc = kt.params.self_collision
    S = kt.params.n_spheres
    tab = sck.pair_tables(sc, S, "cpu")
    moved = type(sc)(pair_a=sc.pair_a, pair_b=sc.pair_b, pair_margin=sc.pair_margin + 0.01,
                     pair_buffer=sc.pair_buffer)
    tab2 = sck.pair_tables(moved, S, "cpu")
    assert tab2 is not tab
    for N in list(range(1, 70)) + [448, 768, 3200, 4800]:
        geo = sck.geometry_of(tab, N)
        assert geo == sck.geometry_of(tab2, N) == sck.launch_geometry(N, S, tab.L, tab.max_partners)
        assert geo.cw & (geo.cw - 1) == 0 and geo.cw <= 32
        if N >= 32:
            assert geo.cw == 32
        else:
            assert geo.cw >= N > geo.cw // 2
            assert (32 // geo.cw) * (geo.cw - N) < 16  # idle lanes of a warp
        assert geo.columns == -(-N // geo.cw)
        assert (geo.groups - 1) * geo.per_group < tab.L <= geo.groups * geo.per_group
        assert 1 <= geo.splits <= tab.max_partners
    # the chip run's shapes: the retarget robot's local frame splits its
    # partner lists and puts 4 slots of 8 candidates on a warp; the G1 line
    # search fills the card without splits
    shapes = {(name, N): sck.geometry_of(sck.pair_tables(*_robot_sc(name), "cpu"), N)
              for name, N in CHIP_SHAPES}
    local = shapes[("unitree_g1_29dof_retarget", 7)]
    assert local.cw == 8 and local.splits > 1
    g1 = shapes[("unitree_g1", 4800)]
    assert g1.cw == 32 and g1.splits == 1 and g1.columns * g1.groups >= 4 * 132


def _grad_agrees(g, ref):
    nz = (g != 0) | (ref != 0)
    r = np.abs(g - ref)[nz] / (np.abs(ref[nz]) + 1.0)
    max_rel = float(np.abs(g - ref).max() / np.abs(ref).max())
    assert nz.mean() > 0.01
    assert np.median(r) < GRAD_MED and np.percentile(r, 99) < GRAD_P99 and max_rel <= GRAD_MAX_REL


@pytest.mark.parametrize("name", ["unitree_g1", "unitree_g1_29dof_retarget"])
@pytest.mark.parametrize("N", [7, 40])
def test_tiled_plain_versions_match_the_chunked_plain_versions(name, N):
    """The tiled walk (the kernels' order of tiles, groups and splits) against
    the chunked sums over the live-pair list, configurations over the whole
    joint range, where many pairs collide."""
    kt = _kin(name)
    tab = sck.pair_tables(kt.params.self_collision, kt.params.n_spheres, "cpu")
    rng = np.random.RandomState(N)
    lo, hi = kt.params.dof_clip_bounds(np.pi)
    q = rng.uniform(lo, hi, (N, kt.n_dof)).astype(np.float32)
    pt = sck._sphere_major(kt.compute_kinematics(torch.as_tensor(q)).spheres)
    up = torch.as_tensor(rng.uniform(0.5, 2.0, N).astype(np.float32))
    act = 0.02
    c = sck.sc_pair_cost_plain(tab, pt, act).numpy()
    assert (c > 0).sum() >= N // 2
    np.testing.assert_allclose(sck.sc_pair_cost_tiled_plain(tab, pt, act).numpy(), c,
                               rtol=COST_RTOL, atol=1e-6)
    np.testing.assert_allclose(sck.sc_pair_viol_tiled_plain(tab, pt).numpy(),
                               sck.sc_pair_viol_plain(tab, pt).numpy(), rtol=0, atol=VIOL_ATOL)
    _grad_agrees(sck.sc_pair_grad_tiled_plain(tab, pt, up, act).numpy(),
                 sck.sc_pair_grad_plain(tab, pt, up, act).numpy())
