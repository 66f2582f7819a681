"""The pair kernels' plain versions (`curobo_tpu_torch/ops/self_collision_kernels.py`)
against the TPU kernels' humanoid-scale self-collision mode on the CPU.

`PallasIKCost(..., self_collision_mode="matmul")` computes the summed activated
pair violation (`sc_matmul_cost`, with its recomputing custom_vjp) and the
largest violation (`sc_matmul_viol`) by one-hot pair-difference matmuls; they
are called here eagerly, outside any Pallas kernel, for the Franka (818 pairs,
694 live) and the dual UR10e, whose pair-difference matrices stay small (a
G1's is 162k x 674 and is never built here). The same numpy-made positions
go through the port's plain pair sum, its autograd gradient and its
violation. Tolerances: cost relative 1e-5 (float32 sums over hundreds of
pairs in another order); gradient median relative 1e-4 and 99th percentile
1e-2 (`tests/test_pallas_ik.py:70-76`) over the entries where either side is
nonzero (most spheres are in no active pair, and their exact zeros would set
the median and the 99th percentile on their own), and the largest absolute
difference at most 1e-5 of the largest gradient entry, so that one wrong
sphere shows; violation 1e-6 m (the matmul mode's distance is
sqrt(d2 + 1e-12), the port's sqrt(max(d2, 1e-12))).

Also held: the plain versions that walk the kernels' tile tables in their
order (`sc_pair_*_tiled_plain`) against the matmul mode, the incidence
tables, the plain gather-by-sphere gradient against the plain scatter, the wrappers' input checks,
and that a CPU tensor never loads the CUDA library. The kernels themselves
are held against these plain versions on the card by `chip_smoke.py` (phase
`sc_kernels`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.cost import terms as jterms
from curobo_tpu.geom import types as jgt
from curobo_tpu.geom import world as jwm
from curobo_tpu.ops.pallas_ik import PallasIKCost
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.rollout.robot_rollout import RobotRolloutConfig as JRolloutConfig
from curobo_tpu_torch.geom import self_collision as tsc
from curobo_tpu_torch.ops import build as kbuild
from curobo_tpu_torch.ops import self_collision_kernels as sck

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_ROBOTS = os.path.join(ROOT, "curobo_tpu", "content", "robots")
ROBOTS = ("franka", "dual_ur10e")
N = 48  # candidate configurations
COST_RTOL = 1e-5
GRAD_MED, GRAD_P99 = 1e-4, 1e-2
VIOL_ATOL = 1e-6


GRAD_MAX_REL = 1e-5
MIN_NONZERO_SHARE = 0.02


def _grad_agrees(g, ref):
    """The gradient gates over the entries where either side is nonzero:
    relative error (floor 1) median and 99th percentile, and the largest
    absolute difference against the largest |ref|; enough entries nonzero
    that the statistics see the active pairs."""
    nz = (g != 0) | (ref != 0)
    share = float(nz.mean())
    r = np.abs(g - ref)[nz] / (np.abs(ref[nz]) + 1.0)
    med, p99 = float(np.median(r)), float(np.percentile(r, 99))
    max_rel = float(np.abs(g - ref).max() / np.abs(ref).max())
    assert share >= MIN_NONZERO_SHARE, share
    assert med < GRAD_MED and p99 < GRAD_P99 and max_rel <= GRAD_MAX_REL, (med, p99, max_rel, share)


@pytest.fixture(scope="module", params=ROBOTS)
def robot(request):
    """Both packages' robot, the JAX matmul-mode IK cost (self-collision
    activation 0.02) and spheres (N, S, 4) of configurations over the full
    joint range, where many pairs collide."""
    name = request.param
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, name + ".yml"))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path(name), device="cpu")
    act = 0.02
    cfg = JRolloutConfig(
        self_collision_cost=jterms.SelfCollisionCostConfig(weight=1.0, activation_distance=act)
    )
    world = jwm.compile_scene(jgt.Scene().add(
        jgt.Cuboid(name="table", pose=[0.0, 0.0, -0.5, 1, 0, 0, 0], dims=[1.0, 1.0, 0.2])))
    pik = PallasIKCost(kj.params, cfg, world, self_collision_mode="matmul")
    rng = np.random.RandomState(ROBOTS.index(name))
    lo, hi = kt.params.dof_clip_bounds(np.pi)
    q = rng.uniform(lo, hi, (N, kt.n_dof)).astype(np.float32)
    spheres = kt.compute_kinematics(torch.as_tensor(q)).spheres.numpy()
    return dict(name=name, kt=kt, pik=pik, act=act, spheres=spheres,
                upstream=rng.uniform(0.5, 2.0, N).astype(np.float32))


def _jax_sc(robot):
    """sc_matmul_cost, its VJP under the upstream gradient, and
    sc_matmul_viol: (N,), (S, 3, N), (N,)."""
    pik, sph = robot["pik"], robot["spheres"]
    sx, sy, sz = (jnp.asarray(np.ascontiguousarray(sph[..., c].T)) for c in range(3))
    D, m = pik._D_pair, pik._margin
    cost, vjp = jax.vjp(lambda x, y, z: pik.sc_matmul_cost(D, m, x, y, z), sx, sy, sz)
    gx, gy, gz = vjp(jnp.asarray(robot["upstream"]))
    viol = pik.sc_matmul_viol(D, m, sx, sy, sz)
    grad = np.stack([np.asarray(gx), np.asarray(gy), np.asarray(gz)], axis=1)
    return np.asarray(cost), grad, np.asarray(viol)


def test_plain_pair_sum_and_violation_match_the_matmul_mode(robot):
    cj, gj, vj = _jax_sc(robot)
    sc = robot["kt"].params.self_collision
    pt = tsc._sphere_major(torch.as_tensor(robot["spheres"])).requires_grad_(True)
    c = sck.pair_hinge_sum(sc, pt, robot["act"])
    (g,) = torch.autograd.grad((c * torch.as_tensor(robot["upstream"])).sum(), pt)
    assert (cj > 0).sum() >= 4, "too few self-colliding candidates to test"
    np.testing.assert_allclose(c.detach().numpy(), cj, rtol=COST_RTOL, atol=1e-6)
    assert np.abs(gj).max() > 1.0
    _grad_agrees(g.numpy(), gj)
    v = tsc.self_collision_distance(sc, torch.as_tensor(robot["spheres"])).numpy()
    assert (v > 0).any()
    np.testing.assert_allclose(v, np.maximum(vj, 0.0), rtol=0, atol=VIOL_ATOL)


def test_plain_versions_over_the_tables_match_the_matmul_mode(robot):
    """The kernels' plain versions over the live-pair tables: the same sums."""
    cj, gj, vj = _jax_sc(robot)
    sc = robot["kt"].params.self_collision
    pt = tsc._sphere_major(torch.as_tensor(robot["spheres"]))
    tab = sck.pair_tables(sc, pt.shape[0], "cpu")
    np.testing.assert_allclose(sck.sc_pair_cost_plain(tab, pt, robot["act"]).numpy(), cj,
                               rtol=COST_RTOL, atol=1e-6)
    up = torch.as_tensor(robot["upstream"])
    _grad_agrees(sck.sc_pair_grad_plain(tab, pt, up, robot["act"]).numpy(), gj)
    _grad_agrees(sck.sc_pair_grad_gather_plain(tab, pt, up, robot["act"]).numpy(), gj)
    np.testing.assert_allclose(sck.sc_pair_viol_plain(tab, pt).numpy(), np.maximum(vj, 0.0),
                               rtol=0, atol=VIOL_ATOL)


def test_tiled_plain_versions_match_the_matmul_mode(robot):
    """The plain versions that walk the tile tables in the kernels' order
    (`sc_pair_*_tiled_plain`) against `sc_matmul_cost`, its VJP and
    `sc_matmul_viol`, at all N candidates and at 7 (where a warp's lanes take
    several partner spheres and the gradient splits its partner lists)."""
    cj, gj, vj = _jax_sc(robot)
    sc = robot["kt"].params.self_collision
    pt = tsc._sphere_major(torch.as_tensor(robot["spheres"]))
    tab = sck.pair_tables(sc, pt.shape[0], "cpu")
    up = torch.as_tensor(robot["upstream"])
    act = robot["act"]
    np.testing.assert_allclose(sck.sc_pair_cost_tiled_plain(tab, pt, act).numpy(), cj,
                               rtol=COST_RTOL, atol=1e-6)
    _grad_agrees(sck.sc_pair_grad_tiled_plain(tab, pt, up, act).numpy(), gj)
    np.testing.assert_allclose(sck.sc_pair_viol_tiled_plain(tab, pt).numpy(), np.maximum(vj, 0.0),
                               rtol=0, atol=VIOL_ATOL)
    # 7 candidates: the geometry of a retargeted local frame
    assert sck.geometry_of(tab, 7).cw == 8
    few = pt[..., :7].contiguous()
    np.testing.assert_allclose(sck.sc_pair_cost_tiled_plain(tab, few, act).numpy(), cj[:7],
                               rtol=COST_RTOL, atol=1e-6)
    np.testing.assert_allclose(sck.sc_pair_viol_tiled_plain(tab, few).numpy(),
                               np.maximum(vj[:7], 0.0), rtol=0, atol=VIOL_ATOL)


def test_incidence_tables(robot):
    """Every live pair appears exactly twice, once under each end with
    opposite signs, in pair order within a sphere; dead pairs are dropped."""
    sc = robot["kt"].params.self_collision
    S = robot["kt"].params.n_spheres
    tab = sck.pair_tables(sc, S, "cpu")
    live = torch.isfinite(sc.pair_margin)
    if robot["name"] == "franka":
        assert int(live.sum()) == 694 < sc.pair_a.shape[0] == 818
    assert torch.equal(tab.pair_a, sc.pair_a[live]) and torch.equal(tab.pair_b, sc.pair_b[live])
    assert torch.equal(tab.margin, sc.pair_margin[live]) and bool(torch.isfinite(tab.margin).all())
    P = tab.P
    off, k, sign = tab.inc_off.numpy(), tab.inc_pair.numpy(), tab.inc_sign.numpy()
    assert off[0] == 0 and off[-1] == 2 * P and np.all(np.diff(off) >= 0)
    assert np.array_equal(np.bincount(k, minlength=P), np.full(P, 2))
    pa, pb = tab.pair_a.numpy(), tab.pair_b.numpy()
    seen_first, seen_second = np.zeros(P, bool), np.zeros(P, bool)
    for s in range(S):
        ks, sg = k[off[s]:off[s + 1]], sign[off[s]:off[s + 1]]
        assert np.all(np.diff(ks) > 0)  # pair order
        first = sg == 1
        assert np.all(sg[~first] == -1)
        assert np.all(pa[ks[first]] == s) and np.all(pb[ks[~first]] == s)
        seen_first[ks[first]] = True
        seen_second[ks[~first]] = True
    assert seen_first.all() and seen_second.all()
    assert sck.pair_tables(sc, S, "cpu") is tab  # built once per robot and device


def test_pair_tables_go_with_their_robot():
    """The table cache holds no robot alive: an entry goes when its margin
    tensor does, and a new margin tensor is a new robot."""
    import gc

    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    sc = kt.params.self_collision
    n0 = len(sck._TABLES)
    moved = type(sc)(pair_a=sc.pair_a, pair_b=sc.pair_b, pair_margin=sc.pair_margin + 0.01,
                     pair_buffer=sc.pair_buffer)
    tab = sck.pair_tables(moved, kt.params.n_spheres, "cpu")
    base = sck.pair_tables(sc, kt.params.n_spheres, "cpu")
    assert len(sck._TABLES) == n0 + 2 and tab is not base
    torch.testing.assert_close(tab.margin, base.margin + 0.01)
    del moved, tab, base
    gc.collect()
    assert len(sck._TABLES) == n0 + 1  # the unmoved robot's entry stays while it lives
    del sc, kt
    gc.collect()
    assert len(sck._TABLES) == n0


def test_gather_by_sphere_equals_the_scatter(robot):
    """The gradient in the kernel's order equals the plain scatter
    (`sc_pair_grad_plain`, the backward of the generic objective on the CPU)
    to the float32 order of the per-sphere sums."""
    sc = robot["kt"].params.self_collision
    pt = tsc._sphere_major(torch.as_tensor(robot["spheres"]))
    up = torch.as_tensor(robot["upstream"])
    tab = sck.pair_tables(sc, pt.shape[0], "cpu")
    for act in (0.0, robot["act"]):
        x = pt.clone().requires_grad_(True)
        (g_scatter,) = torch.autograd.grad((sck.pair_hinge_sum(sc, x, act) * up).sum(), x)
        assert torch.equal(g_scatter, sck.sc_pair_grad_plain(tab, pt, up, act))
        g_gather = sck.sc_pair_grad_gather_plain(tab, pt, up, act)
        assert float(g_scatter.abs().max()) > 1.0
        np.testing.assert_allclose(g_gather.numpy(), g_scatter.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_never_load_the_library(robot, monkeypatch):
    """On the CPU every entry (the routing functions and the wrappers) runs
    its plain version; the loader is made to raise."""

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(sck, "_lib", refuse)
    monkeypatch.setattr(kbuild, "load_library", refuse)
    sc = robot["kt"].params.self_collision
    spheres = torch.as_tensor(robot["spheres"]).requires_grad_(True)
    c = tsc.self_collision_cost(sc, spheres, robot["act"])
    c.sum().backward()
    assert torch.isfinite(spheres.grad).all()
    tsc.self_collision_distance(sc, spheres)
    pt = tsc._sphere_major(spheres.detach())
    tab = sck.pair_tables(sc, pt.shape[0], "cpu")
    launches = (sck.sc_pair_cost.launches, sck.sc_pair_grad.launches, sck.sc_pair_viol.launches)
    torch.testing.assert_close(sck.sc_pair_cost(tab, pt, 0.02), sck.sc_pair_cost_plain(tab, pt, 0.02),
                               rtol=0, atol=0)
    up = torch.ones(pt.shape[2])
    torch.testing.assert_close(sck.sc_pair_grad(tab, pt, up, 0.02),
                               sck.sc_pair_grad_plain(tab, pt, up, 0.02), rtol=0, atol=0)
    torch.testing.assert_close(sck.sc_pair_viol(tab, pt), sck.sc_pair_viol_plain(tab, pt),
                               rtol=0, atol=0)
    # the counts are of kernel launches only
    assert launches == (sck.sc_pair_cost.launches, sck.sc_pair_grad.launches,
                        sck.sc_pair_viol.launches)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "grad_out"])
def test_wrappers_refuse_what_the_kernels_do_not_take(robot, bad):
    sc = robot["kt"].params.self_collision
    pt = tsc._sphere_major(torch.as_tensor(robot["spheres"]))
    tab = sck.pair_tables(sc, pt.shape[0], "cpu")
    up = torch.ones(pt.shape[2])
    if bad == "dtype":
        pt = pt.double()
    elif bad == "shape":
        pt = pt[1:]
    elif bad == "contiguity":
        pt = pt.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        up = up[1:]
    with pytest.raises(ValueError):
        sck.sc_pair_grad(tab, pt, up, 0.0)
    if bad != "grad_out":
        with pytest.raises(ValueError):
            sck.sc_pair_cost(tab, pt, 0.0)
        with pytest.raises(ValueError):
            sck.sc_pair_viol(tab, pt)


def test_empty_pair_list_gives_zeros():
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    sc = kt.params.self_collision
    empty = type(sc)(pair_a=sc.pair_a[:0], pair_b=sc.pair_b[:0], pair_margin=sc.pair_margin[:0],
                     pair_buffer=sc.pair_buffer[:0])
    spheres = kt.compute_kinematics(torch.zeros(3, kt.n_dof)).spheres
    assert torch.equal(tsc.self_collision_cost(empty, spheres, 0.1), torch.zeros(3))
    assert torch.equal(tsc.self_collision_distance(empty, spheres), torch.zeros(3))
