"""The plain reference against the program's CPU path at a small size: the
same robot and world give the same kinematics, spheres, pairs and
distances. (The tests may import the program; the reference may not.)"""

import os

import numpy as np
import pytest
import torch

from benchmark.reference import scene
from benchmark.reference.robot import Robot, pose_errors, rpy_matrix

from .conftest import ROOT

FRANKA = os.path.join(ROOT, "benchmark", "configs", "data", "franka.yml")


@pytest.fixture(scope="module")
def both():
    import curobo_tpu_torch as ct
    from curobo_tpu_torch.ops import ik_kernels as ikk

    kin = ct.Kinematics.from_robot_yaml(FRANKA, device="cpu")
    tab = ikk.build_ik_tables(kin.params, ct.IKConfig().rollout, "cpu")
    ref = Robot(FRANKA)
    g = torch.Generator().manual_seed(3)
    q = ref.lower + (ref.upper - ref.lower) * torch.rand(48, ref.n_dof, dtype=torch.float64, generator=g)
    return kin, tab, ref, q


def test_rpy_matches_the_program():
    from curobo_tpu_torch.robot.urdf import rpy_to_matrix

    for rpy in ([0.3, -1.2, 2.0], [1.5707963, 0.0, -0.7853981], [0.0, 0.0, 0.0]):
        assert np.allclose(rpy_matrix(rpy).numpy(), rpy_to_matrix(np.asarray(rpy)), atol=1e-12)


def test_tool_pose_and_limits(both):
    kin, _, ref, q = both
    st = kin.compute_kinematics(q.float())
    pos, quat = ref.tool_pose(q)
    assert (st.tool_pose.position[:, 0].double() - pos).abs().max() < 1e-6
    pe, re = pose_errors(st.tool_pose.position[:, 0].double(), st.tool_pose.quaternion[:, 0].double(), pos, quat)
    assert pe.max() < 1e-6 and re.max() < 1e-5
    lim = kin.params.joint_limits
    for mine, theirs in ((ref.lower, lim.lower), (ref.upper, lim.upper), (ref.velocity, lim.velocity),
                         (ref.acceleration, lim.acceleration), (ref.jerk, lim.jerk)):
        assert torch.allclose(mine.float(), theirs)
    assert torch.allclose(ref.retract.float(), kin.params.retract_config)


def test_spheres_pairs_and_self_slack(both):
    from curobo_tpu_torch.ops import ik_kernels as ikk

    _, tab, ref, q = both
    assert tab.P == len(ref.pair_margin) == 694
    assert int((tab.sph_f[:, 3] >= 0).sum()) == len(ref.sphere_radius) == 61
    assert tab.S == ref.n_sphere_slots == 65
    R, p = ikk._fk_plain(tab, q.float())
    sl = tab.sph_link.long()
    centres = (R[:, sl] @ tab.sph_f[:, 0:3, None])[..., 0] + p[:, sl]
    live = tab.sph_f[:, 3] >= 0
    mine = ref.spheres(q)
    assert (centres[:, live].double() - mine).abs().max() < 1e-6
    # the same pairs: each live pair of the program's table, as sphere indices
    # among the enabled spheres, with the same margin
    enabled = torch.nonzero(live)[:, 0].tolist()
    to_ref = {s: i for i, s in enumerate(enabled)}
    theirs = {(to_ref[int(a)], to_ref[int(b)]): float(m) for (a, b), m in zip(tab.pair_i, tab.pair_m)}
    ours = {(int(a), int(b)): float(m) for a, b, m in zip(ref.pair_a, ref.pair_b, ref.pair_margin)}
    assert theirs.keys() == ours.keys()
    assert max(abs(theirs[k] - ours[k]) for k in ours) < 1e-6
    dd = centres[:, tab.pair_i[:, 0].long()] - centres[:, tab.pair_i[:, 1].long()]
    viol = (tab.pair_m - torch.sqrt((dd * dd).sum(-1) + 1e-12)).amax(-1)
    assert (viol.double() + ref.self_slack(mine)).abs().max() < 1e-6


def test_cuboid_and_sphere_distances():
    import curobo_tpu_torch as ct
    from curobo_tpu_torch.ops import ik_kernels as ikk

    from benchmark.drivers.common import program_scene

    obstacles = [
        dict(type="cuboid", name="table", pose=[0.4, 0.0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        dict(type="cuboid", name="tilted", pose=[0.5, -0.3, 0.4, 0.9239, 0.0, 0.3827, 0.0],
             dims=[0.1, 0.3, 0.2]),
        dict(type="sphere", name="drone", pose=[0.5, 0.4, 0.6, 1, 0, 0, 0], radius=0.08),
    ]
    world = ct.compile_scene(program_scene(obstacles), device="cpu")
    g = torch.Generator().manual_seed(4)
    pts = torch.rand(2000, 3, dtype=torch.float64, generator=g) * torch.tensor([1.4, 1.6, 1.0], dtype=torch.float64) \
        + torch.tensor([-0.3, -0.8, -0.3], dtype=torch.float64)
    theirs = ikk._scene_msdf_plain(ikk.pack_world_arrays(world), pts.float()).double()
    mine = scene.signed_distance(pts, obstacles)
    # the program's distance adds sqrt(1e-12) = 1e-6 m under its square root
    assert (theirs - mine).abs().max() < 5e-6
    assert (mine < 0).any() and (mine > 0).any()
