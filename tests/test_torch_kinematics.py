"""Forward kinematics of the PyTorch package against the JAX package on the
CPU: tool pose, link frames and sphere centres for the Franka, the UR10e, the
mimic robot (mimic and locked joints) and the dual-arm UR10e (two tool frames),
on 256 random configurations made from a seed with numpy.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.robot.kinematics import compute_kinematics as jfk

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")
ROBOTS = ("franka", "ur10e", "simple_mimic_robot", "dual_ur10e")
# float32 chains of up to 15 link compositions, summed in another order
ATOL = 1e-5


@pytest.fixture(scope="module", params=ROBOTS)
def fk_pair(request):
    robot = request.param
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, robot + ".yml"))
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path(robot), device="cpu")
    rng = np.random.RandomState(7)
    lo = np.maximum(np.asarray(kj.params.joint_limits.lower), -3.0)
    hi = np.minimum(np.asarray(kj.params.joint_limits.upper), 3.0)
    q = rng.uniform(lo, hi, (256, kj.n_dof)).astype(np.float32)
    return kj, kt, jfk(kj.params, jnp.asarray(q)), kt.compute_kinematics(torch.as_tensor(q))


def test_tool_pose_matches_jax(fk_pair):
    _, _, sj, st = fk_pair
    np.testing.assert_allclose(st.tool_pose.position.numpy(), np.asarray(sj.tool_pose.position), atol=ATOL)
    qj, qt = np.asarray(sj.tool_pose.quaternion), st.tool_pose.quaternion.numpy()
    # q and -q are the same rotation; both packages keep w >= 0, which leaves
    # the sign open only at w ~ 0
    dot = np.abs(np.sum(qj * qt, axis=-1))
    np.testing.assert_allclose(dot, 1.0, atol=ATOL)


def test_link_frames_match_jax(fk_pair):
    _, _, sj, st = fk_pair
    np.testing.assert_allclose(st.link_rot.numpy(), np.asarray(sj.link_rot), atol=ATOL)
    np.testing.assert_allclose(st.link_pos.numpy(), np.asarray(sj.link_pos), atol=ATOL)


def test_sphere_centres_match_jax(fk_pair):
    kj, _, sj, st = fk_pair
    assert st.spheres.shape == (256, kj.params.n_spheres, 4)
    np.testing.assert_allclose(st.spheres.numpy(), np.asarray(sj.spheres), atol=ATOL)


def test_static_topology_matches_jax(fk_pair):
    kj, kt, _, _ = fk_pair
    for name in ("link_names", "joint_names", "parent_idx", "joint_type", "dof_idx", "levels",
                 "sphere_link_idx", "tool_frame_idx", "base_link", "robot_name"):
        assert getattr(kj.params, name) == getattr(kt.params, name), name
    lo_j, hi_j = kj.params.dof_clip_bounds()
    lo_t, hi_t = kt.params.dof_clip_bounds()
    assert np.array_equal(lo_j, lo_t) and np.array_equal(hi_j, hi_t)


def test_leading_batch_dims_fold():
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    q = torch.zeros(2, 3, kt.n_dof)
    st = kt.compute_kinematics(q)
    assert st.tool_pose.position.shape == (2, 3, 1, 3)
    assert st.link_rot.shape == (2, 3, kt.params.n_links, 3, 3)
    assert kt.tool_pose(q).quaternion.shape == (2, 3, 1, 4)


def test_what_waits_raises(tmp_path):
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"), device="cpu")
    # the analytic Jacobian is ported (tests/test_torch_lm.py holds it to JAX)
    st = kt.compute_kinematics(torch.zeros(1, kt.n_dof), compute_jacobian=True)
    assert st.jacobian.shape == (1, 1, 6, kt.n_dof) and torch.isfinite(st.jacobian).all()
    assert kt.compute_kinematics(torch.zeros(1, kt.n_dof)).jacobian is None
    # URDF loading is ported (tests/test_torch_urdf.py holds it to JAX)
    urdf = tmp_path / "robot.urdf"
    urdf.write_text(
        '<robot name="r"><link name="base"/><link name="tool"/>'
        '<joint name="j" type="revolute"><parent link="base"/><child link="tool"/>'
        '<axis xyz="0 0 1"/><limit lower="-1" upper="1" velocity="1" effort="1"/></joint></robot>'
    )
    cfg = ct.RobotModelConfig.from_urdf(str(urdf), "base", ["tool"])
    assert cfg.actuated_joints == ["j"] and cfg.asset_root == str(tmp_path)
    assert ct.build_kinematics_params(cfg, device="cpu").n_dof == 1
    with pytest.raises(ValueError, match="trailing dimension"):
        kt.compute_kinematics(torch.zeros(1, kt.n_dof + 1))


def test_model_config_errors_name_the_cause():
    cfg = ct.RobotModelConfig.from_yaml(ct.robot_config_path("ur10e"))
    import dataclasses

    with pytest.raises(ValueError, match="tool frame"):
        ct.build_kinematics_params(dataclasses.replace(cfg, tool_frames=["nope"]), device="cpu")
    with pytest.raises(ValueError, match="not actuated"):
        cfg.with_locked_joints(["nope"])
    locked = cfg.with_locked_joints([cfg.actuated_joints[0]])
    p = ct.build_kinematics_params(locked, device="cpu")
    assert p.n_dof == len(cfg.actuated_joints) - 1
