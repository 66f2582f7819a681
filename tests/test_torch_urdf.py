"""URDF loading of the PyTorch package held against the JAX package on the
CPU: the parser is a byte-identical copy; `RobotModelConfig.from_urdf` gives
the same `KinematicsParams` and the same FK; the port's `build_config` (its
copy of `tools/import_urdf.py`) gives the same config dicts, the
floating-base chain annex and XRDF annexes included. The URDF text is written
by the tests (`_urdf_text.py`): the repository ships no URDF.
"""

import dataclasses
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.robot import urdf as jurdf
from curobo_tpu.robot.kinematics import compute_kinematics as jfk
from curobo_tpu.robot.model import RobotModelConfig as JCfg
from curobo_tpu.robot.model import build_kinematics_params as jbuild
from curobo_tpu_torch.robot import import_urdf as timp
from curobo_tpu_torch.robot import urdf as turdf
from curobo_tpu_torch.util.config_io import load_yaml
from curobo_tpu_torch.util.sampling import halton_sequence

sys.path.insert(0, os.path.dirname(__file__))
from _urdf_text import MIXED_URDF, urdf_of_robot_yaml  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _tools_import_urdf():
    """`tools/import_urdf.py`, the JAX package's importer, as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_import_urdf", os.path.join(ROOT, "tools", "import_urdf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JIMP = _tools_import_urdf()

# (robot YAML, tool frames, whether to pass the YAML's locks): the Franka's
# chain, the mimic robot's chain with its mimic joint locked through its source
# (the YAML's model) and live (mimic follows an actuated source)
YAML_CASES = {
    "franka": ("franka", True),
    "mimic_locked": ("simple_mimic_robot", True),
    "mimic_live": ("simple_mimic_robot", False),
}
# the YAML fields passed to from_urdf beside the URDF
CARRIED = ("retract_config", "cspace_weight", "null_space_weight", "self_collision_ignore",
           "self_collision_buffer", "sphere_buffer", "extra_collision_spheres",
           "max_acceleration", "max_jerk", "velocity_scale")


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _case_configs(tmp_path, case):
    """(port config, JAX config) of one case, both from_urdf over one file."""
    if case == "mixed":
        path = _write(tmp_path, "mixed.urdf", MIXED_URDF)
        args = (path, "base", ["tool", "camera"])
        kw = dict(collision_spheres={"elbow": [{"center": [0.1, 0, 0], "radius": 0.04}],
                                     "slider": [{"center": [0, 0, 0.05], "radius": 0.05}],
                                     "base": [{"center": [0, 0, 0.05], "radius": 0.08}]})
        return ct.RobotModelConfig.from_urdf(*args, **kw), JCfg.from_urdf(*args, **kw)
    robot, locks = YAML_CASES[case]
    y = ct.RobotModelConfig.from_yaml(ct.robot_config_path(robot))
    path = _write(tmp_path, robot + ".urdf", urdf_of_robot_yaml(load_yaml(ct.robot_config_path(robot))))
    kw = {k: getattr(y, k) for k in CARRIED}
    if not locks:
        kw["retract_config"] = None  # one more dof: the mimic's live source
    kw.update(collision_spheres=y.collision_spheres, lock_joints=y.lock_joints if locks else None)
    args = (path, y.base_link, y.tool_frames)
    return ct.RobotModelConfig.from_urdf(*args, **kw), JCfg.from_urdf(*args, **kw)


def _assert_same(a, b, where=""):
    """Port value (tensors, dataclasses, tuples) equals the JAX value."""
    if isinstance(a, torch.Tensor):
        x, y = a.numpy(), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, where
        np.testing.assert_array_equal(x, y, err_msg=where)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    else:
        assert a == b, (where, a, b)


def test_parser_is_a_byte_identical_copy():
    with open(os.path.join(ROOT, "curobo_tpu", "robot", "urdf.py"), "rb") as f, \
            open(turdf.__file__, "rb") as g:
        assert f.read() == g.read()


def test_parse_urdf_string_matches_jax():
    text = urdf_of_robot_yaml(load_yaml(ct.robot_config_path("franka")))
    for t in (text, MIXED_URDF):
        a, b = turdf.parse_urdf_string(t), jurdf.parse_urdf_string(t)
        assert a.name == b.name and list(a.links) == list(b.links) and list(a.joints) == list(b.joints)
        for name in a.joints:
            ja, jb = dataclasses.asdict(a.joints[name]), dataclasses.asdict(b.joints[name])
            assert ja.keys() == jb.keys()
            for k in ja:
                np.testing.assert_array_equal(ja[k], jb[k], err_msg=f"{name}.{k}")
        for name in a.links:
            la, lb = dataclasses.asdict(a.links[name]), dataclasses.asdict(b.links[name])
            assert repr(la) == repr(lb), name
        assert a.root_link() == b.root_link()
    with pytest.raises(ValueError, match="robot"):
        turdf.parse_urdf_string("<model/>")


@pytest.mark.parametrize("case", ["franka", "mimic_locked", "mimic_live", "mixed"])
def test_from_urdf_params_and_fk_match_jax(tmp_path, case):
    """Every field of `build_kinematics_params`, and FK on Halton
    configurations within 1e-6."""
    ct_cfg, j_cfg = _case_configs(tmp_path, case)
    assert [dataclasses.asdict(l) for l in ct_cfg.links] == [dataclasses.asdict(l) for l in j_cfg.links]
    assert ct_cfg.actuated_joints == j_cfg.actuated_joints
    pt, pj = ct.build_kinematics_params(ct_cfg, device="cpu"), jbuild(j_cfg)
    _assert_same(pt, pj, case)
    lo, hi = pt.dof_clip_bounds(angular_cap=np.pi)
    q = (lo + (hi - lo) * halton_sequence(64, pt.n_dof)).astype(np.float32)
    st, sj = ct.compute_kinematics(pt, torch.as_tensor(q)), jfk(pj, jnp.asarray(q))
    for name in ("link_pos", "link_rot", "spheres"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)), atol=1e-6)
    np.testing.assert_allclose(st.tool_pose.quaternion.numpy(), np.asarray(sj.tool_pose.quaternion),
                               atol=1e-6)
    if case == "mimic_live":
        assert pt.joint_names == ("chain_1_active_joint_1", "active_joint_2")


def test_from_urdf_defaults(tmp_path, monkeypatch):
    """Locked and mimic joints leave the default dof list; the asset root is
    the URDF's directory unless CUROBO_TORCH_ASSET_ROOT names another;
    ``package://`` is stripped from visual meshes."""
    path = _write(tmp_path, "mixed.urdf", MIXED_URDF)
    monkeypatch.delenv("CUROBO_TORCH_ASSET_ROOT", raising=False)
    cfg = ct.RobotModelConfig.from_urdf(path, "base", ["tool"], lock_joints={"spin": 0.3})
    assert cfg.actuated_joints == ["lift", "bend"] and cfg.asset_root == str(tmp_path)
    vis = {l.name: l.visual for l in cfg.links}["slider"]
    assert vis[0]["mesh"] == "meshes/slider.stl" and vis[0]["scale"] == [0.001, 0.001, 0.001]
    monkeypatch.setenv("CUROBO_TORCH_ASSET_ROOT", "/assets")
    assert ct.RobotModelConfig.from_urdf(path, "slider", ["tool"]).asset_root == "/assets"
    sub = ct.RobotModelConfig.from_urdf(path, "slider", ["tool"])
    assert [l.name for l in sub.links][0] == "slider" and "camera" not in [l.name for l in sub.links]
    kin = ct.Kinematics.from_robot_config(cfg, device="cpu")
    assert kin.visuals["slider"][0]["mesh"] == "meshes/slider.stl"


# a cuRobo-style annex: spheres, ignore lists, buffers, locks, a cspace in its
# own joint order, an extra fixed link and a floating-base chain (x, y, yaw)
# re-rooting the URDF's base link
ANNEX = {"robot_cfg": {"kinematics": {
    "collision_spheres": {"elbow": [{"center": [0.1, 0, 0], "radius": 0.04}],
                          "slider": [{"center": [0, 0, 0.05], "radius": 0.05}]},
    "self_collision_ignore": {"slider": ["elbow"]},
    "self_collision_buffer": {"elbow": 0.01},
    "collision_sphere_buffer": 0.004,
    "lock_joints": {"spin": 0.25},
    "cspace": {"joint_names": ["bend", "lift", "base_x", "base_y", "base_yaw"],
               "default_joint_position": [0.3, 0.1, 0.0, 0.0, 0.0],
               "max_acceleration": [5.0, 6.0, 7.0, 8.0, 9.0], "max_jerk": 400.0,
               "cspace_distance_weight": [1.0, 2.0, 3.0, 4.0, 5.0],
               "null_space_weight": [1.0, 1.0, 1.0, 1.0, 1.0]},
    "extra_collision_spheres": {"attached": 2},
    "extra_links": {
        "attached": {"link_name": "attached", "parent_link_name": "elbow",
                     "fixed_transform": [0, 0, 0.1, 0.9659258, 0, 0.258819, 0]},
        "base_x": {"link_name": "base_x_link", "parent_link_name": "world", "joint_name": "base_x",
                   "joint_type": "X_PRISM", "joint_limits": [-2.0, 2.0],
                   "joint_velocity_limits": [-1.0, 1.0]},
        "base_y": {"link_name": "base_y_link", "parent_link_name": "base_x_link",
                   "joint_name": "base_y", "joint_type": "Y_PRISM", "joint_limits": [-2.0, 2.0]},
        "base_yaw": {"link_name": "base_yaw_link", "parent_link_name": "base_y_link",
                     "joint_name": "base_yaw", "joint_type": "Z_ROT",
                     "fixed_transform": [0, 0, 0.05, 1, 0, 0, 0], "child_link_name": "base"},
    }}}}

XRDF = {"format": "xrdf", "format_version": 1.0,
        "cspace": {"joint_names": ["lift", "bend"], "acceleration_limits": [3.0, 4.0],
                   "jerk_limits": [300.0, 400.0]},
        "default_joint_positions": {"lift": 0.2, "bend": -0.3},
        "tool_frames": ["tool"],
        "modifiers": [{"set_base_frame": "base"}],
        "geometry": {"arm": {"spheres": {"elbow": [{"center": [0.0, 0.0, 0.0], "radius": 0.05}]}}},
        "collision": {"geometry": "arm", "buffer_distance": 0.01},
        "self_collision": {"geometry": "arm", "ignore": {"elbow": ["slider"]},
                           "buffer_distance": {"elbow": 0.02}}}


@pytest.mark.parametrize("case", ["franka", "mixed", "mixed_annex", "floating_base", "xrdf"])
def test_build_config_matches_tools_import_urdf(tmp_path, case):
    if case == "franka":
        path = _write(tmp_path, "franka.urdf", urdf_of_robot_yaml(load_yaml(ct.robot_config_path("franka"))))
        args = (path, "panda_link0", ["panda_hand"])
        kw = {}
    else:
        path = _write(tmp_path, "mixed.urdf", MIXED_URDF)
        base = "world" if case == "floating_base" else "base"
        args = (path, base, ["tool"])
        annex = ANNEX if case != "xrdf" else None
        if case == "mixed_annex":
            kin = dict(ANNEX["robot_cfg"]["kinematics"])
            kin["extra_links"] = {"attached": kin["extra_links"]["attached"]}
            kin["cspace"] = dict(kin["cspace"], joint_names=["bend", "lift"],
                                 default_joint_position=[0.3, 0.1])
            annex = {"robot_cfg": {"kinematics": kin}}
        if case == "xrdf":
            annex = timp.xrdf_to_annex(XRDF)
            assert annex == JIMP.xrdf_to_annex(XRDF)
        kw = dict(annex=annex) if case != "mixed" else dict(keep_links=["slider", "bracket", "spinner"])
    a, b = timp.build_config(*args, **kw), JIMP.build_config(*args, **kw)
    assert a == b
    if case == "floating_base":
        names = [l["name"] for l in a["robot"]["links"]]
        assert names[:4] == ["world", "base_x_link", "base_y_link", "base_yaw_link"]
        assert a["robot"]["actuated_joints"][:3] == ["base_x", "base_y", "base_yaw"]
        params = ct.build_kinematics_params(ct.RobotModelConfig.from_dict(a), device="cpu")
        assert params.n_dof == 5 and "attached" in params.link_names


def test_import_urdf_main_writes_the_yaml(tmp_path, monkeypatch):
    path = _write(tmp_path, "mixed.urdf", MIXED_URDF)
    xrdf = tmp_path / "mixed.xrdf"
    xrdf.write_text(yaml.safe_dump(XRDF))
    out = tmp_path / "mixed.yml"
    monkeypatch.setattr(sys, "argv", ["import_urdf", path, "--base-link", "base", "--tool-frames",
                                      "tool", "--annex", str(xrdf), "--out", str(out), "--name", "m"])
    timp.main()
    cfg = load_yaml(str(out))
    assert cfg["robot"]["name"] == "m"
    assert cfg["robot"]["collision"]["spheres"]["elbow"][0]["radius"] == 0.05
    ref = JIMP.build_config(path, "base", ["tool"], annex=JIMP.xrdf_to_annex(XRDF))
    ref["robot"]["name"] = "m"
    assert cfg == ref
