"""The USD exporter and viewer facade of the PyTorch package held against the
JAX package on the CPU: the `.usda` text of a scene with an obstacle of each
type and a short Franka trajectory (the per-link stage and the flat sphere
view), and of a robot with visual meshes, equals the JAX writer's line for
line, numbers within 1e-5; `show_viser` raises `ImportError` in both
packages (`viser` is not installed). A mesh obstacle given by a file is read
by the port (`geom/mesh.load_mesh`), where the JAX writer needs `trimesh`.
"""

import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu import viewer as jviewer
from curobo_tpu.geom import types as jgt
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu.robot.model import RobotModelConfig as JCfg
from curobo_tpu.types.state import JointState as JJointState
from curobo_tpu.util import usd_export as jusd
from curobo_tpu_torch import viewer as tviewer
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.util import usd_export as tusd

sys.path.insert(0, os.path.dirname(__file__))
from _perception_scenes import box_mesh  # noqa: E402
from _urdf_text import MIXED_URDF  # noqa: E402

JAX_ROBOTS = os.path.join(os.path.dirname(__file__), "..", "curobo_tpu", "content", "robots")
NUM = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")


def _scene(gt):
    v, f = box_mesh((0.05, 0.05, 0.1))
    grid = np.ones((4, 4, 4), np.float32)
    grid[1:3, 1:3, 1:3] = -0.02
    return gt.Scene().add(
        gt.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
        gt.SphereObstacle(name="ball", pose=[0.2, 0.3, 0.5, 1, 0, 0, 0], radius=0.1),
        gt.Capsule(name="cap", pose=[0, 1, 0, 0.9239, 0.3827, 0, 0], radius=0.05,
                   base=(0, 0, 0), tip=(0, 0.3, 0.1)),
        gt.Capsule(name="cap-down", pose=[0, 1, 0.5, 1, 0, 0, 0], radius=0.05,
                   base=(0, 0, 0.2), tip=(0, 0, 0)),
        gt.Cylinder(name="cyl", pose=[0, -1, 0, 0.9659, 0, 0.2588, 0], radius=0.05, height=0.3),
        gt.MeshObstacle(name="box mesh", pose=[0.5, 0.5, 0.2, 1, 0, 0, 0], vertices=v, faces=f),
        gt.PointCloudObstacle(name="pc", pose=[0, 0, 2, 1, 0, 0, 0],
                              points=np.asarray([[0.0, 0, 0], [0.05, 0, 0], [0, 0.05, 0.01]])),
        gt.VoxelGridObstacle(name="vox", pose=[1, 0, 0, 1, 0, 0, 0], dims=(0.4, 0.4, 0.4),
                             voxel_size=0.1, data=grid),
    )


def _same_text(a: str, b: str, atol=1e-5):
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert NUM.sub("#", x) == NUM.sub("#", y), (x, y)
        np.testing.assert_allclose([float(v) for v in NUM.findall(x)],
                                   [float(v) for v in NUM.findall(y)], atol=atol, err_msg=x)


def _traj(q):
    return (ct.JointState.from_position(torch.as_tensor(q)),
            JJointState.from_position(jnp.asarray(q)))


@pytest.fixture(scope="module")
def franka():
    kt = ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu")
    kj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "franka.yml"))
    q0 = kt.params.retract_config.numpy()
    q = np.linspace(q0, q0 + 0.3, 4).astype(np.float32)
    return kt, kj, q


@pytest.mark.parametrize("flat", [False, True])
def test_plan_export_matches_jax(tmp_path, franka, flat):
    kt, kj, q = franka
    tt, tj = _traj(q[None])  # (B, H, D): the first problem is exported
    pt, pj = str(tmp_path / "t.usda"), str(tmp_path / "j.usda")
    tusd.export_plan_usd(pt, _scene(tgt), kt.params, tt, flat_spheres=flat)
    jusd.export_plan_usd(pj, _scene(jgt), kj.params, tj, flat_spheres=flat)
    a, b = open(pt).read(), open(pj).read()
    _same_text(a, b)
    for prim in ('def Cube "table"', 'def Capsule "cap"', 'def Cylinder "cyl"', 'def Mesh "box_mesh"',
                 'def Points "pc"', 'def Points "vox"', "timeSamples"):
        assert prim in a, prim
    assert ("robot_sphere_0" in a) == flat and ('def Xform "robot_panda_link0"' in a) != flat


def test_robot_visual_meshes_match_jax(tmp_path):
    """A robot loaded from a URDF whose link has an OBJ visual: both writers
    put the mesh, origin and scale baked in, under the link's Xform."""
    v, f = box_mesh((0.02, 0.03, 0.04))
    (tmp_path / "meshes").mkdir()
    with open(tmp_path / "meshes" / "slider.obj", "w") as fh:
        fh.writelines([f"v {float(a)!r} {float(b)!r} {float(c)!r}\n" for a, b, c in v])
        fh.writelines([f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f])
    path = tmp_path / "mixed.urdf"
    path.write_text(MIXED_URDF.replace("slider.stl", "slider.obj"))
    args = (str(path), "base", ["tool"])
    kt = ct.Kinematics.from_robot_config(ct.RobotModelConfig.from_urdf(*args), device="cpu")
    kj = JKin.from_robot_config(JCfg.from_urdf(*args))
    q = np.linspace(np.zeros(3), [0.3, 1.0, -0.5], 3).astype(np.float32)
    tt, tj = _traj(q)
    pt, pj = str(tmp_path / "t.usda"), str(tmp_path / "j.usda")
    tviewer.export_usd(pt, ct.Scene(), kt.params, tt, kin=kt)
    jviewer.export_usd(pj, jgt.Scene(), kj.params, tj, kin=kj)
    a = open(pt).read()
    _same_text(a, open(pj).read())
    assert 'def Xform "robot_slider"' in a and 'def Mesh "visual_0"' in a


def test_mesh_file_obstacle_is_read(tmp_path):
    v, f = box_mesh((0.05, 0.05, 0.1))
    p = tmp_path / "box.obj"
    p.write_text("".join(f"v {float(a)!r} {float(b)!r} {float(c)!r}\n" for a, b, c in v)
                 + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f))
    w = tusd.UsdWriter()
    w.add_obstacle(tgt.MeshObstacle(name="from_file", file_path=str(p)))
    w.add_obstacle(tgt.MeshObstacle(name="inline", vertices=v, faces=f))
    out = str(tmp_path / "m.usda")
    w.save(out)
    blocks = open(out).read().split("def Mesh")
    assert len(blocks) == 3 and NUM.findall(blocks[1].split("\n", 1)[1]) == NUM.findall(
        blocks[2].split("\n", 1)[1])
    with pytest.raises(FileNotFoundError):
        tusd.UsdWriter().add_obstacle(tgt.MeshObstacle(name="gone", file_path=str(tmp_path / "no.obj")))


def test_show_viser_raises_without_viser(franka):
    kt, kj, _ = franka
    with pytest.raises(ImportError, match="viser"):
        tviewer.show_viser(ct.Scene(), kt.params)
    with pytest.raises(ImportError, match="viser"):
        jviewer.show_viser(jgt.Scene(), kj.params)
