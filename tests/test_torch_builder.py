"""The robot builder and debugger of the PyTorch package held against the JAX
package on the CPU: `RobotBuilder.build` gives the same config dict (skeleton
spheres, the ignore matrix with its retract iteration) on the 3-dof arm of
`examples/build_robot_model.py` and on a Franka URDF written from
`franka.yml`; the mesh fit of a link with an OBJ collision mesh gives the
same sphere counts and a fit loss within 10 % of the JAX fit's (float32 fits
part by millimetres, `tests/test_torch_mesh.py`); a mesh that does not load
raises where the JAX builder skips it; `RobotDebugger.report` equals the JAX
report on `franka.yml` and on the three broken models of
`tests/test_robot_debugger.py`.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.robot.builder import BuilderConfig as JBuilderConfig
from curobo_tpu.robot.builder import RobotBuilder as JBuilder
from curobo_tpu.robot.debugger import RobotDebugger as JDebugger
from curobo_tpu.robot.kinematics import Kinematics as JKin
from curobo_tpu_torch.geom import sphere_fit as tfit
from curobo_tpu_torch.geom import types as tgt
from curobo_tpu_torch.robot.builder import BuilderConfig, RobotBuilder
from curobo_tpu_torch.robot.debugger import RobotDebugger
from curobo_tpu_torch.util.config_io import load_yaml

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "..", "examples"))
from _perception_scenes import box_mesh  # noqa: E402
from _urdf_text import urdf_of_robot_yaml  # noqa: E402
from build_robot_model import DEMO_URDF  # noqa: E402

JAX_ROBOTS = os.path.join(HERE, "..", "curobo_tpu", "content", "robots")


def _urdf(tmp_path, case):
    """(path, base link, tool frames) of a builder case."""
    if case == "demo":
        text, base, tools = DEMO_URDF, "base_link", ["tool"]
    else:
        text = urdf_of_robot_yaml(load_yaml(ct.robot_config_path("franka")))
        base, tools = "panda_link0", ["panda_hand"]
    p = tmp_path / f"{case}.urdf"
    p.write_text(text)
    return str(p), base, tools


@pytest.mark.parametrize("case", ["demo", "franka"])
def test_build_matches_jax(tmp_path, case):
    """Skeleton spheres (no mesh resolves), the ignore matrix, the retract
    iteration and the written YAML; the retract check of the built model."""
    path, base, tools = _urdf(tmp_path, case)
    bt = RobotBuilder(path, base, tools, BuilderConfig(spheres_per_link=4), device="cpu")
    bj = JBuilder(path, base, tools, JBuilderConfig(spheres_per_link=4))
    out = tmp_path / "built.yml"
    cfg = bt.build(out_path=str(out), name=case)
    assert cfg == bj.build(name=case)
    assert load_yaml(str(out)) == cfg
    # the retract iteration ran: pairs in contact at retract joined the
    # adjacency ignore list, and the built model is clean there
    adjacency = bt.auto_self_collision_ignore(bt.generate_spheres())
    ignore = cfg["robot"]["collision"]["self_collision_ignore"]
    if case == "franka":
        assert sum(map(len, ignore.values())) > sum(map(len, adjacency.values()))
    rep_t, rep_j = bt.debug_retract_pose(cfg), bj.debug_retract_pose(cfg)
    assert rep_t.keys() == rep_j.keys() and rep_t["retract_ok"] and rep_j["retract_ok"]
    for k in rep_t:
        assert rep_t[k] == pytest.approx(rep_j[k], abs=1e-6), k
    kin = ct.Kinematics.from_robot_yaml(str(out), device="cpu")
    assert kin.params.n_spheres == sum(len(v) for v in cfg["robot"]["collision"]["spheres"].values())
    if not torch.cuda.is_available():  # no device named: the card, which is not here
        with pytest.raises(RuntimeError, match="CUDA"):
            RobotBuilder(path, base, tools)


def _obj_text(v, f):
    lines = [f"v {float(x)!r} {float(y)!r} {float(z)!r}" for x, y, z in np.asarray(v, np.float64)]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in np.asarray(f)]
    return "\n".join(lines) + "\n"


def _mesh_urdf(tmp_path, mesh_name):
    """The demo arm with an OBJ collision mesh on link2 (a 5 x 6 x 25 cm box,
    named ``package://demo/meshes/...``, resolved against the URDF's
    directory) and a DAE visual on link1 (not OBJ/STL: skipped)."""
    v, f = box_mesh((0.025, 0.03, 0.125))
    meshes = tmp_path / "demo" / "meshes"
    meshes.mkdir(parents=True, exist_ok=True)
    (meshes / "link2.obj").write_text(_obj_text(v + np.array([0, 0, 0.125]), f))
    (meshes / "broken.obj").write_text("this is not a mesh\n")
    (meshes / "link1.dae").write_text("<COLLADA/>\n")
    text = DEMO_URDF.replace(
        '<link name="link2"/>',
        '<link name="link2"><collision><geometry><mesh filename="package://demo/meshes/'
        f'{mesh_name}"/></geometry></collision></link>').replace(
        '<link name="link1"/>',
        '<link name="link1"><visual><geometry><mesh filename="demo/meshes/link1.dae"/>'
        '</geometry></visual></link>')
    p = tmp_path / "mesh_arm.urdf"
    p.write_text(text)
    return str(p)


def test_mesh_fit_matches_jax_within_the_float32_gap(tmp_path):
    path = _mesh_urdf(tmp_path, "link2.obj")
    cfg = BuilderConfig(spheres_per_link=6, mesh_voxel_size=0.01)
    jcfg = JBuilderConfig(spheres_per_link=6, mesh_voxel_size=0.01)
    bt = RobotBuilder(path, "base_link", ["tool"], cfg, device="cpu")
    st = bt.generate_spheres()
    sj = JBuilder(path, "base_link", ["tool"], jcfg).generate_spheres()
    assert {k: len(v) for k, v in st.items()} == {k: len(v) for k, v in sj.items()}
    # link2 is the fit's (6 spheres of several radii), the rest the skeleton's
    assert st["link2"] != bt._skeleton_spheres()["link2"]
    assert len({s["radius"] for s in st["link2"]}) > 1
    assert st["link1"] == sj["link1"] and st["base_link"] == sj["base_link"]
    mesh = tgt.MeshObstacle(name="link2", file_path=str(tmp_path / "demo" / "meshes" / "link2.obj"),
                            voxel_size=0.01)
    c0, r0, loss = tfit._fit_problem(mesh, tfit.SphereFitConfig(n_spheres=6), torch.device("cpu"))

    def fit_loss(spheres):
        c = torch.tensor([s["center"] for s in spheres], dtype=torch.float32)
        r = torch.tensor([s["radius"] for s in spheres], dtype=torch.float32)
        return float(loss(c, r))

    lt, lj = fit_loss(st["link2"]), fit_loss(sj["link2"])
    l0 = float(loss(torch.as_tensor(c0), torch.as_tensor(r0)))
    assert lt < l0 and lj < l0 and abs(lt - lj) <= 0.1 * lj, (l0, lt, lj)


def test_mesh_that_does_not_load_raises(tmp_path):
    """No fallback: the JAX builder skips a mesh whose fit fails (skeleton
    spheres), the port raises."""
    path = _mesh_urdf(tmp_path, "broken.obj")
    bj = JBuilder(path, "base_link", ["tool"])
    assert bj.generate_spheres()["link2"] == bj._skeleton_spheres()["link2"]
    with pytest.raises(ValueError):
        RobotBuilder(path, "base_link", ["tool"], device="cpu").generate_spheres()


@pytest.fixture(scope="module")
def franka_pair():
    return (JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, "franka.yml")).params,
            ct.Kinematics.from_robot_yaml(ct.robot_config_path("franka"), device="cpu").params)


def _broken(pj, pt, case):
    if case == "clean":
        return pj, pt
    if case == "retract_outside_limits":
        return (dataclasses.replace(pj, retract_config=jnp.asarray(pj.joint_limits.upper) + 1.0),
                dataclasses.replace(pt, retract_config=pt.joint_limits.upper + 1.0))
    if case == "degenerate_sphere":
        radii = np.asarray(pj.sphere_radii).copy()
        radii[0] = 1e-6
        return (pj.update_spheres(pj.sphere_centers, jnp.asarray(radii)),
                pt.update_spheres(pt.sphere_centers, torch.as_tensor(radii)))
    margin = np.asarray(pj.self_collision.pair_margin) + 10.0
    return (dataclasses.replace(pj, self_collision=dataclasses.replace(
                pj.self_collision, pair_margin=jnp.asarray(margin))),
            dataclasses.replace(pt, self_collision=dataclasses.replace(
                pt.self_collision, pair_margin=torch.as_tensor(margin))))


@pytest.mark.parametrize("case", ["clean", "retract_outside_limits", "degenerate_sphere",
                                  "overtight_self_collision"])
def test_debugger_report_matches_jax(franka_pair, case):
    pj, pt = _broken(*franka_pair, case)
    n = 256 if case == "clean" else 32
    rj, rt = JDebugger(pj).report(n_samples=n), RobotDebugger(pt).report(n_samples=n)
    assert rt.ok == rj.ok and rt.issues == rj.issues, (rt.issues, rj.issues)
    for k in ("n_dof", "n_spheres", "n_self_collision_pairs", "retract_violating_pairs",
              "free_fraction", "sphere_radius_range", "per_link_spheres"):
        assert getattr(rt, k) == getattr(rj, k), k
    assert rt.retract_self_collision_violation == pytest.approx(
        rj.retract_self_collision_violation, abs=1e-6)
    np.testing.assert_allclose(rt.workspace_aabb, rj.workspace_aabb, atol=1e-5)
    assert rt.summary() == rj.summary()
    if case == "clean":
        assert rt.ok and rt.free_fraction > 0.5
    else:
        assert not rt.ok
