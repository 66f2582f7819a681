"""Foundation of the PyTorch package held against the JAX package on the CPU:
quaternion/transform math, Pose, the Halton sampler (bit-equal), the robot
YAML copies (byte-equal), the numpy hand-over (`convert.py`), config defaults,
and the rules that the package never imports jax or curobo_tpu and holds no
unreachable statement. Inputs are made from a seed with numpy and handed to
both packages.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.math import quaternion as jq
from curobo_tpu.math import transform as jt
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu_torch.math import quaternion as tq
from curobo_tpu_torch.math import transform as tt

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_ROBOTS = os.path.join(ROOT, "curobo_tpu", "content", "robots")
PORT = os.path.join(ROOT, "curobo_tpu_torch")
ROBOTS = ("franka", "ur10e", "simple_mimic_robot", "dual_ur10e", "unitree_g1",
          "unitree_g1_29dof_retarget")
# content files copied byte for byte, as (folder, file): the robots, then the
# task configs the port reads
CONTENT_COPIES = [pytest.param("robots", r + ".yml", id=r) for r in ROBOTS] + [
    pytest.param("tasks", t, id="tasks/" + t) for t in ("ik_g1.yml", "ik.yml")
]


def _rand_quat(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _both(fj, ft, *arrs):
    a = np.asarray(fj(*[jnp.asarray(x) for x in arrs]))
    b = ft(*[torch.as_tensor(x) for x in arrs]).numpy()
    return a, b


_RNG = np.random.RandomState(0)
_Q1, _Q2 = _rand_quat(_RNG, 64), _rand_quat(_RNG, 64)
_V = _RNG.normal(size=(64, 3)).astype(np.float32)
_ANG = _RNG.uniform(-3, 3, 64).astype(np.float32)
_AX = _V / np.linalg.norm(_V, axis=-1, keepdims=True)

QUAT_CASES = {
    "normalize": (jq.quat_normalize, tq.quat_normalize, (_Q1 * 3.0,)),
    "multiply": (jq.quat_multiply, tq.quat_multiply, (_Q1, _Q2)),
    "conjugate": (jq.quat_conjugate, tq.quat_conjugate, (_Q1,)),
    "rotate": (jq.quat_rotate, tq.quat_rotate, (_Q1, _V)),
    "to_matrix": (jq.quat_to_matrix, tq.quat_to_matrix, (_Q1,)),
    "from_axis_angle": (jq.quat_from_axis_angle, tq.quat_from_axis_angle, (_AX, _ANG)),
    "axis_angle_matrix": (jq.axis_angle_rotation_matrix, tq.axis_angle_rotation_matrix, (_AX, _ANG)),
    "angle": (jq.quat_angle, tq.quat_angle, (_Q1,)),
    "error": (jq.quat_error, tq.quat_error, (_Q1, _Q2)),
    "geodesic": (jq.quat_geodesic_distance, tq.quat_geodesic_distance, (_Q1, _Q2)),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quaternion_op_matches_jax(name):
    fj, ft, args = QUAT_CASES[name]
    a, b = _both(fj, ft, *args)
    # float32 elementwise math on the same inputs: a few ulp
    np.testing.assert_allclose(b, a, atol=2e-6, rtol=1e-5)


def test_matrix_to_quat_matches_jax_and_round_trips():
    R = np.asarray(jq.quat_to_matrix(jnp.asarray(_Q1)))
    a, b = _both(jq.matrix_to_quat, tq.matrix_to_quat, R)
    np.testing.assert_allclose(b, a, atol=2e-6)
    canon = np.where(_Q1[:, :1] < 0, -_Q1, _Q1)
    np.testing.assert_allclose(b, canon, atol=1e-5)


def test_quat_error_zero_rotation_has_finite_gradient():
    q = torch.as_tensor(_Q1[:8]).clone().requires_grad_(True)
    e = tq.quat_error(torch.as_tensor(_Q1[:8]), q)
    (e * e).sum().backward()
    assert torch.isfinite(q.grad).all()


@pytest.mark.parametrize("op", ["compose", "inverse", "transform_points", "inverse_transform_points"])
def test_transform_op_matches_jax(op):
    Ra = np.asarray(jq.quat_to_matrix(jnp.asarray(_Q1)))
    Rb = np.asarray(jq.quat_to_matrix(jnp.asarray(_Q2)))
    pa, pb = _V, _V[::-1].copy()
    pts = _RNG.normal(size=(64, 5, 3)).astype(np.float32)
    args = {
        "compose": (Ra, pa, Rb, pb), "inverse": (Ra, pa),
        "transform_points": (Ra, pa, pts), "inverse_transform_points": (Ra, pa, pts),
    }[op]
    outj = getattr(jt, op)(*[jnp.asarray(x) for x in args])
    outt = getattr(tt, op)(*[torch.as_tensor(x) for x in args])
    if not isinstance(outj, tuple):
        outj, outt = (outj,), (outt,)
    for a, b in zip(outj, outt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-6)


@pytest.mark.parametrize("method", ["multiply", "inverse", "to_matrix", "transform_points", "errors"])
def test_pose_matches_jax(method):
    pj1, pj2 = JPose(jnp.asarray(_V), jnp.asarray(_Q1)), JPose(jnp.asarray(_V[::-1].copy()), jnp.asarray(_Q2))
    pt1 = ct.Pose(torch.as_tensor(_V), torch.as_tensor(_Q1))
    pt2 = ct.Pose(torch.as_tensor(_V[::-1].copy()), torch.as_tensor(_Q2))
    if method == "multiply":
        a, b = pj1.multiply(pj2), pt1.multiply(pt2)
        np.testing.assert_allclose(b.to_numpy(), a.to_numpy(), atol=5e-6)
    elif method == "inverse":
        np.testing.assert_allclose(pt1.inverse().to_numpy(), pj1.inverse().to_numpy(), atol=5e-6)
    elif method == "to_matrix":
        np.testing.assert_allclose(pt1.to_matrix().numpy(), np.asarray(pj1.to_matrix()), atol=5e-6)
    elif method == "transform_points":
        pts = _RNG.normal(size=(64, 4, 3)).astype(np.float32)
        np.testing.assert_allclose(
            pt1.transform_points(torch.as_tensor(pts)).numpy(),
            np.asarray(pj1.transform_points(jnp.asarray(pts))), atol=5e-6,
        )
    else:
        np.testing.assert_allclose(
            pt1.position_error(pt2).numpy(), np.asarray(pj1.position_error(pj2)), atol=5e-6
        )
        # arccos near 1 amplifies rounding: looser
        np.testing.assert_allclose(
            pt1.rotation_error(pt2).numpy(), np.asarray(pj1.rotation_error(pj2)), atol=2e-3
        )


def test_pose_constructors_and_shapes():
    p = ct.Pose.from_list([[0.1, 0.2, 0.3, 2.0, 0, 0, 0], [0, 0, 0, 0, 1, 0, 0]])
    np.testing.assert_allclose(p.quaternion.numpy(), [[1, 0, 0, 0], [0, 1, 0, 0]], atol=1e-7)
    assert p.batch_shape == (2,)
    assert p.tile_seeds(3).position.shape == (2, 3, 3)
    assert ct.Pose.identity((4,)).quaternion[:, 0].eq(1).all()
    assert p[0].position.shape == (3,)
    assert p.repeat(2).position.shape == (4, 3)


@pytest.mark.parametrize("n,dim,skip", [(31, 7, 20), (100, 7, 11), (5, 6, 20), (64, 29, 0)])
def test_halton_sequence_bit_equal(n, dim, skip):
    from curobo_tpu.util.sampling import halton_sequence as hj
    from curobo_tpu_torch.util.sampling import halton_sequence as ht

    a, b = hj(n, dim, skip), ht(n, dim, skip)
    assert a.dtype == b.dtype == np.float64
    assert np.array_equal(a, b)


@pytest.mark.parametrize("folder,name", CONTENT_COPIES)
def test_robot_yaml_copy_is_byte_identical(folder, name):
    with open(os.path.join(ROOT, "curobo_tpu", "content", folder, name), "rb") as f:
        ref = f.read()
    with open(ct.content_path(folder, name), "rb") as f:
        assert f.read() == ref


def _np_tree(obj):
    """Dataclass of jax arrays + static fields -> dict of numpy / python."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _np_tree(v)
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            out[f.name] = [_np_tree(x) for x in v]
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def _assert_same(a, b, path=""):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(va):
            _assert_same(va, vb, path + f.name + ".")
        elif isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype, path + f.name
            assert torch.equal(va, vb) or torch.allclose(va, vb, equal_nan=True), path + f.name
        else:
            assert va == vb, path + f.name


@pytest.mark.parametrize("robot", ROBOTS)
def test_convert_params_equals_own_loader(robot):
    from curobo_tpu.robot.kinematics import Kinematics as JKin
    from curobo_tpu_torch.convert import kinematics_params_from_numpy

    pj = JKin.from_robot_yaml(os.path.join(JAX_ROBOTS, robot + ".yml")).params
    conv = kinematics_params_from_numpy(_np_tree(pj), device="cpu")
    own = ct.Kinematics.from_robot_yaml(ct.robot_config_path(robot), device="cpu").params
    _assert_same(conv, own)


def test_convert_world_equals_own_compile():
    from curobo_tpu.geom import types as jgt
    from curobo_tpu.geom import world as jwm
    from curobo_tpu_torch.convert import world_from_numpy
    from curobo_tpu_torch.geom import types as tgt

    def scene(mod):
        return mod.Scene().add(
            mod.Cuboid(name="table", pose=[0.4, 0, -0.1, 1, 0, 0, 0], dims=[1.2, 1.2, 0.2]),
            mod.SphereObstacle(name="ball", pose=[0.3, 0.3, 0.5, 1, 0, 0, 0], radius=0.1),
            mod.Capsule(name="bar", pose=[0.5, -0.3, 0.4, 0.9239, 0.3827, 0, 0], radius=0.05),
            mod.Cylinder(name="post", pose=[-0.3, 0.4, 0.3, 0.9659, 0, 0.2588, 0], radius=0.08, height=0.6),
        )

    wj = jwm.compile_scene(scene(jgt), capacities={"cuboid": 3})
    conv = world_from_numpy(_np_tree(wj), device="cpu")
    own = ct.compile_scene(scene(tgt), capacities={"cuboid": 3}, device="cpu")
    _assert_same(conv, own)


def _defaults(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = _defaults(v) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize(
    "name", ["IKConfig", "LBFGSConfig", "LineSearchConfig", "MPPIConfig", "RobotRolloutConfig",
             "PoseCostConfig", "BoundCostConfig", "CollisionCostConfig", "SelfCollisionCostConfig",
             "CSpaceCostConfig", "LMConfig"],
)
def test_config_fields_and_defaults_equal(name):
    import importlib

    where = {
        "IKConfig": "solver.ik", "LBFGSConfig": "opt.lbfgs", "LineSearchConfig": "opt.lbfgs",
        "MPPIConfig": "opt.mppi", "RobotRolloutConfig": "rollout.robot_rollout",
        "LMConfig": "opt.lm",
    }.get(name, "cost.terms")
    cj = getattr(importlib.import_module("curobo_tpu." + where), name)()
    ctc = getattr(importlib.import_module("curobo_tpu_torch." + where), name)()
    assert _defaults(cj) == _defaults(ctc)


def test_ik_config_from_dict():
    cfg = ct.IKConfig.from_yaml({"n_seeds": 8, "lbfgs": {"n_iters": 5}, "mppi": {"n_particles": 4}})
    assert (cfg.n_seeds, cfg.lbfgs.n_iters, cfg.lbfgs.history, cfg.mppi.n_particles) == (8, 5, 12, 4)
    with pytest.raises(ValueError):
        ct.IKConfig.from_yaml({"no_such_key": 1})


def test_full_precision_flags():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    from curobo_tpu_torch.geom import types as tgt

    with pytest.raises(RuntimeError, match="CUDA"):
        ct.Kinematics.from_robot_yaml(ct.robot_config_path("ur10e"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.compile_scene(tgt.Scene())
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.runtime.resolve_device("cuda:0")
    assert ct.runtime.resolve_device("cpu") == torch.device("cpu")


def test_joint_state_reorder_and_probe():
    js = ct.JointState.from_position(torch.arange(6.0).reshape(2, 3), ("a", "b", "c"))
    out = js.reorder(("c", "a", "b"))
    assert out.position.tolist() == [[2.0, 0.0, 1.0], [5.0, 3.0, 4.0]]
    assert out.joint_names == ("c", "a", "b")
    with pytest.raises(ValueError, match="nope"):
        js.reorder(("a", "nope"))
    assert js.tile_seeds(4).position.shape == (2, 4, 3)


def test_checks_name_the_argument():
    from curobo_tpu_torch.util import checks

    with pytest.raises(ValueError, match="q must have trailing dimension 7"):
        checks.check_joint_config("q", torch.zeros(3, 6), 7)
    with pytest.raises(ValueError, match="floating"):
        checks.check_joint_config("q", torch.zeros(3, 7, dtype=torch.int64), 7)
    with pytest.raises(ValueError, match="batched"):
        checks.check_pose_batch("goal", ct.Pose(torch.zeros(3), torch.zeros(4)))


def _py_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return files


def test_port_never_imports_jax_or_the_jax_package():
    bad = []
    for path in _py_files():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "curobo_tpu"):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno}: imports {m}")
    assert not bad, "\n".join(bad)


def test_port_imports_leave_jax_unloaded():
    """A fresh interpreter imports the package and its perception, mesh, URDF,
    builder, optimizer-registry, tooling and mesh-placement modules (and
    builds nothing): neither jax nor the JAX package is loaded,
    which also catches an import made inside a function at import time."""
    code = (
        "import sys\n"
        "import curobo_tpu_torch\n"
        "from curobo_tpu_torch.perception import block_sparse, mapper, mesh_extract, "
        "pose_estimation, segmenter, types\n"
        "from curobo_tpu_torch.geom import mesh, sphere_fit, world\n"
        "from curobo_tpu_torch.ops import mesh_sdf\n"
        "from curobo_tpu_torch import convert, profiling, viewer\n"
        "from curobo_tpu_torch.robot import builder, debugger, import_urdf, urdf\n"
        "from curobo_tpu_torch.opt import debug, es, external, factory\n"
        "from curobo_tpu_torch.util import metrics, usd_export\n"
        "from curobo_tpu_torch.parallel import mesh as pmesh\n"
        "from curobo_tpu_torch.rollout import rosenbrock\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'curobo_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_has_no_unreachable_statements():
    terminators = (ast.Return, ast.Raise, ast.Break, ast.Continue)
    findings = []
    for path in _py_files():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            for field in ("body", "orelse", "finalbody"):
                body = getattr(node, field, None)
                if not (isinstance(body, list) and body and isinstance(body[0], ast.stmt)):
                    continue
                for prev, stmt in zip(body, body[1:]):
                    if isinstance(prev, terminators):
                        findings.append(f"{os.path.relpath(path, ROOT)}:{stmt.lineno}: unreachable")
                        break
    assert not findings, "\n".join(findings)
