"""curobo_tpu_torch: the PyTorch/CUDA package beside `curobo_tpu`.

Collision-free batched inverse kinematics, motion generation and
model-predictive control on an NVIDIA GPU through the same entry points as the
JAX package (`Kinematics.from_robot_yaml` -> `compile_scene` ->
`IKSolver.solve_pose`; `MotionPlanner.plan_pose` / `plan_cspace`: IK ->
trajectory optimization -> interpolation; `MPCSolver.step` / `run_ticks`),
with the fused IK and trajectory kernels written by hand in CUDA C++
(`ops/ik_kernels.py`, `ops/traj_kernels.py`, `ops/csrc/`) and a generic
objective in plain PyTorch for what the kernels do not take (goal sets,
c-space goals, per-tool criteria, torque limits, voxel-grid worlds). IK
serves robots with several tool frames (the dual-arm UR10e) on the kernel
route, with an optional Levenberg-Marquardt seed stage (`SeedIK`). Inverse
dynamics (`Dynamics`, RNEA), grasped objects (`AttachmentManager`) and
per-problem worlds (`RobotRollout.evaluate_config_env`) are there too, and
perception: depth and LiDAR into dense or block-sparse TSDF maps, their ESDF
as a planning world (`Mapper.get_voxel_grid`), mesh and point-cloud obstacles
baked into SDF grids, object pose estimation and sphere fitting. A robot
loads from a robot YAML or a URDF (`RobotModelConfig.from_urdf`; `RobotBuilder`
fits its collision spheres and writes the YAML, `RobotDebugger` checks it),
and the tooling of the JAX package is here too: the optimizer registry
(`opt/factory.py`), profiling, metrics, USD export and a one-card device mesh
(`parallel/mesh.py`). Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"

import os as _os

import torch as _torch

# fp32 throughout, no TF32: the rotation compositions and pair distances are
# accuracy-critical, as in the reference, which forces full-precision matmuls.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

# Types
from curobo_tpu_torch.types.pose import Pose
from curobo_tpu_torch.types.state import JointState, RobotState

# Robot model
from curobo_tpu_torch.robot.kinematics import Kinematics, KinematicsState, compute_kinematics
from curobo_tpu_torch.robot.model import RobotModelConfig, build_kinematics_params
from curobo_tpu_torch.robot.params import KinematicsParams, JointLimits
from curobo_tpu_torch.robot.dynamics import Dynamics, compute_inverse_dynamics
from curobo_tpu_torch.robot.debugger import RobotDebugger, RobotReport

# Geometry / world
from curobo_tpu_torch.geom.types import (
    Scene,
    Cuboid,
    SphereObstacle,
    Capsule,
    Cylinder,
    MeshObstacle,
    VoxelGridObstacle,
)
from curobo_tpu_torch.geom.world import (
    VoxelGridData,
    WorldData,
    compile_scene,
    empty_world,
    stack_worlds,
)

# Solvers
from curobo_tpu_torch.solver.ik import IKConfig, IKResult, IKSolver
from curobo_tpu_torch.solver.trajopt import TrajOptConfig, TrajOptResult, TrajOptSolver
from curobo_tpu_torch.motion.planner import MotionPlanConfig, MotionPlanner, MotionPlanResult
from curobo_tpu_torch.motion.batch_planner import BatchMotionPlanner
from curobo_tpu_torch.solver.mpc import MPCConfig, MPCResult, MPCSolver, MPCState
from curobo_tpu_torch.graph.prm import PRMConfig, PRMGraphPlanner
from curobo_tpu_torch.opt.lm import LMConfig, SeedIK

# Collision convenience
from curobo_tpu_torch.collision.robot_scene import AttachmentManager, RobotSceneCollision

# Rollout / goal
from curobo_tpu_torch.rollout.robot_rollout import Goal, RobotRollout, RobotRolloutConfig
from curobo_tpu_torch.types.tool_pose import ToolPoseCriteria
from curobo_tpu_torch.rollout.rosenbrock import RosenbrockConfig, RosenbrockRollout

# Optimizer escape hatch + profiling facade
from curobo_tpu_torch.opt.external import (
    ScipyOptConfig,
    TorchOptConfig,
    scipy_optimize,
    torch_optimize,
)
from curobo_tpu_torch import profiling

# Perception
from curobo_tpu_torch.perception.mapper import Mapper, MapperConfig
from curobo_tpu_torch.perception.block_sparse import BlockSparseConfig, BlockSparseMapper
from curobo_tpu_torch.perception.segmenter import FilterDepth, RobotSegmenter
from curobo_tpu_torch.perception.types import CameraObservation, LidarObservation

from curobo_tpu_torch import runtime


def content_path(*parts: str) -> str:
    """Path into the bundled content package (robot and task configs, the
    motion-generation problem suite)."""
    return _os.path.join(_os.path.dirname(__file__), "content", *parts)


def robot_config_path(name: str) -> str:
    if not name.endswith(".yml"):
        name = name + ".yml"
    return content_path("robots", name)
