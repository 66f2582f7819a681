"""Fixtures of the benchmark's own tests (run with `python -m pytest
benchmark/tests`; the tests marked `chip` need an NVIDIA GPU and skip
without one)."""

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is none (decided here, at run
    time, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# CPU sizes of the cells: the same code paths at budgets a test run holds
TINY = {
    "configs/franka_ik.json": {"ik": {"n_seeds": 8, "warmup_iters": 32, "use_particle_stage": False,
                                      "lbfgs": {"history": 10, "n_iters": 6}, "kernel_linesearch": 4}},
    "traffic/b100.json": {"batch": 4, "pool_batches": 2, "check_calls": 3, "trace_calls": 3},
    "traffic/b1.json": {"pool_batches": 4, "check_calls": 8, "trace_calls": 3},
    "traffic/plan.json": {"permutations": 2, "check_plans": 4, "trace_calls": 2},
    "traffic/mpc.json": {"episode_ticks": 3, "pool_episodes": 2, "check_ticks": 6, "trace_calls": 4},
}
TINY_LIMITS = {"plan": {"answer_gap": 1e-3, "unsolved_share": 0.5},
               "mpc": {"answer_gap": 1e-3, "plan_progress": 2.0}}  # the CPU budget's plans barely move
TINY_MOTION = {
    "n_problems": 3,
    "planner": {"ik": {"n_seeds": 16, "mppi": {"n_particles": 16, "n_iters": 4}, "lbfgs": {"n_iters": 30}},
                "trajopt": {"lbfgs": {"n_iters": 24}}, "n_trajopt_seeds": 2, "n_trajopt_seeds_retry": 2,
                "retry_ik_seed_scale": 2},
    "mpc_overrides": {"mppi": {"n_particles": 4, "n_iters": 1}, "lbfgs": {"n_iters": 2}},
}


def edit_json(path, updates):
    with open(path) as fh:
        d = json.load(fh)
    d.update(updates)
    with open(path, "w") as fh:
        json.dump(d, fh)


def make_tiny_root(path):
    """A copy of BENCHMARK.json and the benchmark's files in `path`, cut to
    CPU sizes, with limits that the CPU sizes' sound runs meet (few seeds
    and short episodes solve less and track less)."""
    path = str(path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), path)
    for rel, upd in TINY.items():
        edit_json(os.path.join(path, "benchmark", rel), upd)
    edit_json(os.path.join(path, "benchmark", "configs", "franka_motion.json"),
              dict(TINY_MOTION, limits=TINY_LIMITS))
    with open(os.path.join(path, "benchmark", "configs", "franka_ik.json")) as fh:
        ik = json.load(fh)
    edit_json(os.path.join(path, "benchmark", "configs", "franka_ik.json"),
              dict(limits=dict(ik["limits"], ik=dict(ik["limits"]["ik"], unsolved_share=0.5))))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def run_tiny(root, workload, seed=2147483905, seconds=0.5, trace=False):
    import torch

    from benchmark import harness

    return harness.run_cell(root, workload, seed, seconds, trace, torch.device("cpu"))
