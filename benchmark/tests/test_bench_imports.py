"""What the benchmark loads: no module whose top-level name is `jax`,
`jaxlib`, `flax` or `curobo_tpu` (each name compared whole:
`curobo_tpu_torch` is the program and is allowed), and in
`benchmark/reference/` nothing of the program either."""

import glob
import os
import subprocess
import sys

from benchmark import harness

from .conftest import ROOT


def loaded_after(code: str):
    prog = "import sys; sys.path.insert(0, %r)\n%s\nprint(sorted({m.split('.')[0] for m in sys.modules}))" % (
        ROOT, code)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, check=True,
                         cwd=ROOT)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_every_module_of_the_benchmark_and_a_run_load_no_jax():
    files = sorted(glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"), recursive=True))
    files = [f for f in files if os.sep + "tests" + os.sep not in f]
    code = "\n".join([
        "import importlib.util, torch",
        "torch.set_num_threads(2)",
        "from benchmark import harness",
        "for i, f in enumerate(%r):" % files,
        "    harness.load_module(f, 'm%d' % i)",
        "from benchmark.tests.conftest import TINY, TINY_MOTION, edit_json",
        "import tempfile, shutil, os",
        "d = tempfile.mkdtemp()",
        "shutil.copytree(%r, os.path.join(d, 'benchmark'), ignore=shutil.ignore_patterns('tests'))" % os.path.join(ROOT, "benchmark"),
        "shutil.copy(%r, d)" % os.path.join(ROOT, "BENCHMARK.json"),
        "[edit_json(os.path.join(d, 'benchmark', k), v) for k, v in TINY.items()]",
        "harness.run_cell(d, 'franka_ik.b100', 5, 0.2, False, torch.device('cpu'))",
        "shutil.rmtree(d)",
    ])
    names = loaded_after(code)
    assert "curobo_tpu_torch" in names  # the program ran
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("from benchmark.reference import checks, goals, robot, scene")
    assert not names & {"curobo_tpu_torch", "curobo_tpu", "jax", "jaxlib", "flax"}


def test_names_are_compared_whole():
    before = dict(sys.modules)
    try:
        sys.modules["curobo_tpu_torch_x"] = sys
        sys.modules["jaxfoo.bar"] = sys
        assert harness.forbidden_modules() == sorted(
            n for n in {m.split(".")[0] for m in before} if n in harness.FORBIDDEN)
        sys.modules["curobo_tpu.solver"] = sys
        assert "curobo_tpu" in harness.forbidden_modules()
    finally:
        for k in ("curobo_tpu_torch_x", "jaxfoo.bar", "curobo_tpu.solver"):
            sys.modules.pop(k, None)
