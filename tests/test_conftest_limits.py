"""The suite's per-test time limit (the repository's root `conftest.py`): a
test that runs past its `time_limit` fails with the stack it was stuck in, the
next test still runs, and pytest returns; in one process and in an xdist
worker."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TWO_TESTS = '''
import time

import pytest


@pytest.mark.time_limit(2)
def test_sleeps_past_its_limit():
    time.sleep(60)


def test_passes():
    assert True
'''


@pytest.mark.parametrize("dist", [["-p", "no:xdist"], ["-p", "xdist", "-n", "1"]],
                         ids=["serial", "xdist"])
def test_a_test_past_its_limit_fails_with_its_stack(tmp_path, dist):
    # the limit acts on the tests under the rootdir's tests/
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_two.py").write_text(TWO_TESTS)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_two.py", "-p", "conftest", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-c", os.path.join(ROOT, "pyproject.toml"),
         "--rootdir", str(tmp_path), *dist],
        capture_output=True, text=True, timeout=60, cwd=tmp_path, env=env)
    log = out.stdout + out.stderr
    assert out.returncode == 1, log
    assert "1 failed, 1 passed" in log, log
    assert "ran past its time limit of 2 s" in log, log
    # the failure's traceback and the thread dump both show the stuck line
    assert log.count("time.sleep(60)") >= 1 and "Timeout (0:00:02)!" in log, log
    assert 'line 9 in test_sleeps_past_its_limit' in log, log
