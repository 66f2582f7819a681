"""The tier-1 suite's harness (`tests/`): the order in which xdist sends work
out, a time limit for each test, and the heap handed back after each file.

It lives beside `tests/` so that `tests/conftest.py`, which configures JAX,
stays as it is. It acts on the tests under `tests/` only.
"""

import ctypes
import faulthandler
import gc
import signal
import sys

import pytest

# Seconds a test's setup or call may take before it fails with the stack it
# was stuck in: twice the slowest test of a run on an empty XLA cache, 574 s
# (the example scripts stop sooner, at their subprocess's own 600 s).
# `pytest.mark.time_limit(s)` gives a test a limit of its own.
TIME_LIMIT_S = 1200

# Each example script runs in a subprocess of its own, up to 600 s; as one
# file they kept one worker busy for half the run. Each script is a unit of
# work of its own. The three long ones go out first, longest first, and
# `multi_env_batch.py` last: it stays under its 600 s only once the other
# workers are done (455 s then, past 600 s beside them, on 8 cores). The rest
# keep xdist's order, most tests first.
EXAMPLES = "tests/test_examples.py::test_example_smoke["
FIRST = tuple(EXAMPLES + script + "]" for script in
              ("whole_body_balance_ik.py", "motion_planning.py", "attached_object.py"))
LAST = EXAMPLES + "multi_env_batch.py]"


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class ExamplesApart(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return nodeid if nodeid.startswith(EXAMPLES) else super()._split_scope(nodeid)

        def _assign_work_unit(self, node):
            for unit in reversed(FIRST):
                if unit in self.workqueue:
                    self.workqueue.move_to_end(unit, last=False)
            if LAST in self.workqueue:
                self.workqueue.move_to_end(LAST)
            super()._assign_work_unit(node)

    return ExamplesApart(config, log)


def _in_suite(path, config):
    return path.is_relative_to(config.rootpath / "tests")


def _time_limited(item):
    """At the limit, dump every thread's stack (a watchdog thread, so it shows
    a test stuck in native code too); a second later, fail the test where it
    stands (an alarm, acted on once control is back in Python). At the same
    instant the two race: the dump would read the stack the alarm unwinds."""
    if not _in_suite(item.path, item.config):
        yield
        return
    marker = item.get_closest_marker("time_limit")
    limit = int(marker.args[0]) if marker else TIME_LIMIT_S

    def expired(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit} s")

    previous = signal.signal(signal.SIGALRM, expired)
    faulthandler.dump_traceback_later(limit)
    signal.alarm(limit + 1)
    try:
        yield
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    yield from _time_limited(item)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield from _time_limited(item)


@pytest.fixture(scope="module", autouse=True)
def _trim_heap(request):
    """At each test file's end, hand the freed heap back to the system. A
    worker runs a dozen files and otherwise keeps its high-water mark (after
    `test_solver_ik.py` alone, 3.65 GB; 1.01 GB after the trim)."""
    yield
    if sys.platform == "linux" and _in_suite(request.path, request.config):
        gc.collect()
        ctypes.CDLL("libc.so.6").malloc_trim(0)
