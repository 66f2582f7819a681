"""The harness: BENCHMARK.json keeps to its contract, a configuration, a
traffic mix and a metric are found as files alone, the trace is read as
the contract says, and a run without a CUDA device prints no result."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import harness, trace

from .conftest import ROOT, edit_json, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_benchmark_json_keeps_to_its_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            body = json.load(fh)
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
    cells = {}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in names and NAME.match(w["name"]) and len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json"))
        cells[w["name"]] = w
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and os.path.isfile(os.path.join(ROOT, "benchmark", "e2e", m["name"] + ".py"))
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
        for c in m["workloads"]:  # each listed cell reports the metric it moves
            assert c in e2e[m["moves"]].get("workloads", cells)
    for name in cells:
        e = [m["name"] for m in harness.metrics_of(spec, "end_to_end", name)]
        assert "setup_s" in e and len(e) >= 2
        assert harness.metrics_of(spec, "per_layer", name, set(e))
    assert len(json.dumps(spec)) < 64 * 1024


def test_a_cell_added_as_files_alone_runs(tiny_root):
    """A dummy configuration, traffic mix and per-layer metric, added as
    files and entries in BENCHMARK.json, and found by their names."""
    b = os.path.join(tiny_root, "benchmark")
    with open(os.path.join(b, "configs", "franka_ik.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="dummy_ik", scene=[])
    with open(os.path.join(b, "configs", "dummy_ik.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(b, "traffic", "dummy_b2.json"), "w") as fh:
        json.dump(dict(driver="ik", batch=2, pool_batches=3, check_calls=2, trace_calls=2), fh)
    with open(os.path.join(b, "metrics", "dummy_calls.py"), "w") as fh:
        fh.write("def read(run):\n    return float(run.calls)\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as fh:
        spec = json.load(fh)
    spec["configs"].append(dict(name="dummy_ik", source="x", file="benchmark/configs/dummy_ik.json",
                                reduced=[], why="x"))
    spec["workloads"].append(dict(name="dummy_ik.dummy_b2", config="dummy_ik", traffic="dummy_b2",
                                  chips=1, why="x"))
    next(m for m in spec["end_to_end"] if m["name"] == "ik_batch_ms")["workloads"].append("dummy_ik.dummy_b2")
    spec["per_layer"].append(dict(name="dummy_calls", unit="calls", better="higher", source="program_counter",
                                  layer="x", moves="ik_batch_ms", workloads=["dummy_ik.dummy_b2"]))
    with open(path, "w") as fh:
        json.dump(spec, fh)
    result, checks, run = run_tiny(tiny_root, "dummy_ik.dummy_b2", seconds=60, trace=True)
    assert result["metrics"]["dummy_calls"] == {"value": 2.0, "unit": "calls"}
    assert run.cell.goal_pos.shape[1] == 2 and [c.name for c in checks] == ["answer_gap", "unsolved_share"]
    result, _, run = run_tiny(tiny_root, "dummy_ik.dummy_b2")
    assert set(result["metrics"]) == {"setup_s", "ik_batch_ms"} and run.calls >= 1
    assert list(result)[-1] == "checks"


def test_the_trace_reader(tmp_path):
    us = lambda name, cat, ts, dur: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)
    events = [us("bench.call", "user_annotation", 0, 100), us("bench.call", "user_annotation", 150, 100),
              us("aten::cat", "cpu_op", 60, 30), us("ik_solve_kernel(IKRobot, int)", "kernel", 10, 40),
              us("Memcpy DtoH", "gpu_memcpy", 50, 5), us("ik_solve_kernel(IKRobot, int)", "kernel", 160, 60),
              us("outside", "kernel", 400, 10)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(dict(traceEvents=events)))
    ev = trace.Events.from_chrome(str(path))
    assert ev.window == (0.0, 250.0) and ev.window_s == 250e-6
    assert abs(ev.busy_s - 105e-6) < 1e-12
    assert ev.kernel_us("ik_solve_kernel") == [40.0, 60.0]
    assert ev.device_ops_per_span() == [2, 1]
    bd = ev.breakdown()
    assert bd["device_ops"][0] == ["ik_solve_kernel", 100e-6]
    gaps = dict((k, v) for k, v in bd["idle_gaps"])
    # 55..100 in the first call, its midpoint inside aten::cat; 0..10, 150..160
    # and 220..250 in a call outside any host operation; 100..150 between calls
    assert abs(gaps["bench.call: aten::cat"] - 45e-6) < 1e-12
    assert abs(gaps["bench.call"] - 50e-6) < 1e-12
    assert abs(gaps["between calls"] - 50e-6) < 1e-12


def test_the_trace_reader_places_device_work_by_its_launch(tmp_path):
    # the device's clock mapped 30 us late onto the host's: each kernel's own
    # start lies in the next call or past the window, its launch does not
    ev = lambda name, cat, ts, dur, corr=None: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur,
                                                    **({} if corr is None else dict(args=dict(correlation=corr))))
    events = [ev("bench.call", "user_annotation", 0, 100), ev("bench.call", "user_annotation", 150, 100),
              ev("cudaLaunchKernel", "cuda_runtime", 5, 3, 1), ev("traj_solve_kernel", "kernel", 90, 50, 1),
              ev("cuLaunchKernel", "cuda_driver", 160, 3, 2), ev("traj_solve_kernel", "kernel", 230, 40, 2),
              ev("cudaMemcpyAsync", "cuda_runtime", 240, 2, 3), ev("Memcpy DtoH", "gpu_memcpy", 271, 2, 3)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(dict(traceEvents=events)))
    ev = trace.Events.from_chrome(str(path))
    assert ev.kernel_us("traj_solve_kernel") == [50.0, 40.0]
    assert ev.device_ops_per_span() == [1, 2] and ev.launches_per_call() == 1.5


def test_no_result_without_a_cuda_device():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload",
                          "franka_ik.b100", "--seed", "3", "--seconds", "1"], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
