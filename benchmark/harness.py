"""The benchmark's general harness: one run of one cell.

A cell of `BENCHMARK.json` names a configuration and a traffic mix; the
harness finds everything else by name, as files of their own:

- `benchmark/configs/<config>.json`: the configuration as it is run (robot,
  world, solver settings, the limits of the output check), with its data
  files beside it in `configs/data/`;
- `benchmark/traffic/<traffic>.json`: the traffic mix, parameters only; its
  `driver` key names the entry point's closed loop in
  `benchmark/drivers/<driver>.py`, which makes the inputs from the seed,
  makes one call at a time and checks the answers against the plain
  reference in `benchmark/reference/`;
- `benchmark/e2e/<metric>.py` and `benchmark/metrics/<metric>.py`: one reader
  per end-to-end and per-layer metric, `read(run) -> float or None`.

A run sets up and warms up the cell, measures a window of `--seconds` (with
`--trace 1`, a bounded traced window under `torch.profiler` instead), frees
the program's state, checks the answers, and prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "curobo_tpu")


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from the kernel's process table
    (None where it cannot be read)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def load_module(path: str, name: str):
    """A module of the benchmark loaded from its file."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    each compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Check:
    """One number compared with its limit: correct where value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    root: str
    workload: Dict
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    device: object
    cell: object = None
    latencies: List[float] = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    setup_s: float = 0.0
    events: object = None  # the traced window's events (benchmark.trace.Events)

    @property
    def calls(self) -> int:
        return len(self.latencies)


def bench_dir(root: str) -> str:
    return os.path.join(root, "benchmark")


def find_workload(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")


def load_config(root: str, name: str) -> Dict:
    path = os.path.join(bench_dir(root), "configs", name + ".json")
    cfg = load_json(path)
    cfg["_dir"] = os.path.dirname(path)
    return cfg


def metrics_of(spec: Dict, key: str, workload: str, e2e_names: Optional[set] = None) -> List[Dict]:
    """The metrics of `spec[key]` that this cell reports: those that list it,
    and those without a list (per-layer ones only where the cell reports the
    end-to-end metric they move)."""
    out = []
    for m in spec[key]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif e2e_names is None or m["moves"] in e2e_names:
            out.append(m)
    return out


def read_metrics(run: Run, metrics: List[Dict], folder: str) -> Dict:
    out = {}
    for m in metrics:
        path = os.path.join(bench_dir(run.root), folder, m["name"] + ".py")
        mod = load_module(path, f"bench_{folder}_{m['name'].replace('.', '_')}")
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def measure(run: Run) -> None:
    """The timed window: calls back to back, each ending with its answer on
    the host, until `seconds` have passed; the last call ends the window."""
    cell = run.cell
    before = getattr(cell, "before_call", None)
    clock = time.perf_counter
    w0 = clock()
    while True:
        if before is not None:
            before()
        t0 = clock()
        cell.call()
        t1 = clock()
        run.latencies.append(t1 - t0)
        if t1 - w0 >= run.seconds:
            break
    run.window_s = clock() - w0


def measure_traced(run: Run) -> None:
    """A bounded traced window: at most the traffic's `trace_calls` calls and
    at most `seconds`, each call inside a `bench.call` span, under
    `torch.profiler`; the trace is read into `run.events` and deleted."""
    from benchmark import trace

    run.events = trace.traced_window(run, run.traffic["trace_calls"])


def synchronize(device) -> None:
    import torch

    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize(device)


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None):
    """Set up, warm up, measure and check one cell -> (result dict, checks,
    run). `t_start` is the `time.perf_counter()` reading of the process's
    start, from which `setup_s` counts."""
    import torch

    if t_start is None:
        t_start = time.perf_counter()
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    w = find_workload(spec, workload)
    config = load_config(root, w["config"])
    traffic = load_json(os.path.join(bench_dir(root), "traffic", w["traffic"] + ".json"))
    driver = load_module(os.path.join(bench_dir(root), "drivers", traffic["driver"] + ".py"),
                         f"bench_driver_{traffic['driver']}")
    run = Run(root=root, workload=w, config=config, traffic=traffic, seed=int(seed),
              seconds=float(seconds), device=device)
    run.cell = driver.Cell(config, traffic, run.seed, device)
    run.cell.warmup()
    synchronize(device)
    gc.collect()
    gc.freeze()  # what set-up made stays out of the window's collections
    run.setup_s = time.perf_counter() - t_start
    if trace:
        measure_traced(run)
    else:
        measure(run)
    synchronize(device)

    e2e = metrics_of(spec, "end_to_end", w["name"])
    if trace:
        metrics = read_metrics(run, metrics_of(spec, "per_layer", w["name"],
                                               {m["name"] for m in e2e}), "metrics")
    else:
        metrics = read_metrics(run, e2e, "e2e")
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=int(w.get("chips", 1)),
               memory_peak_bytes=int(torch.cuda.max_memory_allocated(device))
               if device.type == "cuda" else 0)
    if trace:
        dev.update(busy_s=run.events.busy_s, window_s=run.events.window_s)
    attempted, failed = run.cell.attempted_failed()
    run.cell.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = run.cell.check(control=False)
    result = dict(correct=all(c.ok for c in checks), attempted=int(attempted), failed=int(failed),
                  metrics=metrics, device=dev)
    if trace:
        result["breakdown"] = run.events.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks, run


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell of curobo_tpu_torch.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    import torch

    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    chips = int(find_workload(spec, args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)  # one process with few threads: the host's work is launches
    result, checks, _ = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                                 device, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}, which the benchmark may not load", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
