"""The traced window and the reading of its trace.

`traced_window` runs the cell's calls under `torch.profiler`, each inside a
`bench.call` span, exports the trace to a directory under the temporary
directory, reads it into `Events` and deletes it. The device's busy time is
the union of its kernels, copies and sets inside the window (the method of
`chip_smoke.py:trace_busy`); the window runs from the first call's start to
the last call's end.

A device operation belongs to a call, and to the window, by the host time
of the launch that queued it (the runtime or driver call with the same
correlation id), not by its own start: the profiler maps the device's clock
onto the host's, and in a process's first profiling session that mapping
drifts by some milliseconds, enough to put a kernel in the neighbouring
call or outside the window. Busy and idle time, which are the device's,
keep its own timestamps.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

SPAN = "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def short(name: str) -> str:
    return name.split("(")[0][:60]


@dataclasses.dataclass
class Events:
    # (start us, end us, name, host time of its launch in us), sorted by start
    device: List[Tuple[float, float, str, float]]
    spans: List[Tuple[float, float]]  # the calls' spans (us), sorted
    cpu_ops: List[Tuple[float, float, str]]  # host operations (us), sorted by start

    @staticmethod
    def from_chrome(path: str) -> "Events":
        with open(path) as fh:
            evs = json.load(fh)["traceEvents"]
        dev, spans, ops, launched = [], [], [], {}
        for e in evs:
            if e.get("ph") != "X":
                continue
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            cat = e.get("cat")
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                dev.append((t0, t1, str(e.get("name", "")), corr))
            elif cat in LAUNCH_CATS and corr is not None:
                launched[corr] = t0
            elif cat == "user_annotation" and e.get("name") == SPAN:
                spans.append((t0, t1))
            elif cat == "cpu_op":
                ops.append((t0, t1, str(e.get("name", ""))))
        # an operation with no launch on record is placed by its own start
        dev = [(t0, t1, n, launched.get(c, t0)) for t0, t1, n, c in dev]
        return Events(sorted(dev), sorted(spans), sorted(ops))

    # ------------------------------------------------------------------
    @property
    def window(self) -> Tuple[float, float]:
        if not self.spans:
            return 0.0, 0.0
        return self.spans[0][0], max(t1 for _, t1 in self.spans)

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device work inside the window, as sorted intervals."""
        a, b = self.window
        out: List[List[float]] = []
        for t0, t1, _, _ in self.device:
            t0, t1 = max(t0, a), min(t1, b)
            if t1 <= t0:
                continue
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return [(x, y) for x, y in out]

    @property
    def busy_s(self) -> float:
        return sum(y - x for x, y in self.busy_intervals()) / 1e6

    def kernel_us(self, prefix: str) -> List[float]:
        """Durations (us) of the device kernels whose name starts with
        `prefix`, launched inside the window."""
        a, b = self.window
        return [t1 - t0 for t0, t1, n, h in self.device if n.startswith(prefix) and a <= h <= b]

    def device_ops_per_span(self) -> List[int]:
        """Device kernels, copies and sets launched inside each call's span."""
        launches = sorted(h for _, _, _, h in self.device)
        return [bisect.bisect_left(launches, s1) - bisect.bisect_left(launches, s0)
                for s0, s1 in self.spans]

    def launches_per_call(self) -> Optional[float]:
        per = self.device_ops_per_span()
        return sum(per) / len(per) if per and self.device else None

    def idle_pct(self) -> Optional[float]:
        """100 % less the share of the window that device work covers."""
        if self.window_s <= 0 or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    # ------------------------------------------------------------------
    def _host_at(self, t: float, starts: List[float]) -> str:
        """Where the host was at time t: the innermost host operation then
        (`starts`: the host operations' start times), inside a call, or
        between calls."""
        k = bisect.bisect_right(self.spans, (t, float("inf")))
        if k == 0 or self.spans[k - 1][1] < t:
            return "between calls"
        i = bisect.bisect_right(starts, t)
        best = None
        for j in range(i - 1, max(i - 400, -1), -1):
            _, e, n = self.cpu_ops[j]
            if e >= t:
                best = n
                break
        return f"{SPAN}: {best}" if best else SPAN

    def breakdown(self) -> Dict:
        """The device operations that took the most time, and the longest
        idle time by where the host was, in seconds, ten of each."""
        a, b = self.window
        by_name: Dict[str, float] = {}
        for t0, t1, n, _ in self.device:
            t0, t1 = max(t0, a), min(t1, b)
            if t1 > t0:
                by_name[short(n)] = by_name.get(short(n), 0.0) + (t1 - t0) / 1e6
        gaps: Dict[str, float] = {}
        starts = [s for s, _, _ in self.cpu_ops]
        edges = sorted({t for span in self.spans for t in span})
        prev = a
        for x, y in self.busy_intervals() + [(b, b)]:
            # an idle stretch, cut where a call starts or ends
            cuts = [prev] + edges[bisect.bisect_right(edges, prev):bisect.bisect_left(edges, x)] + [x]
            for u, v in zip(cuts, cuts[1:]):
                if v > u:
                    where = self._host_at(0.5 * (u + v), starts)
                    gaps[where] = gaps.get(where, 0.0) + (v - u) / 1e6
            prev = max(prev, y)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return dict(device_ops=top(by_name), idle_gaps=top(gaps))


def traced_window(run, max_calls: int) -> Events:
    """Calls under `torch.profiler` (device activity on a CUDA device), at
    most `max_calls` of them and at most `run.seconds`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    cell = run.cell
    before = getattr(cell, "before_call", None)
    clock = time.perf_counter
    with profile(activities=acts) as prof:
        w0 = clock()
        while True:
            if before is not None:
                before()
            with record_function(SPAN):
                t0 = clock()
                cell.call()
                t1 = clock()
            run.latencies.append(t1 - t0)
            if len(run.latencies) >= max_calls or t1 - w0 >= run.seconds:
                break
        run.window_s = clock() - w0
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return Events.from_chrome(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
