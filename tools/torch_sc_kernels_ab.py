#!/usr/bin/env python3
"""Time the self-collision pair kernels of two checkouts of this repository
on one CUDA device, in turns.

    python3 tools/torch_sc_kernels_ab.py [--g1] OLD_ROOT NEW_ROOT

Runs each checkout's `curobo_tpu_torch.ops.self_collision_kernels` in a
process of its own (A, B, B, A: each builds its own library from its own
sources) at the four shapes of `chip_smoke.py` phase `sc_kernels`
(`chip_smoke.sc_shapes` without a G1 solve: 4800 G1 configurations near its
retract configuration stand in for the solve's seeds, 3200 Franka
configurations over its joint range for the IK seeds). For each kernel,
through its public wrapper (`sc_pair_cost`, `sc_pair_grad`, `sc_pair_viol`):
`chip_smoke.best_ms` of 20 calls (host time included) and
`chip_smoke.device_ms` (the host's time between launches out), and the
largest relative difference of its result from the plain chunked version;
at the G1 shape also the device time of the cost and the gradient at
activations -1 m (no pair inside the hinge), 0.02 m (the objective's) and
1 m (every pair inside it), which brackets what bounds the kernels. The
timing helpers and the shapes are this checkout's `chip_smoke.py`, loaded
over each checkout's own package.

With `--g1`, each turn also runs that checkout's `python3 chip_smoke.py --g1`
(the G1 solve end to end) and keeps its `g1` line's time per solve, LM and
L-BFGS stage times, busy share, success and pair-kernel launches.

Prints one JSON line per run, then one with the median of each number per
checkout and the card's name and power limit. Needs a CUDA device and
`nvcc`; imports no JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACT = 0.02
KERNELS = ("sc_pair_cost", "sc_pair_grad", "sc_pair_viol")
G1_KEYS = ("ms_per_solve_median", "lm_ms", "lbfgs_ms", "success_rate")


def load_chip_smoke(root: str):
    """This checkout's `chip_smoke.py` as a module, importing `root`'s package."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str) -> dict:
    """One checkout's kernels at the four shapes."""
    cs = load_chip_smoke(root)
    import torch

    from curobo_tpu_torch.ops import self_collision_kernels as sck

    if os.path.dirname(os.path.dirname(os.path.abspath(sck.__file__))) != os.path.join(root, "curobo_tpu_torch"):
        raise SystemExit(f"imported {sck.__file__}, not the package under {root}")
    dev = cs.DEV
    cases = {}
    for i, (label, kin, q) in enumerate(cs.sc_shapes()):
        n = q.shape[0]
        pt = sck._sphere_major(kin.compute_kinematics(q).spheres)
        tab = sck.pair_tables(kin.params.self_collision, pt.shape[0], dev)
        gen = torch.Generator(device="cpu").manual_seed(10 + i)
        up = (torch.rand(n, generator=gen) + 0.5).to(dev)
        calls = dict(sc_pair_cost=lambda: sck.sc_pair_cost(tab, pt, ACT),
                     sc_pair_grad=lambda: sck.sc_pair_grad(tab, pt, up, ACT),
                     sc_pair_viol=lambda: sck.sc_pair_viol(tab, pt))
        plain = dict(sc_pair_cost=lambda: sck.sc_pair_cost_plain(tab, pt, ACT),
                     sc_pair_grad=lambda: sck.sc_pair_grad_plain(tab, pt, up, ACT),
                     sc_pair_viol=lambda: sck.sc_pair_viol_plain(tab, pt))
        case = dict(candidates=n, spheres=pt.shape[0], live_pairs=tab.P, ms={}, device_ms={},
                    max_rel_vs_plain={})
        for k in KERNELS:
            got, ref = calls[k](), plain[k]()
            case["max_rel_vs_plain"][k] = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
            case["ms"][k] = cs.best_ms(calls[k], 20)
            case["device_ms"][k] = cs.device_ms(calls[k])
        if label == "g1/line_search":
            # what bounds the kernels: no pair inside the hinge (activation
            # -1: staging and barriers alone) and every pair on the exact
            # path (activation 1 m)
            case["device_ms_activation"] = {
                str(a): dict(sc_pair_cost=cs.device_ms(lambda: sck.sc_pair_cost(tab, pt, a)),
                             sc_pair_grad=cs.device_ms(lambda: sck.sc_pair_grad(tab, pt, up, a)))
                for a in (-1.0, ACT, 1.0)}
        cases[label] = case
    return dict(root=root, gpu=cs.gpu_line(), torch=torch.__version__, cases=cases)


def run_g1(root: str, env: dict) -> dict:
    """The `g1` line of `root`'s own `chip_smoke.py --g1`."""
    out = subprocess.run([sys.executable, "chip_smoke.py", "--g1"], env=env, capture_output=True,
                         text=True, cwd=root)
    if out.returncode != 0:
        raise SystemExit(f"chip_smoke.py --g1 in {root} failed:\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    for line in out.stdout.splitlines():
        if line.startswith("{") and json.loads(line).get("phase") == "g1":
            g = json.loads(line)
            return dict(root=root, g1={k: g[k] for k in G1_KEYS},
                        busy_share=g["profile"]["busy_share"], ms_per_solve=g["ms_per_solve"],
                        pair_kernel_launches=g["pair_kernel_launches"], gpu=g["gpu"])
    raise SystemExit(f"chip_smoke.py --g1 in {root} printed no g1 line")


def median(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def main():
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--child":
        print(json.dumps(child(os.path.abspath(args[1]))), flush=True)
        return
    with_g1 = "--g1" in args
    args = [a for a in args if a != "--g1"]
    if len(args) != 2:
        raise SystemExit(__doc__)
    roots = [os.path.abspath(r) for r in args]
    runs, g1_runs = [], []
    for root in (roots[0], roots[1], roots[1], roots[0]):
        env = dict(os.environ, CUROBO_TORCH_BUILD_DIR=os.path.join(root, "curobo_tpu_torch", "ops", "_build"))
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root], env=env,
                             capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            raise SystemExit(f"run in {root} failed:\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
        if with_g1:
            g1_runs.append(run_g1(root, env))
            print(json.dumps(g1_runs[-1]), flush=True)

    summary = {}
    for which, root in zip(("old", "new"), roots):
        mine = [r for r in runs if r["root"] == root]
        summary[which] = {
            label: {m: {k: median(r["cases"][label][m][k] for r in mine) for k in KERNELS}
                    for m in ("ms", "device_ms")}
            for label in mine[0]["cases"]}
        g1 = [r["cases"]["g1/line_search"]["device_ms_activation"] for r in mine]
        summary[which]["g1/line_search"]["device_ms_activation"] = {
            a: {k: median(x[a][k] for x in g1) for k in g1[0][a]} for a in g1[0]}
        ends = [r for r in g1_runs if r["root"] == root]
        if ends:
            summary[which]["g1_end_to_end"] = dict(
                {k: median(r["g1"][k] for r in ends) for k in G1_KEYS},
                busy_share=median(r["busy_share"] for r in ends))
    print(json.dumps(dict(summary=summary, roots=dict(old=roots[0], new=roots[1]),
                          order="old, new, new, old", gpu=runs[0]["gpu"])), flush=True)


if __name__ == "__main__":
    main()
