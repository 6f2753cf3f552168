#!/usr/bin/env python3
"""Reduction of a ``torch.profiler`` Chrome trace by the port's spans, the
``ba.*`` annotations of `bundleadjustment_jl_tpu_torch/utils/profiling.py`
(``ba.solve``, ``ba.linearize``, ``ba.reduce``, ``ba.pcg``,
``ba.backsub``, ``ba.trial``, ``ba.plan.<key>``), inside the same window
as `perfbench/trace.py`'s:

- device time by span: each device operation (kernel, copy, fill) is joined
  through its ``correlation`` to the call that launched it (a
  ``cuda_runtime`` or ``cuda_driver`` event) and charged to the innermost
  ``ba.*`` span open when that call started, ``ba.plan.*`` counted as
  ``ba.plan``; an operation with no launch found, or launched outside every
  span, is ``unattributed``; and by span and operation name (``ops``);
- idle time by span: the gaps of ``trace.py`` (the window less the union of
  the device intervals), each charged to the innermost span open on the
  host at its midpoint, or to ``outside``;
- the host wall time of the outermost ``ba.plan.*`` spans, and the number
  of ``ba.solve`` spans that start in the window.

"Innermost" is the latest-starting span still open, as ``trace.py`` labels
a gap by its host operation.

Run from the root of a checkout on a card, it measures a cell's stages:

    python3 perfbench/spans.py --workload final13682.pcg --seed <n> \
        [--windows 1]

Set-up and warm-up as the cell's driver makes them
(`perfbench/drivers/closed_loop.py`), then each window traces the cell's
``trace_solves`` solves, each on a fresh problem, and prints one JSON
line: the stage metrics a solve (:func:`per_solve`), the host reads of
each solve beside their count from its decisions
(`solver/lm_jit.py:expected_host_reads`, plans left out), and the trace
metrics the cell reports (``ba_kernel_ms``, ``torch_ops_ms``,
``device_idle_share``) from the same trace. The command stands in for the
driver's traced run until that run keeps this module's reduction
(PERF.md, Open questions).
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from collections import defaultdict
from pathlib import Path

if __name__ == "__main__":  # run as a script: the checkout's packages
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.trace import DEVICE_CATS, WINDOW, short, union  # noqa: E402

PREFIX = "ba."
PLAN = "ba.plan"
SOLVE = "ba.solve"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "unattributed"
OUTSIDE = "outside"
# Operations a span shown by the command.
TOP = 6
# Per-solve stage metrics: name -> (what, span).
STAGE_MS = {"linearize_ms": ("device", "ba.linearize"),
            "reduce_ms": ("device", "ba.reduce"),
            "cg_ms": ("device", "ba.pcg"),
            "backsub_ms": ("device", "ba.backsub"),
            "trial_ms": ("device", "ba.trial"),
            "cg_idle_ms": ("idle", "ba.pcg"),
            "lm_idle_ms": ("idle", SOLVE)}


def bucket(name: str) -> str:
    """The span a time is charged to: ``ba.plan.<key>`` as ``ba.plan``."""
    return PLAN if name.startswith(PLAN + ".") else name


def innermost(spans: list, times: list) -> list:
    """For each time of ``times``, the name of the latest-starting span of
    ``spans`` ((start, end, name)) open at it (start <= t < end), or
    None."""
    spans = sorted(spans)
    out = [None] * len(times)
    stack, p = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while p < len(spans) and spans[p][0] <= t:
            stack.append(spans[p])
            p += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            out[i] = stack[-1][2]
    return out


def reduce_events(events: list) -> dict:
    """``window_s``, ``busy_s``, device seconds by span (``device``) and by
    span and operation (``ops``: span -> name -> seconds), idle seconds by
    span (``idle``), ``plan_s`` (outermost plan spans' wall time) and
    ``solves`` of the events of one trace, inside its
    :data:`perfbench.trace.WINDOW` annotation (the whole trace if there is
    none)."""
    dev, spans, windows, launch = [], [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((s, end, corr, short(name)))
        elif cat in LAUNCH_CATS and corr is not None:
            launch[corr] = s
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((s, end, name))
        elif cat == "user_annotation" and name == WINDOW:
            windows.append((s, end))
    if windows:
        lo, hi = min(w[0] for w in windows), max(w[1] for w in windows)
    else:
        every = [(s, e) for s, e, *_ in dev + spans]
        lo, hi = (min(s for s, _ in every), max(e for _, e in every)) \
            if every else (0.0, 0.0)
    dev = [d for d in dev if d[1] > lo and d[0] < hi]
    at = dict(zip((d[2] for d in dev if d[2] in launch), innermost(
        spans, [launch[d[2]] for d in dev if d[2] in launch])))
    device = defaultdict(float)
    ops = defaultdict(lambda: defaultdict(float))
    for s, end, c, op in dev:
        name = at.get(c)
        key = bucket(name) if name else UNATTRIBUTED
        device[key] += (min(end, hi) - max(s, lo)) / 1e6
        ops[key][op] += (min(end, hi) - max(s, lo)) / 1e6
    merged = union([(s, e) for s, e, *_ in dev], lo, hi)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle = defaultdict(float)
    for (a, b), name in zip(gaps, innermost(spans, [0.5 * (a + b)
                                                    for a, b in gaps])):
        idle[bucket(name) if name else OUTSIDE] += (b - a) / 1e6
    plan_s, reach = 0.0, float("-inf")
    for s, end, name in sorted(spans):
        if name.startswith(PLAN + ".") and s >= reach:
            plan_s += max(0.0, min(end, hi) - max(s, lo)) / 1e6
            reach = end
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": sum(e - s for s, e in merged) / 1e6,
            "device": dict(device), "idle": dict(idle), "plan_s": plan_s,
            "ops": {k: dict(v) for k, v in ops.items()},
            "solves": sum(1 for s, _, n in spans
                          if n == SOLVE and lo <= s < hi)}


def reduce_file(path: Path) -> dict:
    return reduce_events(json.loads(Path(path).read_text())["traceEvents"])


def per_solve(red: dict | None, nsolves: int) -> dict:
    """The stage metrics of a reduction, ms a solve over ``nsolves``:
    :data:`STAGE_MS` and ``plan_ms``; a metric whose span is not in the
    trace (a program without spans) is left out, and with no reduction
    there is none."""
    if not red or nsolves <= 0:
        return {}
    out = {}
    for metric, (what, name) in STAGE_MS.items():
        if name in red[what]:
            out[metric] = 1e3 * red[what][name] / nsolves
    if red["plan_s"] > 0:
        out["plan_ms"] = 1e3 * red["plan_s"] / nsolves
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench/spans.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--windows", type=int, default=1)
    args = p.parse_args(argv)
    here = Path(__file__).resolve().parent
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import spec, trace
    from perfbench.drivers import closed_loop
    if not torch.cuda.is_available():
        print("spans: no CUDA card", file=sys.stderr)
        return 2
    try:
        from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
            expected_host_reads)
        from bundleadjustment_jl_tpu_torch.utils.profiling import COUNTERS
    except ImportError:  # a program without the counter
        COUNTERS = None
    cell = spec.load_cell(args.workload, here.parent / "BENCHMARK.json")
    nsolves = int(cell.cell["trace_solves"])
    cfg, traffic = cell.config, cell.traffic
    opts = closed_loop.solver_opts(cfg)
    nstarts = int(traffic["starts"])
    order = closed_loop.start_order(args.seed, nstarts)
    problem, starts, _ = closed_loop.prepare(cfg, traffic, args.seed, "cuda")
    for s in order[:int(traffic["warmup"])]:
        closed_loop.solve(problem, starts[s], opts)
    torch.cuda.synchronize()
    readers = {m: spec.load_reader(m) for m in
               ("ba_kernel_ms", "torch_ops_ms", "device_idle_share")}
    out = here / "out"
    out.mkdir(parents=True, exist_ok=True)
    i = 0
    for w in range(args.windows):
        solves = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for _ in range(nsolves):
                    s = order[i % nstarts]
                    before = None if COUNTERS is None \
                        else COUNTERS["host_reads"]
                    res = closed_loop.solve(problem, starts[s], opts)
                    torch.cuda.synchronize()
                    it, acc = int(res.iterations), int(res.naccepts)
                    solves.append({
                        "start": s, "iterations": it, "naccepts": acc,
                        "cg": int(sum(int(c) for c in res.hist_cg[:it]))})
                    if COUNTERS is not None:
                        solves[-1].update(
                            host_reads=COUNTERS["host_reads"] - before,
                            expected_reads=expected_host_reads(
                                it, acc, res.hist_cg,
                                opts["pcg_max_iters"]))
                    del res
                    i += 1
        path = out / f"spans-{cell.name}-{w}.json"
        prof.export_chrome_trace(str(path))
        del prof
        red, tred = reduce_file(path), trace.reduce_file(path)
        path.unlink()
        ctx = types.SimpleNamespace(cfg=cfg, run={"trace": tred,
                                                  "solves": solves})
        n = len(solves)
        line = {"window": w, "seed": args.seed, "solves": solves,
                "metrics": per_solve(red, n),
                "trace": {k: r(ctx) for k, r in readers.items()},
                "window_ms": 1e3 * red["window_s"] / n,
                "busy_ms": 1e3 * red["busy_s"] / n,
                "device_ms": {k: 1e3 * v / n
                              for k, v in red["device"].items()},
                "idle_ms": {k: 1e3 * v / n for k, v in red["idle"].items()},
                "top_ops_ms": {k: [[op[:60], 1e3 * t / n] for op, t in sorted(
                    v.items(), key=lambda kv: -kv[1])[:TOP]]
                    for k, v in red["ops"].items()},
                "span_solves": red["solves"],
                "card": torch.cuda.get_device_name(0)}
        if COUNTERS is not None:
            line["metrics"]["host_reads"] = sum(
                s["host_reads"] for s in solves) / n
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
