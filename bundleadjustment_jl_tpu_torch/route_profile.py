"""Time the port's four kernel routes on synthetic Final-4585 (or a
capacity problem), and profile a route-B1 and a route-B2 solve, on one
CUDA card.

    python -m bundleadjustment_jl_tpu_torch.route_profile [--problem NAME]

The problem is ``chip_smoke.py``'s Final-4585 (``bench.make_problem``) or,
named by ``--problem``, a problem of ``capacity.CAPACITY`` as its run
builds it (``capacity.make``: ``final13682`` is the largest), in float32;
each solve is timed as the bench leg times its (``bench.timed_solve``,
with its options). Each route is forced by the gate settings of
``normal.FORCE_ROUTE``: a warm-up per route, then two timed solves per
route in the order A, B1, C, B2, B2, C, B1, A. Then one ``torch.profiler``
trace of a solve on B1 and on B2: device busy time (the sum of the trace's
kernel events), span (first kernel start to last kernel end), idle share,
and device time by kernel. Prints one JSON line per route and per
profile; the Chrome traces go to the git-ignored kernel build directory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from collections import defaultdict
from pathlib import Path

import torch

from bundleadjustment_jl_tpu_torch import bench, capacity
from bundleadjustment_jl_tpu_torch.ops import _cuda, normal

ORDER = ("fused", "scatter_split", "sorted", "sorted_relin")
PROFILED = ("scatter_split", "sorted_relin")


@contextlib.contextmanager
def forced(route):
    gates = normal.FORCE_ROUTE[route]
    old = {k: getattr(normal, k) for k in gates}
    try:
        for k, v in gates.items():
            setattr(normal, k, v)
        yield
    finally:
        for k, v in old.items():
            setattr(normal, k, v)


def kernel_breakdown(trace_path: Path) -> dict:
    """Busy time, span and idle share of the trace's kernel events, and
    device ms and launches by kernel name."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("cat") == "kernel"]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e["name"]][0] += e["dur"] / 1e3
        by_name[e["name"]][1] += 1
    busy = sum(e["dur"] for e in events) / 1e3
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"busy_ms": busy, "span_ms": span, "idle_share": 1 - busy / span,
            "kernels": {k: {"ms": ms, "launches": n} for k, (ms, n) in top}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="route_profile")
    p.add_argument("--problem", default="final4585",
                   choices=["final4585", *capacity.CAPACITY])
    name = p.parse_args(argv).problem
    if not torch.cuda.is_available():
        print("route_profile: no CUDA card", file=sys.stderr)
        return 2
    card = bench.card()["nvidia_smi"]
    print(f"card: {card}")
    out = _cuda.BUILD_DIR / "route_profile"
    out.mkdir(parents=True, exist_ok=True)
    problem = (bench.make_problem(name, 0) if name in bench.PROBLEMS
               else capacity.make(capacity.CAPACITY[name].problem)[0])

    def solve_on(route):
        with forced(route):
            if normal.kernel_route(problem) != route:
                raise AssertionError(f"gates did not force {route}")
            return bench.timed_solve(problem)

    peak, times, last = {}, defaultdict(list), {}
    for route in ORDER:                                    # warm-ups
        torch.cuda.reset_peak_memory_stats()
        solve_on(route)
        peak[route] = torch.cuda.max_memory_allocated() / 2**30
    for route in ORDER + ORDER[::-1]:
        secs, last[route] = solve_on(route)
        times[route].append(secs)
    for route in ORDER:
        res = last[route]
        print(json.dumps({
            "problem": name, "route": route, "values": times[route],
            "status": res.status_name(), "iterations": res.iterations,
            "cg_matvecs": int(res.hist_cg[:res.iterations].sum()),
            "naccepts": res.naccepts, "objective": res.objective,
            "rmse_px": (res.objective / problem.nobs) ** 0.5,
            "peak_gib": peak[route], "card": card}))

    from torch.profiler import ProfilerActivity, profile
    for route in PROFILED:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            secs, _ = solve_on(route)
        path = out / f"{name}_{route}.json"
        prof.export_chrome_trace(str(path))
        print(json.dumps({"problem": name, "route": route,
                          "profiled_solve_s": secs,
                          **kernel_breakdown(path)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
