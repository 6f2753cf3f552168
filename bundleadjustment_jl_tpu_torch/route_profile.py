"""Time the port's four kernel routes on synthetic Final-4585 (or a
capacity problem), and profile a route-B1 and a route-B2 solve, on one
CUDA card.

    python -m bundleadjustment_jl_tpu_torch.route_profile [--problem NAME]

The problem is ``chip_smoke.py``'s Final-4585 (``bench.make_problem``) or,
named by ``--problem``, a problem of ``capacity.CAPACITY`` as its run
builds it (``capacity.make``: ``final13682`` is the largest), in float32;
each solve is timed by ``bench.timed_solve``, with its options. Each
route is forced by the gate settings of ``normal.FORCE_ROUTE``: a warm-up
per route, then two timed solves per route in the order A, B1, C, B2, B2,
C, B1, A. Then one ``torch.profiler`` trace of a solve on B1 and on B2:
device ms and launches by kernel (``kernel_profile.kernel_sums``). Prints
one JSON line per route and per profile; the Chrome traces go to the
git-ignored kernel build directory. The device's idle share of a solve
is the benchmark's (``perfbench/run.py --trace 1``: ``device_idle_share``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from collections import defaultdict

import torch

from bundleadjustment_jl_tpu_torch import bench, capacity
from bundleadjustment_jl_tpu_torch.kernel_profile import kernel_sums
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
                          "kernels": kernel_sums(path)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
