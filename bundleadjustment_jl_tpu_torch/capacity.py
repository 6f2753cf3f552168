"""The capacity and first-order runs: the JAX package's three largest
synthetic BAL problems, each solved once the way the JAX package's
``scripts/tpu_capacity.py``, ``scripts/final_firstorder.py`` and
``scripts/venice_firstorder.py`` solve them.

    python -m bundleadjustment_jl_tpu_torch.capacity [--only NAME]
        [--device cuda|cpu] [--out PATH]

Run from the repository root. :data:`CAPACITY` holds the capacity runs
(Venice-1350 and Venice-1778 with float32 W on the chunked driver, three
iterations a chunk; Final-13682 with W stored in bfloat16, one iteration a
chunk), :data:`FIRST_ORDER` the two gradient-criterion runs (objective-change
and step tests off, ``rtol`` 1e-6 on ||J'r||). Every problem is
``synthetic_bal`` with the JAX scripts' arguments (:func:`recipe`:
``seed = ncams``, unit pixel noise, ``perturb = 2e-2``, float32, rows padded
to 512), so one name gives the JAX package's arrays bit for bit.

Each run (:func:`run`) builds its problem on the device (``gen_s``: the
numpy generator and the copy to the device), builds the launch plans its
kernel route reads (``plan_build_s``), solves once to warm up and then once
timed by the host clock between two ``torch.cuda.synchronize()`` calls
(``solve_s``), with the kernel launches counted from 0 and the peak device
memory (``torch.cuda.max_memory_allocated``) read around the timed solve.
The warm-up's cached blocks are released first (``torch.cuda.empty_cache``);
where the timed solve still finds no room beside what the warm-up left
(``torch.cuda.OutOfMemoryError``), the run says so on stderr and its line
holds the warm-up, the first solve, timed the same way, with
``"warmup": false``.

Each run prints one JSON line with the fields of the JAX package's
``benchmark_results/capacity.jsonl`` (``problem``, ``nobs``, ``nvar``,
``gen_s``, ``solve_s``, ``iters``, ``status``, ``objective``, ``rmse_px``,
``expected_obj``) and ``expected_rmse`` = sqrt(1 - nvar / (2 nobs)),
``facto_dtype``, ``route``, ``launches`` by kernel, ``peak_gb``,
``plan_build_s``, ``card`` (``nvidia-smi``'s name and power limit) and the
JAX record the run is held to (``record``); ``misses`` lists the bars of
:func:`misses` it fails. Lines go to stdout and, with ``--out``, are
appended to that file; nothing is written anywhere else (the JAX package's
``benchmark_results/`` is its own record). The module runs on the card and
raises without one unless ``--device cpu`` is given (no fallback); it
imports torch and numpy, never jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import NamedTuple

import torch

# The BAL problems of the runs, (family, ncams, npnts, obs_per_pnt): the
# JAX package's `benchmark/problems.py:39-41` sizes, with the JAX
# scripts' observations a point (`scripts/tpu_capacity.py:35-40`).
SIZES = {
    "venice1350": ("Venice", 1350, 894716, 5),
    "venice1778": ("Venice", 1778, 993923, 5),
    "final13682": ("Final", 13682, 4456117, 7),
}

# The solver options of the JAX runs (`scripts/tpu_capacity.py:105-110`;
# `scripts/final_firstorder.py:53-55`, `scripts/venice_firstorder.py:46-48`
# with their rtol 1e-6 of benchmark_results/stats.jsonl's rtol_gradient).
CAPACITY_OPTS = dict(pcg_max_iters=100, lam0_mode="diag", satol=0.0,
                     srtol=0.0, atol=0.0, rtol=1e-5, oatol=0.0, ortol=1e-4)
FIRST_ORDER_OPTS = dict(pcg_max_iters=200, lam0_mode="diag", satol=0.0,
                        srtol=0.0, atol=0.0, rtol=1e-6, oatol=0.0, ortol=0.0)
# The JAX chunked runs' wall-clock bound (seconds).
MAX_TIME = 3600.0


class Run(NamedTuple):
    problem: str               # key of SIZES
    chunk_iters: int | None    # iterations a chunk; None: the one-shot driver
    max_iters: int
    facto_dtype: str | None    # W storage; None: float32
    opts: dict
    route: str                 # the kernel route the default gates pick
    record: tuple | None       # the JAX record: (status, iterations, rmse_px)


# The JAX records: benchmark_results/capacity.jsonl (the capacity runs) and
# benchmark_results/stats.jsonl (the first-order runs; Venice-1778's ran
# with camera scatter off).
CAPACITY = {
    "venice1350": Run("venice1350", 3, 30, None, CAPACITY_OPTS, "fused",
                      ("small_obj_change", 9, 0.8362)),
    "venice1778": Run("venice1778", 3, 30, None, CAPACITY_OPTS, "fused",
                      ("small_obj_change", 9, 0.8357)),
    "final13682": Run("final13682", 1, 10, "bfloat16", CAPACITY_OPTS,
                      "scatter_split", ("small_obj_change", 9, 0.8853)),
}
FIRST_ORDER = {
    "final13682-firstorder": Run("final13682", 1, 40, "bfloat16",
                                 FIRST_ORDER_OPTS, "scatter_split",
                                 ("first_order", 18, 0.8853)),
    "venice1778-firstorder": Run("venice1778", None, 100, None,
                                 FIRST_ORDER_OPTS, "fused",
                                 ("first_order", 13, 0.8357)),
}
RUNS = {**CAPACITY, **FIRST_ORDER}

# The bars a run is held to against its record: iterations within
# ITERS_BAR[W stored narrow] (one in float32; two with bfloat16 W, whose
# CG floor and stops move a decision by a step: ROADMAP.md §C), the rmse
# within RMSE_REL of the record and of expected_rmse.
ITERS_BAR = {False: 1, True: 2}
RMSE_REL = 0.01

# The launch plans each kernel route reads (`ops/plans.py`), built before
# the warm-up and timed as plan_build_s.
ROUTE_PLANS = {
    "fused": ("point_blocks", "tile_plan"),
    "scatter_split": ("point_blocks", "tile_plan", "cam_obs", "cam_pnt"),
    "sorted": ("point_blocks", "cam_col_plan", "wcw_col_plan"),
    "sorted_relin": ("point_blocks", "tile_plan", "cam_col_plan",
                     "wcw_col_plan", "cam_row_plan"),
}


def recipe(ncams: int, npnts: int, obs_per_pnt: int) -> dict:
    """``synthetic_bal``'s arguments for a problem of these sizes, as the
    JAX scripts make it (`scripts/tpu_capacity.py:_cached_problem`)."""
    return dict(ncams=ncams, npnts=npnts, obs_per_pnt=obs_per_pnt,
                noise_px=1.0, perturb=2e-2, seed=ncams, pad_obs_to=512)


def make(name: str, device: str = "cuda"):
    """``(problem, gen_s)``: problem ``name`` of :data:`SIZES` in float32 on
    ``device`` and the seconds its construction took (device synchronized)."""
    from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
    family, ncams, npnts, opp = SIZES[name]
    t0 = time.perf_counter()
    problem = synthetic_bal(**recipe(ncams, npnts, opp), dtype=torch.float32,
                            name=f"{family}-{ncams}-{npnts}",
                            device=device)[0]
    _sync(device)
    return problem, time.perf_counter() - t0


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def build_plans(problem, route: str) -> float:
    """Seconds to build the launch plans ``route`` reads on ``problem``
    (kept on it, so the solves reuse them)."""
    from bundleadjustment_jl_tpu_torch.ops import plans
    device = problem.cams.device.type
    _sync(device)
    t0 = time.perf_counter()
    for plan in ROUTE_PLANS[route]:
        getattr(plans, plan)(problem)
    _sync(device)
    return time.perf_counter() - t0


def solve(problem, spec: Run):
    """One solve of ``problem`` as ``spec`` gives it: the chunked driver
    (with the JAX runs' wall-clock bound) or the one-shot driver."""
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
        levenberg_marquardt_jit, levenberg_marquardt_jit_chunked)
    facto = None if spec.facto_dtype is None else getattr(
        torch, spec.facto_dtype)
    if spec.chunk_iters is None:
        return levenberg_marquardt_jit(problem, max_iters=spec.max_iters,
                                       facto_dtype=facto, **spec.opts)
    return levenberg_marquardt_jit_chunked(
        problem, max_iters=spec.max_iters, chunk_iters=spec.chunk_iters,
        max_time=MAX_TIME, facto_dtype=facto, **spec.opts)


def _timed(problem, spec: Run, device: str):
    """``(seconds, result, launches, W launches, peak GB)`` of one solve
    (launches counted from 0, peak memory reset before it)."""
    from bundleadjustment_jl_tpu_torch.ops import _cuda
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = solve(problem, spec)
    _sync(device)
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() / 1e9 if device == "cuda"
            else None)
    return secs, res, dict(_cuda.LAUNCHES), dict(_cuda.W_LAUNCHES), peak


def run(name: str, device: str = "cuda", built=None,
        card: str | None = None) -> dict:
    """Run ``name`` of :data:`RUNS` and return its JSON line (module
    docstring). ``built``: ``(problem, gen_s)`` of :func:`make` to solve
    instead of building it (its plans are built anew, on a copy)."""
    from bundleadjustment_jl_tpu_torch.ops import normal
    spec = RUNS[name]
    problem, gen_s = built if built is not None else make(spec.problem,
                                                          device)
    problem = dataclasses.replace(problem, plans={})
    route = normal.kernel_route(problem)
    plan_s = build_plans(problem, route)
    first = _timed(problem, spec, device)
    if device == "cuda":
        torch.cuda.empty_cache()
    try:
        secs, res, counts, w_counts, peak = _timed(problem, spec, device)
        warm = True
    except torch.cuda.OutOfMemoryError:
        print(f"[capacity] {name}: the timed solve found no room beside "
              f"what the warm-up left; the line holds the first solve",
              file=sys.stderr)
        torch.cuda.empty_cache()
        secs, res, counts, w_counts, peak = first
        warm = False
    it = res.iterations
    nobs, nvar = problem.nobs, problem.nvar
    g = res.hist_gnorm[:it]
    line = {
        "problem": problem.name, "run": name, "device": device,
        "nobs": nobs, "nobs_pad": problem.nobs_pad, "nvar": nvar,
        "gen_s": gen_s, "plan_build_s": plan_s, "solve_s": secs,
        "first_solve_s": first[0], "warmup": warm,
        "iters": it, "status": res.status_name(),
        "objective": res.objective,
        "rmse_px": math.sqrt(res.objective / nobs),
        "expected_obj": 0.5 * (2 * nobs - nvar),
        "expected_rmse": math.sqrt(1.0 - nvar / (2 * nobs)),
        "naccepts": res.naccepts, "cg_matvecs": int(res.hist_cg[:it].sum()),
        "dual_feas": res.dual_feas,
        "gnorm0": float(g[0]) if it else None,
        "gnorm_min": float(g.min()) if it else None,
        "facto_dtype": spec.facto_dtype, "route": route,
        "driver": "one-shot" if spec.chunk_iters is None else "chunked",
        "chunk_iters": spec.chunk_iters, "max_iters": spec.max_iters,
        "launches": {k: v for k, v in counts.items() if v},
        "w_launches": {str(k)[6:]: v for k, v in w_counts.items() if v},
        "peak_gb": peak, "card": card,
        "record": (None if spec.record is None else dict(zip(
            ("status", "iters", "rmse_px"), spec.record))),
    }
    line["misses"] = misses(line, res, counts, w_counts)
    return line


def misses(line: dict, res, counts: dict, w_counts: dict) -> list[str]:
    """The bars run ``line["run"]`` misses: against the JAX record its
    status, iterations within :data:`ITERS_BAR`, the rmse within
    :data:`RMSE_REL` of the record's and of ``expected_rmse``; the route
    the default gates pick; and on the card the kernel launches of
    ``lm_jit.expected_launches`` / ``expected_w_launches`` for the solve's
    iterations, accepts and CG steps (``counts``, ``w_counts``:
    ``_cuda.LAUNCHES`` / ``W_LAUNCHES`` of the solve)."""
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
        expected_launches, expected_w_launches)
    spec = RUNS[line["run"]]
    out = []
    if spec.record is not None:
        status, iters, rmse = spec.record
        bar = ITERS_BAR[spec.facto_dtype is not None]
        if line["status"] != status:
            out.append(f"status {line['status']}, the record {status}")
        if abs(line["iters"] - iters) > bar:
            out.append(f"iterations {line['iters']}, the record {iters} "
                       f"(bar {bar})")
        for what, ref in (("the record", rmse),
                          ("expected_rmse", line["expected_rmse"])):
            if abs(line["rmse_px"] - ref) > RMSE_REL * ref:
                out.append(f"rmse {line['rmse_px']:.4f} not within "
                           f"{RMSE_REL:.0%} of {what} {ref:.4f}")
    if line["route"] != spec.route:
        out.append(f"route {line['route']}, the default gates' {spec.route}")
    if line["device"] == "cuda":
        it = res.iterations
        facto = None if spec.facto_dtype is None else getattr(
            torch, spec.facto_dtype)
        expect = dict.fromkeys(counts, 0)
        expect.update(expected_launches(line["route"], it, res.naccepts,
                                        int(res.hist_cg[:it].sum()),
                                        facto_dtype=facto))
        if counts != expect:
            out.append(f"launches {counts} != {expect}")
        w_expect = expected_w_launches(counts, facto)
        if w_counts != w_expect:
            out.append(f"W launches {w_counts} != {w_expect}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="capacity")
    p.add_argument("--only", choices=sorted(RUNS), default=None,
                   help="one run of CAPACITY or FIRST_ORDER")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default=None,
                   help="also append each JSON line to this file")
    args = p.parse_args(argv)
    card = None
    if args.device == "cuda":
        from bundleadjustment_jl_tpu_torch import bench
        from bundleadjustment_jl_tpu_torch.ops import _cuda
        bench.require_card()
        card = bench.card()["nvidia_smi"]
        _cuda.lib()                        # the kernels, built once
    missed = 0
    for name in ([args.only] if args.only else list(RUNS)):
        line = run(name, args.device, card=card)
        missed += bool(line["misses"])
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
