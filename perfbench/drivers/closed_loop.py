"""The closed loop of solves: one caller hands the solver one problem after
another and waits for each answer, as a pipeline that re-runs bundle
adjustment does.

Set-up makes the problem and ``starts`` starting states (`perfbench/gen.py`)
from the traffic's ``data_seed``, or from the run's seed where the traffic
names none, builds the system's problem once through
``BAProblem.from_arrays`` and solves from the first ``warmup`` starts of
the run's order, so that every kernel is built and every shape seen before
the window. The run's seed draws the order of the starts: with a
``data_seed`` every seed does the same work, in another order. In the
window, solve i is ``levenberg_marquardt_jit`` on a fresh problem with
empty launch plans on the same device arrays, from start ``order[i mod
starts]``: every solve builds its own plans, as a user's solve of a new
problem does.
The window runs whole solves until ``seconds`` have passed; its length is
from its start to the end of the last solve, so no work and no time is
left out. With ``trace`` the window is traced by ``torch.profiler`` and
ends after the traffic's ``trace_solves`` solves, or ``seconds``, and its
Chrome trace is reduced twice before it is deleted: by device operation
(`perfbench/trace.py`, the run's ``trace``) and by the port's spans
(`perfbench/spans.py`, the run's ``spans``).

The window also keeps two counts, read on the host alone (no device work,
no synchronize): each solve's host reads, the change of the program's
``utils.profiling.COUNTERS["host_reads"]`` over the solve (none where the
program has no such counter), and the caching allocator's calls into the
device over the whole window (``torch.cuda.memory_stats()``'s
``num_device_alloc + num_device_free``, and ``num_alloc_retries``, read at
its start and its end; None off the card).

Once the window has closed and the peak memory is read, the system's state
is freed and the reference (`perfbench/reference.py`) solves the same
problem from the start of each sampled solve (``sample`` solves drawn from
the seed among the window's first ``sample_within``); `perfbench/judge.py`
holds each sampled answer against it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from pathlib import Path

import torch

from perfbench import gen, judge, spans
from perfbench.reference import Reference
from perfbench.trace import WINDOW, reduce_file

# Variants of the system that the calibration runs in the system's place:
# "sut" the configuration as it states itself; "control" the system's own
# bfloat16 working type (the precision cascade's path), the precision
# below the configuration's float32.
VARIANTS = ("sut", "control")
# The caching allocator's counts (`torch.cuda.memory_stats`) the window reads.
ALLOC_STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def _port():
    """The system under test: its problem type and one-shot driver, looked
    up at each call so that a test can put a broken one in their place."""
    from bundleadjustment_jl_tpu_torch.models import problem
    from bundleadjustment_jl_tpu_torch.solver import lm_jit
    return problem.BAProblem, lm_jit


def _counters():
    """The program's counters (`utils/profiling.py:COUNTERS`), or None for a
    program that keeps no host-read count."""
    try:
        from bundleadjustment_jl_tpu_torch.utils.profiling import COUNTERS
    except ImportError:
        return None
    return COUNTERS if "host_reads" in COUNTERS else None


def allocator_stats(device: str) -> dict | None:
    """The caching allocator's :data:`ALLOC_STATS` so far, or None off the
    card or where this PyTorch keeps no such count."""
    if device != "cuda":
        return None
    stats = torch.cuda.memory_stats()
    return {k: stats[k] for k in ALLOC_STATS} if all(
        k in stats for k in ALLOC_STATS) else None


def allocator_calls(before: dict | None, after: dict | None) -> dict | None:
    """The allocator's device calls (``num_device_alloc +
    num_device_free``) and retries between two :func:`allocator_stats`."""
    if before is None or after is None:
        return None
    d = {k: after[k] - before[k] for k in ALLOC_STATS}
    return {"device_calls": d["num_device_alloc"] + d["num_device_free"],
            "retries": d["num_alloc_retries"]}


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def prepare(cfg: dict, traffic: dict, seed: int, device: str,
            variant: str = "sut", marks: dict | None = None):
    """``(problem, starts, inputs)``: the system's problem and starts on
    ``device``, and the generated arrays the reference reads (the rows on
    the host, as ``BAProblem.from_arrays`` takes them, and the starts in
    the configuration's working type on ``device``). ``marks`` gets the
    clock's reading after each step of the set-up."""
    if variant not in VARIANTS:
        raise ValueError(f"variant: one of {VARIANTS}")
    marks = {} if marks is None else marks
    BAProblem, _ = _port()
    marks["imports"] = time.perf_counter()
    data = gen.make(cfg, int(traffic["starts"]),
                    int(traffic.get("data_seed", seed)), device)
    _sync(device)
    marks["generate"] = time.perf_counter()
    inputs = {k: data[k].cpu() for k in ("cam_idx", "pnt_idx", "pt2d")}
    c0, p0 = data["starts"][0]
    c0, p0 = c0.cpu().numpy(), p0.cpu().numpy()
    marks["to_host"] = time.perf_counter()
    problem = BAProblem.from_arrays(
        c0, p0, inputs["cam_idx"].numpy(), inputs["pnt_idx"].numpy(),
        inputs["pt2d"].numpy(), dtype=getattr(torch, cfg["dtype"]),
        pad_obs_to=int(cfg["pad_obs_to"]), name=cfg["name"], device=device)
    _sync(device)
    marks["from_arrays"] = time.perf_counter()
    starts = inputs["starts"] = data["starts"]
    if variant == "control":
        problem = problem.astype(torch.bfloat16)
        starts = [(c.to(torch.bfloat16), p.to(torch.bfloat16))
                  for c, p in starts]
    return problem, starts, inputs


def solver_opts(cfg: dict) -> dict:
    facto = cfg.get("facto_dtype")
    return dict(cfg["solver"], facto_dtype=None if facto is None
                else getattr(torch, facto))


def solve(problem, start, opts: dict):
    """One solve of a fresh copy of ``problem`` (empty launch plans) from
    ``start``."""
    _, lm_jit = _port()
    fresh = dataclasses.replace(problem, plans={}, cams=start[0],
                                points=start[1])
    return lm_jit.levenberg_marquardt_jit(fresh, **opts)


def start_order(seed: int, nstarts: int) -> list:
    """The order in which the window takes the starts, drawn from the
    run's seed."""
    return random.Random(seed).sample(range(nstarts), nstarts)


def draw_sample(seed: int, k: int, within: int) -> list:
    return sorted(random.Random(seed).sample(range(within), min(k, within)))


def reference_numbers(cfg: dict, inputs: dict, kept: dict, device: str):
    """Each kept solve ``{index: (start id, result)}`` held against the
    reference's solve from its start: ``(the gaps of :func:`judge.numbers`,
    one dict a solve; the decisions of both sides, one dict a solve, with
    the reference's :func:`judge.last_step`)``."""
    facto = cfg.get("facto_dtype")
    ref = Reference(inputs["cam_idx"].to(device),
                    inputs["pnt_idx"].to(device),
                    inputs["pt2d"].to(device), int(cfg["ncams"]),
                    int(cfg["npnts"]), dtype=torch.float64,
                    w_dtype=None if facto is None else getattr(torch, facto),
                    work_dtype=getattr(torch, cfg["dtype"]))
    solved, readings, pairs = {}, [], []
    for s, res in kept.values():
        if s not in solved:
            c, p = inputs["starts"][s]
            solved[s] = judge.summary(ref.solve(c.to(device), p.to(device),
                                                cfg["solver"]))
        answer = ref.objective(res["cams"], res["points"])
        readings.append(judge.numbers(res["summary"], solved[s], answer))
        pairs.append({side: {k: v[k] for k in ("status", "iterations", "cg",
                                                 "objective")}
                      for side, v in (("sut", res["summary"]),
                                      ("ref", solved[s]))})
        pairs[-1]["ref"]["last_step"] = judge.last_step(solved[s])
    return readings, pairs


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, out_dir: Path, variant: str = "sut",
        warmup: bool = True) -> dict:
    """One run of ``cell`` (`perfbench/spec.py:load_cell`): set-up, the
    window, the reference's check. Returns what the metrics and the result
    line read, with ``setup_phases``: the seconds of each step of the
    set-up. One caller on one card."""
    if cell.chips != 1:
        raise ValueError("the closed loop runs on one card; a cell over "
                         "ranks needs a driver of its own")
    cfg, traffic, own = cell.config, cell.traffic, cell.cell
    opts = solver_opts(cfg)
    nstarts = int(traffic["starts"])
    order = start_order(seed, nstarts)
    marks = {"start": t0}
    problem, starts, inputs = prepare(cfg, traffic, seed, device, variant,
                                      marks)
    if warmup:
        for s in order[:int(traffic["warmup"])]:
            solve(problem, starts[s], opts)
    limit = int(own["trace_solves"]) if trace else None
    within = int(own["sample_within"])
    sample = draw_sample(seed, int(own["sample"]),
                         within if limit is None else min(within, limit))
    _sync(device)
    marks["warmup"] = time.perf_counter()
    setup_s = marks["warmup"] - t0
    names = list(marks)
    phases = {b: marks[b] - marks[a] for a, b in zip(names, names[1:])}

    solves, kept, last = [], {}, None
    counters = _counters()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as traced:
        if trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            prof = traced.enter_context(profile(activities=[
                ProfilerActivity.CPU, *([ProfilerActivity.CUDA]
                                        if device == "cuda" else [])]))
            traced.enter_context(record_function(WINDOW))
        a0 = allocator_stats(device)
        w0 = time.perf_counter()
        i = 0
        while True:
            s = order[i % nstarts]
            reads = None if counters is None else counters["host_reads"]
            ts = time.perf_counter()
            res = solve(problem, starts[s], opts)
            _sync(device)
            te = time.perf_counter()
            summ = judge.summary(res)
            solves.append(dict(summ, seconds=te - ts, start=s))
            if counters is not None:
                solves[-1]["host_reads"] = counters["host_reads"] - reads
            # The last answer is kept too, to stand for a sampled index that
            # the window did not reach.
            last = (i, (s, {"summary": summ, "cams": res.cams,
                            "points": res.points}))
            if i in sample:
                kept[i] = last[1]
            del res
            i += 1
            if te - w0 >= seconds or (limit is not None and i >= limit):
                break
        window_s = te - w0
        alloc = allocator_calls(a0, allocator_stats(device))
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    red = stages = None
    if trace:
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"trace-{cell.name}.json"
        prof.export_chrome_trace(str(path))
        del prof
        red, stages = reduce_file(path), spans.reduce_file(path)
        path.unlink()
    if any(idx >= len(solves) for idx in sample):
        kept[last[0]] = last[1]
    inputs["starts"] = {s: inputs["starts"][s] for s, _ in kept.values()}
    del problem, starts, last
    if device == "cuda":
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    readings, pairs = reference_numbers(cfg, inputs, kept, device)
    return dict(setup_s=setup_s, setup_phases=phases, window_s=window_s,
                solves=solves,
                peak_bytes=peak, trace=red, spans=stages, alloc=alloc,
                sample=sorted(kept),
                readings=readings, numbers=judge.worst(readings), pairs=pairs,
                reference_s=time.perf_counter() - r0)
