"""Reduction of a ``torch.profiler`` Chrome trace by the port's spans, the
``ba.*`` annotations of `bundleadjustment_jl_tpu_torch/utils/profiling.py`
(``ba.solve``, ``ba.linearize``, ``ba.reduce``, ``ba.pcg``,
``ba.dense.assemble``, ``ba.dense.factor``, ``ba.backsub``, ``ba.trial``,
``ba.plan.<key>``), inside the same window
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

The benchmark's drivers keep the reduction of every traced window as the
run's ``spans`` (`perfbench/drivers/closed_loop.py`), and the stage metrics'
readers (`perfbench/metrics/`) take their numbers from :func:`per_solve`.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

from perfbench.trace import DEVICE_CATS, WINDOW, short, union

PREFIX = "ba."
PLAN = "ba.plan"
SOLVE = "ba.solve"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "unattributed"
OUTSIDE = "outside"
# Per-solve stage metrics: name -> (what, the spans it sums). The step
# solver's stage is ``ba.pcg`` with the spans the dense step opens inside it.
STEP = ("ba.pcg", "ba.dense.assemble", "ba.dense.factor")
STAGE_MS = {"linearize_ms": ("device", ("ba.linearize",)),
            "reduce_ms": ("device", ("ba.reduce",)),
            "cg_ms": ("device", STEP),
            "backsub_ms": ("device", ("ba.backsub",)),
            "trial_ms": ("device", ("ba.trial",)),
            "cg_idle_ms": ("idle", STEP),
            "lm_idle_ms": ("idle", (SOLVE,))}


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
    :data:`STAGE_MS` and ``plan_ms``; a metric none of whose spans is in
    the trace (a program without spans) is left out, and with no reduction
    there is none."""
    if not red or nsolves <= 0:
        return {}
    out = {}
    for metric, (what, names) in STAGE_MS.items():
        found = [red[what][n] for n in names if n in red[what]]
        if found:
            out[metric] = 1e3 * sum(found) / nsolves
    if red["plan_s"] > 0:
        out["plan_ms"] = 1e3 * red["plan_s"] / nsolves
    return out


def read_stage(ctx, metric: str):
    """Stage metric ``metric`` of a run (`perfbench/run.py`'s ``ctx``): ms a
    traced solve from the run's ``spans``, or None where it has none."""
    return per_solve(ctx.run.get("spans"), len(ctx.run["solves"])).get(metric)
