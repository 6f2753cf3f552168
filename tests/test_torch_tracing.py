"""The port's tracing (`utils/profiling.py`) on the CPU: the spans a solve
opens at the stages of an LM iteration, the null context with no profiler
recording, the host-read counter against its formula, and the span of
each launch plan built.

- A solve under ``torch.profiler`` (CPU activity) has in its Chrome trace
  one ``ba.solve``, ``naccepts + 1`` of ``ba.linearize`` and
  ``iterations`` each of ``ba.reduce``, ``ba.pcg``, ``ba.backsub`` and
  ``ba.trial``, every one inside the ``ba.solve``; the chunked driver the
  same; the host driver ``iterations`` each of ``ba.reduce``, ``ba.pcg``
  and ``ba.backsub``.
- With no profiler recording, :func:`span` returns its one null context
  and enters no ``record_function``.
- ``host_reads`` of a solve: `solver/lm_jit.py:expected_host_reads`, 1 +
  per iteration its step's flags (a CG step or power term each, one more
  where the step stopped before its bound) and the packed read + one a
  accept.
- Each plan accessor of `ops/plans.py` opens one ``ba.plan.<key>`` span
  (the outermost) when it builds, none when the plan is cached, and counts
  its builder's host reads: its checks' flags, and each ``nonzero``,
  ``unique`` and sum whose value sizes an output (the dense step's pair
  plan: its pair count and its chunk counts).
"""

import dataclasses
import json
from collections import Counter

import pytest
import torch

from bundleadjustment_jl_tpu_torch.io import synthetic_bal
from bundleadjustment_jl_tpu_torch.ops import plans
from bundleadjustment_jl_tpu_torch.solver import LMOptions, levenberg_marquardt
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    expected_host_reads, levenberg_marquardt_jit,
    levenberg_marquardt_jit_chunked)
from bundleadjustment_jl_tpu_torch.utils import profiling

torch.set_num_threads(1)

OPTS = dict(max_iters=60, pcg_max_iters=200)
STAGES = ("ba.reduce", "ba.pcg", "ba.backsub", "ba.trial")


@pytest.fixture(scope="module")
def prob():
    return synthetic_bal(ncams=8, npnts=60, obs_per_pnt=3, noise_px=0.4,
                         perturb=2e-3, seed=9, device="cpu")[0]


def traced_spans(tmp_path, fn):
    """``(fn()'s result, [(start, end, name)] of the ba.* annotations)``
    of ``fn`` run under a CPU profiler, read back from its Chrome trace."""
    path = tmp_path / "trace.json"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name", "").startswith("ba.")]


def check_solve_spans(res, spans):
    counts = Counter(n for _, _, n in spans)
    it = int(res.iterations)
    assert it > 2 and 0 < res.naccepts < it + 1
    assert counts == {"ba.solve": 1, "ba.linearize": res.naccepts + 1,
                      **dict.fromkeys(STAGES, it)}
    (s0, e0, _), = [sp for sp in spans if sp[2] == "ba.solve"]
    assert all(s0 <= s and e <= e0 for s, e, _ in spans)


@pytest.mark.parametrize("driver", ["one_shot", "chunked"])
def test_jit_solve_spans(prob, tmp_path, driver):
    if driver == "one_shot":
        def solve():
            return levenberg_marquardt_jit(prob, **OPTS)
    else:
        def solve():
            return levenberg_marquardt_jit_chunked(prob, chunk_iters=3,
                                                   **OPTS)
    res, spans = traced_spans(tmp_path, solve)
    check_solve_spans(res, spans)


def test_host_driver_spans(prob, tmp_path):
    res, spans = traced_spans(tmp_path, lambda: levenberg_marquardt(
        prob, LMOptions(solver="pcg", max_iters=60)))
    assert res.iterations > 2
    assert Counter(n for _, _, n in spans) == dict.fromkeys(
        ("ba.reduce", "ba.pcg", "ba.backsub"), res.iterations)


def test_span_off_enters_nothing(prob, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("ba.solve") is profiling.span("ba.pcg")
    with profiling.span("ba.solve"), profiling.span("ba.solve"):
        pass
    res = levenberg_marquardt_jit(prob, **OPTS)
    assert res.iterations > 2


@pytest.mark.parametrize("solver,max_steps", [
    ("pcg", 200), ("pcg", 4), ("power", 50), ("power", 3)])
def test_host_reads_formula(prob, solver, max_steps):
    profiling.reset_counters()
    res = levenberg_marquardt_jit(prob, use_power=solver == "power",
                                  max_iters=60, pcg_max_iters=max_steps)
    reads = profiling.COUNTERS["host_reads"]
    it = int(res.iterations)
    assert it > 2
    if max_steps < 10:   # the bound was hit, so its read was left out
        assert any(int(c) == max_steps for c in res.hist_cg[:it])
    assert reads == expected_host_reads(it, int(res.naccepts), res.hist_cg,
                                        max_steps)
    profiling.reset_counters()
    assert profiling.COUNTERS["host_reads"] == 0


@pytest.fixture(scope="module")
def prob32():
    return synthetic_bal(ncams=12, npnts=400, obs_per_pnt=5, seed=4,
                         dtype=torch.float32, device="cpu")[0]


# accessor, the outermost span it opens, the host reads its builders make
PLANS = [
    (plans.tile_plan, "ba.plan.tiles", 6),
    (plans.point_blocks, "ba.plan.point_blocks", 1),
    (plans.cam_pnt, "ba.plan.by_camera", 0),
    (plans.cam_col_plan, "ba.plan.cam_cols", 2),
    (plans.wcw_col_plan, "ba.plan.wcw_cols", 2),
    (plans.cam_row_plan, "ba.plan.cam_rows", 0),
    (plans.cam_obs, "ba.plan.cam_obs", 0),
    (plans.rows, "ba.plan.rows", 0),
    (plans.pair_plan, "ba.plan.pairs", 2),
]


@pytest.mark.parametrize("accessor,name,reads", PLANS,
                         ids=[p[1] for p in PLANS])
def test_plan_span_on_build_only(prob32, tmp_path, accessor, name, reads):
    problem = dataclasses.replace(prob32, plans={})
    if accessor is plans.rows:
        problem = problem.astype(torch.bfloat16)
    profiling.reset_counters()
    built, spans = traced_spans(tmp_path, lambda: accessor(problem))
    outer = [sp for sp in spans
             if not any(o[0] <= sp[0] and sp[1] <= o[1] and o != sp
                        for o in spans)]
    assert [n for _, _, n in outer] == [name]
    assert all(n.startswith("ba.plan.") for _, _, n in spans)
    assert profiling.COUNTERS["host_reads"] == reads
    again, spans = traced_spans(tmp_path, lambda: accessor(problem))
    assert spans == [] and again is built
    assert profiling.COUNTERS["host_reads"] == reads
