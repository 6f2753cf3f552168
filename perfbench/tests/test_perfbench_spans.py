"""The reduction of a trace by the port's spans (`perfbench/spans.py`), on
made-up events and on a traced solve of the tiny cell on the CPU."""

from __future__ import annotations

import pytest
import torch

from perfbench import spans, trace
from perfbench.drivers import closed_loop


def _ev(name, ts, dur, cat, corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _ev(trace.WINDOW, 0, 200, "user_annotation"),
    _ev("ba.solve", 5, 190, "user_annotation"),
    _ev("ba.pcg", 10, 40, "user_annotation"),
    _ev("ba.plan.tiles", 60, 30, "user_annotation"),
    _ev("ba.plan.by_camera", 65, 10, "user_annotation"),
    _ev("ba.plan.point_blocks", 100, 5, "user_annotation"),
    _ev("cudaLaunchKernel", 12, 2, "cuda_runtime", 1),
    _ev("cudaLaunchKernel", 66, 2, "cuda_runtime", 2),
    _ev("cudaLaunchKernel", 61, 2, "cuda_runtime", 3),
    _ev("cuLaunchKernel", 120, 2, "cuda_driver", 4),
    _ev("cudaMemcpyAsync", 198, 1, "cuda_runtime", 5),
    # device work: launched in ba.pcg, in ba.plan.by_camera inside
    # ba.plan.tiles, in ba.plan.tiles, in ba.solve alone, outside every
    # span, and one with no launch
    _ev("ba_matvec_kernel", 15, 20, "kernel", 1),
    _ev("gemvx", 70, 10, "kernel", 2),
    _ev("sort", 85, 5, "kernel", 3),
    _ev("objective", 125, 10, "kernel", 4),
    _ev("Memcpy DtoH", 199, 1, "gpu_memcpy", 5),
    _ev("orphan", 150, 10, "gpu_memset"),
]


def test_device_ops_go_to_the_innermost_span():
    red = spans.reduce_events(EVENTS)
    dev = {k: pytest.approx(v * 1e-6) for k, v in {
        "ba.pcg": 20, "ba.plan": 15, "ba.solve": 10,
        spans.UNATTRIBUTED: 11}.items()}
    assert red["device"] == dev
    assert red["ops"]["ba.plan"] == {"gemvx": pytest.approx(10e-6),
                                     "sort": pytest.approx(5e-6)}
    assert red["ops"][spans.UNATTRIBUTED] == {
        "Memcpy DtoH": pytest.approx(1e-6), "orphan": pytest.approx(10e-6)}
    # as trace.py counts them
    tred = trace.reduce_events(EVENTS)
    assert red["window_s"] == pytest.approx(tred["window_s"])
    assert red["busy_s"] == pytest.approx(tred["busy_s"])
    assert sum(red["device"].values()) == pytest.approx(red["busy_s"])


def test_idle_goes_to_the_span_open_at_its_midpoint():
    red = spans.reduce_events(EVENTS)
    # gaps 0..15 (mid 7.5: ba.solve), 35..70 (mid 52.5: ba.solve), 80..85
    # (mid 82.5: ba.plan.tiles), 90..125 (mid 107.5: ba.solve),
    # 135..150 (ba.solve), 160..199 (mid 179.5: ba.solve)
    assert red["idle"] == {"ba.solve": pytest.approx(139e-6),
                           "ba.plan": pytest.approx(5e-6)}
    assert sum(red["idle"].values()) == pytest.approx(
        red["window_s"] - red["busy_s"])
    # before and after the solve, the host is outside every span
    out = spans.reduce_events(EVENTS + [_ev(trace.WINDOW, 0, 260,
                                            "user_annotation")])
    assert out["idle"][spans.OUTSIDE] == pytest.approx(60e-6)


def test_plan_time_and_solves():
    red = spans.reduce_events(EVENTS)
    # the outermost plan spans: tiles (30, holding by_camera) and
    # point_blocks (5)
    assert red["plan_s"] == pytest.approx(35e-6)
    assert red["solves"] == 1
    got = spans.per_solve(red, 1)
    assert got["cg_ms"] == pytest.approx(0.02)
    assert got["plan_ms"] == pytest.approx(0.035)
    assert got["lm_idle_ms"] == pytest.approx(0.139)
    # spans the trace does not hold give no metric
    assert "linearize_ms" not in got and "cg_idle_ms" not in got


def test_the_step_solver_stage_holds_the_dense_spans():
    """``cg_ms`` and ``cg_idle_ms`` sum ``ba.pcg`` and the dense step's
    spans inside it; the dense spans alone give the stage too."""
    red = {"device": {"ba.pcg": 0.002, "ba.dense.assemble": 0.03,
                      "ba.dense.factor": 0.4},
           "idle": {"ba.dense.factor": 0.001}, "plan_s": 0.0}
    got = spans.per_solve(red, 2)
    assert got == {"cg_ms": pytest.approx(216.0),
                   "cg_idle_ms": pytest.approx(0.5)}
    del red["device"]["ba.pcg"]
    assert spans.per_solve(red, 1)["cg_ms"] == pytest.approx(430.0)


def test_innermost_is_the_latest_started_open_span():
    sp = [(0, 10, "a"), (2, 5, "b"), (3, 8, "c")]
    assert spans.innermost(sp, [9, 1, 6, 4, 12, 3]) == [
        "a", "a", "c", "c", None, "c"]


def test_nothing_without_a_trace_or_spans():
    assert spans.per_solve(None, 3) == {}
    # a program without spans: every device op unattributed, every gap
    # outside, no stage metric
    bare = [e for e in EVENTS if not e["name"].startswith("ba.")]
    red = spans.reduce_events(bare)
    assert set(red["device"]) == {spans.UNATTRIBUTED}
    assert set(red["idle"]) == {spans.OUTSIDE}
    assert spans.per_solve(red, 1) == {}


def test_a_traced_solve_of_the_tiny_cell(tiny, tmp_path):
    """The spans of a solve on the CPU (no device work): its one
    ``ba.solve``, the whole window idle, charged to spans, and the host
    reads of the solve as its decisions give them."""
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
        expected_host_reads)
    from bundleadjustment_jl_tpu_torch.utils import profiling
    cell, _ = tiny
    cfg, traffic = cell.config, cell.traffic
    opts = closed_loop.solver_opts(cfg)
    problem, starts, _ = closed_loop.prepare(cfg, traffic, 5, "cpu")
    path = tmp_path / "trace.json"
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            res = closed_loop.solve(problem, starts[0], opts)
    prof.export_chrome_trace(str(path))
    red = spans.reduce_file(path)
    assert red["solves"] == 1 and red["busy_s"] == 0 and red["device"] == {}
    assert sum(red["idle"].values()) == pytest.approx(red["window_s"])
    assert set(red["idle"]) <= {"ba.solve", "ba.linearize", "ba.reduce",
                                "ba.pcg", "ba.backsub", "ba.trial",
                                spans.OUTSIDE}
    assert profiling.COUNTERS["host_reads"] == expected_host_reads(
        res.iterations, res.naccepts, res.hist_cg, opts["pcg_max_iters"])


def test_a_traced_run_keeps_spans_and_host_reads(tiny, tmp_path,
                                                 monkeypatch):
    """The closed loop's traced window on the CPU: the run keeps the spans
    of its solves, each solve's host reads equal the read formula from its
    decisions on the plain route (which builds no plans), and there is no
    allocator count off the card."""
    from bundleadjustment_jl_tpu_torch.solver import lm_jit
    results = []
    solve = lm_jit.levenberg_marquardt_jit

    def kept(*a, **kw):
        results.append(solve(*a, **kw))
        return results[-1]

    monkeypatch.setattr(lm_jit, "levenberg_marquardt_jit", kept)
    cell, _ = tiny
    opts = closed_loop.solver_opts(cell.config)
    run = closed_loop.run(cell, 11, 600.0, True, "cpu", 0.0, tmp_path,
                          warmup=False)
    n = int(cell.cell["trace_solves"])
    assert len(run["solves"]) == n == run["spans"]["solves"]
    assert run["trace"] is not None and run["alloc"] is None
    assert run["spans"]["window_s"] == pytest.approx(
        run["trace"]["window_s"])
    # no device work on the CPU: the window is one gap, charged to a span
    assert run["spans"]["busy_s"] == 0 and len(run["spans"]["idle"]) == 1
    assert set(run["spans"]["idle"]) < set(spans.STEP) | {
        "ba.solve", "ba.linearize", "ba.reduce", "ba.backsub", "ba.trial",
        spans.OUTSIDE}
    assert not list(tmp_path.glob("trace-*"))
    # the window's solves are the first n of the run's
    for s, res in zip(run["solves"], results):
        assert s["host_reads"] == lm_jit.expected_host_reads(
            res.iterations, res.naccepts, res.hist_cg,
            opts["pcg_max_iters"]) > 0
    untraced = closed_loop.run(cell, 12, 0.0, False, "cpu", 0.0, tmp_path,
                               warmup=False)
    assert untraced["spans"] is None and untraced["alloc"] is None
    assert "host_reads" in untraced["solves"][0]


def test_no_host_reads_without_the_counter(tiny, tmp_path, monkeypatch):
    """A program that keeps no host-read count: the solves carry none."""
    monkeypatch.setattr(closed_loop, "_counters", lambda: None)
    cell, _ = tiny
    run = closed_loop.run(cell, 13, 0.0, False, "cpu", 0.0, tmp_path,
                          warmup=False)
    assert all("host_reads" not in s for s in run["solves"])
