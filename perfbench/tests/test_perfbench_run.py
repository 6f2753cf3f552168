"""A whole run of the harness on the CPU at a tiny size (the card's check
skipped): a sound run is correct; the control and each fault the cells can
have come out not correct. And the run command refuses without a card."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import run as runner
from perfbench.drivers import closed_loop

from conftest import ROOT, add_tiny


def _measure(cell, seed=7, trace=False):
    return runner.measure(cell, seed, 0.3, trace, "cpu", time.perf_counter())


def test_sound_run_is_correct(tiny):
    cell, _ = tiny
    line = _measure(cell)
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"solve_s", "setup_s"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    assert line["window"]["alloc_calls"] is None and "stages" not in line
    assert line["window"]["solve_median_s"] <= line["window"][
        "solve_p95_s"] <= line["window"]["solve_max_s"]
    traced = _measure(cell, seed=8, trace=True)
    assert traced["correct"]
    assert list(traced)[-1] == "checks"
    # on the CPU: no device time by span and no allocator count
    assert {"lm_iters", "cg_steps", "host_reads"} <= set(traced["metrics"])
    assert not {"linearize_ms", "cg_ms", "alloc_calls"} & set(
        traced["metrics"])
    stages = traced["stages"]
    assert stages["device_ms"] == {} and len(stages["host_reads"]) == len(
        stages["decisions"]) == traced["attempted"]


def test_control_is_not_correct(tiny):
    """The control, the system's bfloat16 working type, fails the cell's
    limits (at this size as at the cells' own, PERF.md)."""
    cell, _ = tiny
    for seed in (1, 2, 3):
        out = closed_loop.run(cell, seed, 0.0, False, "cpu",
                              time.perf_counter(), ROOT / "perfbench" / "out",
                              variant="control", warmup=False)
        ok = all(out["numbers"][k] <= lim
                 for k, lim in cell.cell["limits"].items())
        assert not ok


def test_every_seed_solves_the_same_scene(tiny):
    """With the traffic's ``data_seed`` the seed draws only the order of
    the starts (and the sampled answers): every seed does the same work."""
    cell, _ = tiny
    a = closed_loop.prepare(cell.config, cell.traffic, 1, "cpu")[2]
    b = closed_loop.prepare(cell.config, cell.traffic, 2**31 + 9, "cpu")[2]
    for k in ("cam_idx", "pnt_idx", "pt2d"):
        assert torch.equal(a[k], b[k])
    for (c0, p0), (c1, p1) in zip(a["starts"], b["starts"]):
        assert torch.equal(c0, c1) and torch.equal(p0, p1)
    n = cell.traffic["starts"]
    orders = {tuple(closed_loop.start_order(s, n)) for s in range(1, 6)}
    assert len(orders) > 1
    assert all(sorted(o) == list(range(n)) for o in orders)
    # a traffic without a data_seed makes its scene from the run's seed
    traffic = {k: v for k, v in cell.traffic.items() if k != "data_seed"}
    c = closed_loop.prepare(cell.config, traffic, 2, "cpu")[2]
    assert not torch.equal(a["pt2d"], c["pt2d"])


def _zero_step(orig):
    def step(*a, **kw):
        dc, dp, jd2, it = orig(*a, **kw)
        return torch.zeros_like(dc), torch.zeros_like(dp), jd2 * 0, it
    return step


def _half_rows(orig):
    def solve(problem, *a, **kw):
        keep = (torch.arange(problem.nobs_pad) % 2 == 0).to(problem.w.dtype)
        w = problem.w * keep * 2 ** 0.5
        return orig(dataclasses.replace(problem, w=w), *a, **kw)
    return solve


def _altered_answer(orig):
    def solve(*a, **kw):
        res = orig(*a, **kw)
        return res._replace(cams=res.cams + 1e-3)
    return solve


@pytest.mark.parametrize("fault", ["step_unchanged", "half_rows",
                                   "altered_answer"])
def test_fault_is_not_correct(tiny, monkeypatch, fault):
    from bundleadjustment_jl_tpu_torch.solver import lm_jit
    if fault == "step_unchanged":
        monkeypatch.setattr(lm_jit, "solve_step",
                            _zero_step(lm_jit.solve_step))
    elif fault == "half_rows":
        monkeypatch.setattr(lm_jit, "levenberg_marquardt_jit",
                            _half_rows(lm_jit.levenberg_marquardt_jit))
    else:
        monkeypatch.setattr(lm_jit, "levenberg_marquardt_jit",
                            _altered_answer(lm_jit.levenberg_marquardt_jit))
    cell, _ = tiny
    line = _measure(cell)
    assert not line["correct"]


def _cli(cwd, workload="final13682.pcg"):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _cli(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_refuses_with_only_the_benchmark(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/, the
    run has no system to run and prints no result."""
    add_tiny(tmp_path)
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    proc = _cli(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    for line in proc.stdout.splitlines():
        json.loads(line)
