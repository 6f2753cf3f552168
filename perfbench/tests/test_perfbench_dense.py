"""The dense cell's harness on the CPU at a tiny size: the driver
``closed_loop_dense`` checks with the configuration's own reference
(`perfbench/reference_dense.py`), keeps the traced window's spans, and a
sound run is correct; the control, the bfloat16 working type, is not."""

from __future__ import annotations

import json
import time

from perfbench import run as runner
from perfbench import spec

from conftest import ROOT, add_tiny

# In float64: a float32 dense step at this size follows rounding near
# convergence (S's condition passes 1e7 at small lambda; the gauge's seven
# directions), and the tests hold the harness, not the step.
TINY_DENSE = dict(name="tiny_dense", ncams=10, npnts=300, nobs=1200,
                  pad_obs_to=128, dtype="float64")


def add_tiny_dense(root):
    """The tiny cell's copy of the benchmark plus ``tiny.dense``:
    venice1778_dense's configuration at :data:`TINY_DENSE`'s sizes and
    working type, on the dense traffic, with venice1778.dense's limits."""
    path = add_tiny(root)
    base = root / "perfbench"
    cfg = json.loads((base / "configs" / "venice1778_dense.json").read_text())
    cfg.update(TINY_DENSE)
    (base / "configs" / "tiny_dense.json").write_text(json.dumps(cfg))
    own = json.loads((base / "workloads" /
                      "venice1778.dense.json").read_text())
    own.update(sample=2, sample_within=2, trace_solves=2)
    (base / "workloads" / "tiny.dense.json").write_text(json.dumps(own))
    bench = json.loads(path.read_text())
    bench["configs"].append({"name": "tiny_dense", "source": "tests",
                             "file": "perfbench/configs/tiny_dense.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny.dense", "config": "tiny_dense",
                               "traffic": "solve_stream_dense", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["per_layer"]:
        if "venice1778.dense" in m.get("workloads", []):
            m["workloads"].append("tiny.dense")
    path.write_text(json.dumps(bench))
    return spec.load_cell("tiny.dense", path, base)


def test_dense_cell_checks_with_its_reference(tmp_path, monkeypatch):
    cell = add_tiny_dense(tmp_path)
    driver = spec.load_driver(cell.traffic["driver"])
    assert driver.reference_class(cell.config).__module__ == (
        "perfbench_reference_reference_dense")
    line = runner.measure(cell, 5, 0.3, False, "cpu", time.perf_counter())
    assert line["correct"] and line["failed"] == 0
    assert all(d["sut"]["cg"] == 0 == d["ref"]["cg"]
               for d in line["solves"]["decisions"])
    traced = driver.run(cell, 6, 0.0, True, "cpu", time.perf_counter(),
                        tmp_path / "out")
    assert set(traced["spans"]) >= {"device", "idle", "window_s"}
    assert traced["trace"] is not None


def test_dense_control_is_not_correct(tmp_path):
    cell = add_tiny_dense(tmp_path)
    driver = spec.load_driver(cell.traffic["driver"])
    for seed in (1, 2):
        out = driver.run(cell, seed, 0.0, False, "cpu", time.perf_counter(),
                         ROOT / "perfbench" / "out", variant="control",
                         warmup=False)
        assert not all(out["numbers"][k] <= lim
                       for k, lim in cell.cell["limits"].items())
