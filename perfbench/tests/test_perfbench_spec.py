"""The benchmark's description: every cell, configuration and metric loads
by name, every name and unit keeps to the allowed characters, and a new
configuration, cell and metric are found from new files alone."""

from __future__ import annotations

import hashlib
import json
import re
import time
from pathlib import Path

from perfbench import run as runner
from perfbench import spec

from conftest import ROOT, add_tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"[^\t\n\r]{1,200}")


def test_every_cell_loads_by_name():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"], ROOT / "BENCHMARK.json")
        e2e = [m["name"] for m, _ in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert cell.config["name"] == w["config"]
        assert set(cell.cell["limits"]) <= set(
            __import__("perfbench.judge").judge.NUMBERS)
        for _, read in cell.end_to_end + cell.per_layer:
            assert callable(read)
        assert spec.load_driver(cell.traffic["driver"]).run


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all((ROOT / p).is_dir() for p in BENCH["paths"])
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "perfbench/")
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        names.add(spec.check_name(c["name"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert LINE.fullmatch(w["why"])
        spec.check_name(w["traffic"])
        assert (ROOT / "perfbench" / "workloads"
                / f"{w['name']}.json").is_file()
    metric_names = set()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metric_names.add(m["name"])
    assert BENCH["end_to_end"][-1]["name"] == "setup_s" or any(
        m["name"] == "setup_s" and m["bound"] <= 0.25
        for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in metric_names
        assert LINE.fullmatch(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        spec.check_name(m["name"])
        spec.check_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_names_refused():
    for bad in ("a b", "a,b", "a/b", "", ".x", "é", "x" * 65):
        try:
            spec.check_name(bad)
        except ValueError:
            continue
        raise AssertionError(bad)
    for bad in ("tokens per second", "µs", ""):
        try:
            spec.check_unit(bad)
        except ValueError:
            continue
        raise AssertionError(bad)


def _hashes(base: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(base.rglob("*")) if p.is_file()}


def test_new_config_cell_and_metric_need_no_edit(tmp_path):
    path = add_tiny(tmp_path)
    base = tmp_path / "perfbench"
    before = _hashes(base)
    # A new per-layer metric: its reader and its entry, nothing else.
    (base / "metrics" / "solves_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.run['solves']))\n")
    bench = json.loads(path.read_text())
    bench["per_layer"].append({
        "name": "solves_in_window", "unit": "solves", "better": "higher",
        "source": "program_counter", "layer": "LM driver",
        "moves": "solve_s", "workloads": ["tiny.pcg"]})
    path.write_text(json.dumps(bench))
    after = _hashes(base)
    assert {p: h for p, h in after.items() if p in before} == before
    cell = spec.load_cell("tiny.pcg", path, base)
    assert "solves_in_window" in [m["name"] for m, _ in cell.per_layer]
    line = runner.measure(cell, 3, 0.0, True, "cpu", time.perf_counter())
    assert line["metrics"]["solves_in_window"]["value"] >= 1
    assert line["correct"]


# The per-layer metrics every cell reports.
EVERY_CELL = ("linearize_ms", "reduce_ms", "cg_ms", "backsub_ms", "trial_ms",
              "plan_ms", "cg_idle_ms", "lm_idle_ms", "host_reads",
              "alloc_calls")


def test_per_layer_metrics_by_cell():
    """``kernel_roofline`` counts no dense work, so the dense cell reads
    ``dense_factor_roofline`` in its place; the stage metrics are in every
    cell."""
    got = {w["name"]: {m["name"] for m, _ in spec.load_cell(
        w["name"], ROOT / "BENCHMARK.json").per_layer}
        for w in BENCH["workloads"]}
    assert "kernel_roofline" in got["final13682.pcg"]
    assert "kernel_roofline" not in got["venice1778.dense"]
    assert "dense_factor_roofline" in got["venice1778.dense"]
    assert "dense_factor_roofline" not in got["final13682.pcg"]
    for names in got.values():
        assert set(EVERY_CELL) <= names
