"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
with one more configuration and cell, ``tiny``, small enough for the CPU
(the port runs its plain route there). ``tiny`` stores W in float32: with
W in bfloat16 a problem of 300 points stops 2 to 15 iterations away from
the reference (CG's floor of 8 eps of bfloat16 leaves each step loose, and
the stop on the objective's change lands anywhere along a flat valley),
where at Final-13682's size the two agree (PERF.md section 2)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(name="tiny", ncams=12, npnts=300, nobs=1200, pad_obs_to=128,
            facto_dtype=None)


def add_tiny(root: Path, **over) -> Path:
    """Copy ``perfbench/`` and ``BENCHMARK.json`` under ``root`` and add the
    configuration and cell ``tiny.pcg`` (Final-13682's, at the sizes of
    :data:`TINY` and ``over``) as new files and entries; return the
    copy's ``BENCHMARK.json``."""
    base = root / "perfbench"
    shutil.copytree(ROOT / "perfbench", base,
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    cfg = json.loads((base / "configs" / "final13682.json").read_text())
    cfg.update(TINY, **over)
    (base / "configs" / "tiny.json").write_text(json.dumps(cfg))
    own = json.loads((base / "workloads" /
                      "final13682.pcg.json").read_text())
    own.update(sample=2, sample_within=2, trace_solves=2)
    (base / "workloads" / "tiny.pcg.json").write_text(json.dumps(own))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny.pcg", "config": "tiny",
                               "traffic": "solve_stream", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.pcg")
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny(tmp_path):
    """``(cell namespace, BENCHMARK.json path)`` of the tiny cell."""
    from perfbench import spec
    path = add_tiny(tmp_path)
    return spec.load_cell("tiny.pcg", path, tmp_path / "perfbench"), path
