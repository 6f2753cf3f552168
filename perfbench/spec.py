"""The benchmark's description, found by name: ``BENCHMARK.json`` at the
root of the checkout names the cells, their configuration and traffic, and
the metrics; each of those is a file of its own under ``perfbench/``:

- ``configs/<config>.json`` (the entry's ``file``): the problem's sizes,
  working type, W storage and solver options;
- ``traffic/<traffic>.json``: the mix's parameters, and the driver (a
  module ``drivers/<driver>.py``) that runs it;
- ``workloads/<cell>.json``: what the cell's check of correctness compares,
  and each number's limit;
- ``metrics/<metric>.py``: the reader of one metric, end-to-end or per
  layer.

A configuration, a mix, a cell or a metric is added by adding its files and
its entry in ``BENCHMARK.json``; no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise ValueError(f"not a unit: {unit!r}")
    return unit


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def _module(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, base: Path = HERE):
    """The ``read(ctx)`` function of metric ``name``
    (``metrics/<name>.py``)."""
    path = base / "metrics" / f"{check_name(name)}.py"
    return _module(path, "perfbench_metric_" + re.sub(r"\W", "_", name)).read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(cell: str, bench_path: Path, base: Path = HERE):
    """Everything one run of cell ``cell`` needs, as a namespace: the
    ``BENCHMARK.json`` entry, the configuration, the traffic, the cell's
    own file, and the metrics it reports with ``--trace 0`` (``end_to_end``)
    and ``--trace 1`` (``per_layer``), each ``(entry, reader)``."""
    bench = _json(bench_path)
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell not in entries:
        raise KeyError(f"no workload {cell!r} in {bench_path}")
    entry = entries[check_name(cell)]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = configs[check_name(entry["config"])]["file"]
    cfg = _json(bench_path.parent / cfg_file)
    traffic = _json(base / "traffic" / f"{check_name(entry['traffic'])}.json")
    own = _json(base / "workloads" / f"{cell}.json")

    def metrics(kind):
        return [(m, load_reader(m["name"], base)) for m in bench[kind]
                if _applies(m, cell)]

    return types.SimpleNamespace(
        name=cell, chips=int(entry["chips"]), config=cfg, traffic=traffic,
        cell=own, end_to_end=metrics("end_to_end"),
        per_layer=metrics("per_layer"))


def load_driver(name: str, base: Path = HERE):
    """The module ``drivers/<name>.py`` that runs a traffic mix."""
    return _module(base / "drivers" / f"{check_name(name)}.py",
                   f"perfbench_driver_{name}")
