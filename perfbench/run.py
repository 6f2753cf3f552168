#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``bundleadjustment_jl_tpu_torch``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. The cell, its configuration, its traffic and its metrics are
found by name from ``BENCHMARK.json`` (`perfbench/spec.py`); the traffic's
driver (`perfbench/drivers/`) makes the problem from the seed, warms up,
runs the window and holds a sample of its answers against the plain
reference. With ``--trace 0`` the result line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device's
busy and window seconds, and a breakdown of the trace.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``card`` (the card's name and power limit), ``window``
(one solve's median, 95th-percentile and largest seconds, and the
allocator's device calls over the window), with ``--trace 1`` ``stages``
(device and idle ms a solve by span, and each traced solve's host reads and
decisions), the ``readings`` of every number the check computes, and last
``checks``: each compared number with its limit, which are also the last
lines of standard error. Without a card, with fewer cards than the cell
asks for, or when the system or a module of JAX cannot be kept out of the
process, the run exits with a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = HERE / "out"
# Top-level module names that may not be loaded in the process that prints
# the result: JAX, its libraries, and the JAX package the port came from.
FORBIDDEN = ("jax", "jaxlib", "flax", "bundleadjustment_jl_tpu")
# Statuses of a solve that reached a solution (`reference.STATUS`).
CONVERGED = (1, 2, 3, 4)


def forbidden_modules() -> list:
    """The :data:`FORBIDDEN` names loaded, by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _num(v: float) -> float:
    return v if math.isfinite(v) else 1e308


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def window_summary(run: dict) -> dict:
    """The window's solves at a glance: one solve's median, 95th-percentile
    and largest seconds, and the allocator's device calls and retries over
    the window (None off the card)."""
    secs = sorted(s["seconds"] for s in run["solves"])
    alloc = run.get("alloc") or {}
    return {"solve_median_s": statistics.median(secs),
            "solve_p95_s": secs[math.ceil(0.95 * len(secs)) - 1],
            "solve_max_s": secs[-1],
            "alloc_calls": alloc.get("device_calls"),
            "alloc_retries": alloc.get("retries")}


def stage_table(run: dict) -> dict:
    """The traced window by span (`perfbench/spans.py`), ms a solve: device
    time and idle time, with each traced solve's host reads and decisions
    ``[iterations, naccepts, cg]``."""
    red, n = run["spans"], len(run["solves"])
    return {"device_ms": {k: 1e3 * v / n for k, v in red["device"].items()},
            "idle_ms": {k: 1e3 * v / n for k, v in red["idle"].items()},
            "host_reads": [s.get("host_reads") for s in run["solves"]],
            "decisions": [[s["iterations"], s["naccepts"], s["cg"]]
                          for s in run["solves"]]}


def measure(cell, seed: int, seconds: float, trace: bool, device: str,
            t0: float) -> dict:
    """Run ``cell`` once on ``device`` and return its result line (a dict,
    ``checks`` last), without the card's description."""
    import torch

    from perfbench import judge, spec
    from perfbench.trace import breakdown
    driver = spec.load_driver(cell.traffic["driver"])
    run = driver.run(cell, seed, seconds, trace, device, t0, OUT)
    facto = cell.config.get("facto_dtype")
    ctx = types.SimpleNamespace(
        cfg=cell.config, run=run,
        w_itemsize=4 if facto is None else getattr(torch, facto).itemsize)
    metrics = {}
    for m, read in (cell.per_layer if trace else cell.end_to_end):
        value = read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok, checks = judge.verdict(run["numbers"], cell.cell["limits"])
    failed = sum(s["status"] not in CONVERGED for s in run["solves"])
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else device, "count": cell.chips,
           "memory_peak_bytes": run["peak_bytes"]}
    line = {"correct": bool(ok and failed == 0),
            "attempted": len(run["solves"]), "failed": failed,
            "metrics": metrics, "device": dev}
    if trace and run["trace"]:
        dev.update(busy_s=run["trace"]["busy_s"],
                   window_s=run["trace"]["window_s"])
        line["breakdown"] = breakdown(run["trace"])
    line["solves"] = {"count": len(run["solves"]), "sample": run["sample"],
                      "window_s": run["window_s"],
                      "reference_s": run["reference_s"],
                      "setup_phases": run["setup_phases"],
                      "decisions": run["pairs"]}
    line["window"] = window_summary(run)
    if trace and run.get("spans"):
        line["stages"] = stage_table(run)
    line["readings"] = {k: _num(v) for k, v in run["numbers"].items()}
    line["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    return line


def emit(line: dict) -> None:
    solves = line.pop("solves")
    n = solves["count"]
    print(f"solves {n} in {solves['window_s']!r} s; sampled "
          f"{solves['sample']}; reference {solves['reference_s']!r} s",
          file=sys.stderr)
    print(f"setup phases {json.dumps(solves['setup_phases'])}",
          file=sys.stderr)
    for pair in solves["decisions"]:
        print(f"decisions {json.dumps(pair)}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # Any Triton cache of the program stays in the checkout, at one path.
    os.environ.setdefault("TRITON_CACHE_DIR", str(OUT / "triton"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from perfbench import spec
    cell = spec.load_cell(args.workload, ROOT / "BENCHMARK.json")
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card (torch.cuda.is_available() is "
              "false); the benchmark does not run on the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T0)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded that the run must not load: "
              f"{bad}", file=sys.stderr)
        return 3
    line = {"card": card_line(), **line}
    line = {k: line[k] for k in (*[k for k in line if k != "checks"],
                                 "checks")}
    emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
