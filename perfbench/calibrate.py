#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the check's numbers on
many seeds, for the system as the configuration states it (``sut``) and
for its control (``control``: the system's bfloat16 working type), in one
process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--variant sut|control]

Each seed is one set-up and one solve through the cell's driver (the
first start of the seed's order), held against the reference exactly as a
run's sample is; the window is one solve long. One JSON line a seed: the numbers, the solve's decisions and
seconds, the set-up's seconds and the peak memory. A seed whose solve
raises prints its error instead, and the next seed runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant", default="sut", choices=("sut", "control"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT / "BENCHMARK.json")
    driver = spec.load_driver(cell.traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        try:
            run = driver.run(cell, seed, 0.0, False, "cuda", t0,
                             HERE / "out", variant=args.variant,
                             warmup=False)
        except Exception:  # a control may fail; the next seed still runs
            print(json.dumps({"seed": seed, "variant": args.variant,
                              "error": traceback.format_exc()[-2000:]}),
                  flush=True)
            continue
        s = run["solves"][0]
        print(json.dumps({
            "seed": seed, "variant": args.variant, "numbers": run["numbers"],
            "decisions": run["pairs"], "reference_s": run["reference_s"],
            "iterations": s["iterations"], "cg": s["cg"],
            "status": s["status"], "solve_s": s["seconds"],
            "setup_s": run["setup_s"], "peak_gib": run["peak_bytes"] / 2**30,
            "total_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
