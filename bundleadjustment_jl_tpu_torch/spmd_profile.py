"""Time the multi-rank solves, one rank a card (or a CPU process), against
the one-shot driver on one card, and count their all-reduces.

    torchrun --nproc-per-node N -m bundleadjustment_jl_tpu_torch.spmd_profile \\
        [--problems dubrovnik356@spmd,pcg,groups-pcg,cgls,dense \\
                    final4585@spmd,pcg,groups-pcg] \\
        [--repeats 5] [--device cuda]

Run from the repository root. Each ``--problems`` entry is a problem and,
after ``@``, its drivers: ``spmd`` is the spmd driver
(`solver/lm_spmd.py` on ``shard_problem_kminor``), and a step solver
(``pcg``, ``power``, ``dense``, ``cgls``) is the mesh path
(`parallel/mesh.py`: ``shard_problem`` of ``make_mesh(N)``) through
``levenberg_marquardt_jit`` with that step; ``groups-<step>`` is the same
on the camera groups of ``partition_problem(problem, N)`` (the plain
route, every point on every rank, the point sums all-reduced too; the
line's ``layout`` is ``cameras``, else ``points``). Each rank builds each
problem
by ``bench.make_problem`` (seed 0; a name of
``capacity.CAPACITY``, ``final13682`` say, the capacity run's problem, on
either device; a ``synthetic:k=v,...`` spec the CLI's synthetic problem) and
solves it with ``bench.py``'s options: for each driver a warm-up, then
``--repeats`` rounds of a one-shot solve of the whole problem with the
same step on rank 0 (the others wait at a barrier) and the multi-rank
solve on every rank, in turns (one-shot first in even rounds), each timed
by the host clock between barriers after a device synchronize. Then one
more multi-rank solve with every all-reduce (`ops/spmdctx.py`) counted
and timed alone (a device synchronize before and after each, so that
solve is slower and is not among the timed ones), its peak device memory
on each rank read around it (``torch.cuda.max_memory_allocated``; the
one-shot's around its warm-up on rank 0). Rank 0 prints one JSON line a
problem and driver: the ranks, the route, both solves' median and every
seconds, their decisions, the objective's relative gap, whether every
rank's cams and points are bit-identical (an all-gather), the peak
memory, and the all-reduces by size with their count, bytes and median
microseconds. With ``--device cpu`` the ranks run gloo on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from datetime import timedelta

import torch
import torch.distributed as dist

from bundleadjustment_jl_tpu_torch import bench, capacity
from bundleadjustment_jl_tpu_torch.ops import normal, spmdctx
from bundleadjustment_jl_tpu_torch.parallel.mesh import (
    make_mesh, shard_problem)
from bundleadjustment_jl_tpu_torch.parallel.partition import (
    partition_problem)
from bundleadjustment_jl_tpu_torch.parallel.spmd import shard_problem_kminor
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    SOLVERS, STATUS_NAMES, levenberg_marquardt_jit)
from bundleadjustment_jl_tpu_torch.solver.lm_spmd import (
    levenberg_marquardt_spmd)

PROBLEMS = ["dubrovnik356@spmd,pcg,groups-pcg,cgls,dense",
            "final4585@spmd,pcg,groups-pcg"]
# The drivers of a camera-group mesh: "groups-" and a step solver.
GROUPS = "groups-"
TIMEOUT_S = 300


def make(spec: str, device: str):
    if spec in capacity.CAPACITY:
        return capacity.make(capacity.CAPACITY[spec].problem, device)[0]
    if spec.startswith("synthetic"):
        from bundleadjustment_jl_tpu_torch.cli import _parse_synthetic
        from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
        return synthetic_bal(dtype=torch.float32, device=device,
                             **_parse_synthetic(spec))[0]
    if device != "cuda":
        raise ValueError(f"{spec}: bench.py's problems are built on the "
                         f"card; give a synthetic: spec for the CPU")
    return bench.make_problem(spec, 0)


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()
    dist.barrier()


def timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def counted_reduces(fn, device):
    """``fn()`` with every all-reduce of `ops/spmdctx.py` timed alone
    (device synchronized before and after): {numel: [microseconds]}."""
    seen = defaultdict(list)
    inner = spmdctx._reduce

    def reduce(x, op):
        if spmdctx.GROUP is None:
            return inner(x, op)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(x, op)
        if device == "cuda":
            torch.cuda.synchronize()
        seen[x.numel()].append(1e6 * (time.perf_counter() - t0))
        return out
    spmdctx._reduce = reduce
    try:
        fn()
    finally:
        spmdctx._reduce = inner
    return seen


def peak_gb(fn, device) -> float:
    """``fn()``'s peak device memory in GB (NaN off the card)."""
    if device != "cuda":
        fn()
        return float("nan")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def solve(problem, solver: str):
    """One ``levenberg_marquardt_jit`` solve of ``problem`` (a problem or a
    mesh shard) with bench.py's options and ``solver`` steps."""
    use = {} if solver == "pcg" else {f"use_{solver}": True}
    return levenberg_marquardt_jit(problem, **bench.SOLVE_OPTS, **use)


def profile(problem, route: str, driver: str, multi, device: str,
            repeats: int, rank: int, world: int):
    """The JSON line of one driver (module docstring) on ``problem``;
    ``multi()`` is its multi-rank solve. None on the ranks but 0."""
    solver = "pcg" if driver == "spmd" else driver.removeprefix(GROUPS)

    def one_shot():
        if rank == 0:
            return solve(problem, solver)
        return None

    first, _ = timed(multi, device)                  # warm-up: the shard
    one_peak = peak_gb(one_shot, device)             # warm-up
    dist.barrier()
    one_t, multi_t = [], []
    for i in range(repeats):
        for which in (("one", "multi") if i % 2 == 0 else ("multi", "one")):
            if which == "one":
                secs, one = timed(one_shot, device)
                one_t.append(secs)
            else:
                secs, res = timed(multi, device)
                multi_t.append(secs)
    box = {}
    peak = peak_gb(lambda: box.update(
        reduces=counted_reduces(multi, device)), device)
    peaks = [None] * world
    dist.all_gather_object(peaks, peak)
    # every rank's result, bit for bit
    mine = torch.cat([res.cams.reshape(-1), res.points.reshape(-1)])
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    same = all(torch.equal(p, parts[0]) for p in parts)
    if rank != 0:
        return None
    it = res.iterations
    return {
        "problem": problem.name, "driver": driver, "solver": solver,
        "layout": "cameras" if driver.startswith(GROUPS) else "points",
        "ranks": world, "device": device, "route": route,
        "multi_s": statistics.median(multi_t), "multi_values": multi_t,
        "first_multi_s": first,
        "one_shot_s": statistics.median(one_t), "one_shot_values": one_t,
        "status": STATUS_NAMES[res.status], "iterations": it,
        "cg_matvecs": int(res.hist_cg[:it].sum()),
        "objective": res.objective,
        "one_shot": [STATUS_NAMES[one.status], one.iterations,
                     int(one.hist_cg[:one.iterations].sum()),
                     one.objective],
        "rel_gap": abs(res.objective - one.objective) / one.objective,
        "ranks_bit_identical": same,
        "peak_gb_by_rank": peaks, "one_shot_peak_gb": one_peak,
        "all_reduces": {str(n): {"count": len(us), "bytes": 4 * n * len(us),
                                 "median_us": statistics.median(us)}
                        for n, us in sorted(box["reduces"].items())},
    }


def run(entry: str, mesh, device: str, repeats: int, rank: int,
        world: int):
    """Profile each driver of ``entry`` (``problem@driver,...``); yields
    rank 0's lines."""
    spec, _, names = entry.partition("@")
    drivers = names.split(",") if names else ["spmd"]
    unknown = set(drivers) - {"spmd", *SOLVERS,
                              *(GROUPS + s for s in SOLVERS)}
    if unknown:
        raise ValueError(f"{entry}: unknown drivers {sorted(unknown)}; "
                         f"spmd or a step solver of {SOLVERS}, alone or "
                         f"after {GROUPS!r}")
    problem = make(spec, device)
    route = normal.kernel_route(problem)
    sp = shard_problem_kminor(problem, world) if "spmd" in drivers else None
    shard = (shard_problem(problem, mesh)
             if set(drivers) & set(SOLVERS) else None)
    groups = (shard_problem(partition_problem(problem, world)[0], mesh)
              if any(d.startswith(GROUPS) for d in drivers) else None)
    for driver in drivers:
        if driver == "spmd":
            def multi():
                return levenberg_marquardt_spmd(sp, **bench.SOLVE_OPTS)
        elif driver.startswith(GROUPS):
            def multi(solver=driver.removeprefix(GROUPS)):
                return solve(groups, solver)
        else:
            def multi(solver=driver):
                return solve(shard, solver)
        line = profile(problem, route, driver, multi, device, repeats,
                       rank, world)
        if line is not None:
            yield {**line, "problem": spec}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spmd_profile")
    p.add_argument("--problems", nargs="+", default=PROBLEMS,
                   help="problem@driver,... (module docstring)")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("spmd_profile: no CUDA device (--device cpu "
                               "runs gloo on the CPU)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        card = bench.card()["nvidia_smi"] if args.device == "cuda" else None
        mesh = make_mesh(world, args.device)
        for entry in args.problems:
            for line in run(entry, mesh, args.device, args.repeats, rank,
                            world):
                print(json.dumps({**line, "card": card}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
