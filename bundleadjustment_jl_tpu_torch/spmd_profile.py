"""Time the spmd driver (`solver/lm_spmd.py`) against the one-shot driver,
one rank a card (or a CPU process), and count its all-reduces.

    torchrun --nproc-per-node N -m bundleadjustment_jl_tpu_torch.spmd_profile \\
        [--problems dubrovnik356 final4585] [--repeats 5] [--device cuda]

Run from the repository root. Each rank builds each problem the way the
bench leg does (``bench.make_problem``, seed 0; a ``synthetic:k=v,...``
spec takes the CLI's synthetic problem instead), shards it with
``shard_problem_kminor`` and solves it with ``bench.py``'s options: a
warm-up, then ``--repeats`` rounds of a one-shot solve of the whole problem
on rank 0 (the others wait at a barrier) and an spmd solve on every rank,
in turns (one-shot first in even rounds), each timed by the host clock
between barriers after a device synchronize. Then one more spmd solve with
every all-reduce (`ops/spmdctx.py`) counted and timed alone (a device
synchronize before and after each, so that solve is slower and is not
among the timed ones). Rank 0 prints one JSON line a problem: the ranks,
the route, both drivers' median and every seconds, their decisions, the
objective's relative gap, whether every rank's cams and points are
bit-identical (an all-gather), and the all-reduces by size with their
count, bytes and median microseconds. With ``--device cpu`` the ranks run
gloo on the CPU.
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

from bundleadjustment_jl_tpu_torch import bench
from bundleadjustment_jl_tpu_torch.ops import normal, spmdctx
from bundleadjustment_jl_tpu_torch.parallel.spmd import shard_problem_kminor
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    STATUS_NAMES, levenberg_marquardt_jit)
from bundleadjustment_jl_tpu_torch.solver.lm_spmd import (
    levenberg_marquardt_spmd)

TIMEOUT_S = 300


def make(spec: str, device: str):
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


def profile(spec: str, device: str, repeats: int, rank: int, world: int):
    problem = make(spec, device)
    route = normal.kernel_route(problem)
    sp = shard_problem_kminor(problem, world)

    def spmd():
        return levenberg_marquardt_spmd(sp, **bench.SOLVE_OPTS)

    def one_shot():
        if rank == 0:
            return levenberg_marquardt_jit(problem, **bench.SOLVE_OPTS)
        return None

    first, _ = timed(spmd, device)                   # warm-up: the shard
    timed(one_shot, device)
    one_t, spmd_t = [], []
    for i in range(repeats):
        for which in (("one", "spmd") if i % 2 == 0 else ("spmd", "one")):
            if which == "one":
                secs, one = timed(one_shot, device)
                one_t.append(secs)
            else:
                secs, res = timed(spmd, device)
                spmd_t.append(secs)
    reduces = counted_reduces(spmd, device)
    # every rank's result, bit for bit
    mine = torch.cat([res.cams.reshape(-1), res.points.reshape(-1)])
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    same = all(torch.equal(p, parts[0]) for p in parts)
    if rank != 0:
        return None
    it = res.iterations
    return {
        "problem": spec, "ranks": world, "device": device, "route": route,
        "nobs_loc": sp.nobs_loc.tolist(),
        "spmd_s": statistics.median(spmd_t), "spmd_values": spmd_t,
        "first_spmd_s": first,
        "one_shot_s": statistics.median(one_t), "one_shot_values": one_t,
        "status": STATUS_NAMES[res.status], "iterations": it,
        "cg_matvecs": int(res.hist_cg[:it].sum()),
        "objective": res.objective,
        "one_shot": [STATUS_NAMES[one.status], one.iterations,
                     int(one.hist_cg[:one.iterations].sum()),
                     one.objective],
        "rel_gap": abs(res.objective - one.objective) / one.objective,
        "ranks_bit_identical": same,
        "all_reduces": {str(n): {"count": len(us), "bytes": 4 * n * len(us),
                                 "median_us": statistics.median(us)}
                        for n, us in sorted(reduces.items())},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spmd_profile")
    p.add_argument("--problems", nargs="+",
                   default=["dubrovnik356", "final4585"])
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
        for spec in args.problems:
            line = profile(spec, args.device, args.repeats, rank, world)
            if line is not None:
                print(json.dumps({**line, "card": card}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
