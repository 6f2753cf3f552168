"""Smoke run of the PyTorch port (`bundleadjustment_jl_tpu_torch`) on one
CUDA card.

    python3 chip_smoke.py

1. Prints the torch / CUDA versions and the card (``nvidia-smi``), builds
   the nine CUDA kernels from ``bundleadjustment_jl_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and prints the build time and the
   compiler's register report.
2. Builds each launch plan (``ops/plans.py``: K2's tiles, K5's point
   ranges, K5's and K6's column ranges, K8's camera-order rows) once more
   from scratch and prints its build time, then checks each kernel
   against its plain PyTorch version on the card, at the shapes of
   synthetic LadyBug-49 and Dubrovnik-356 (as ``bench.py`` builds them),
   and times both in turns (plain, kernel, kernel, plain): K1-K4 of the
   fused camera-scatter route (K4 at 1, 3, 5 and 9 trial states, timed at
   1 and 5, each beside its bound), K7, K6 and K5 of the camera-sorted
   route, then K2's other three products and K8 of the Final-scale routes
   (and K8 against K7's W in camera order). The forms that read through a
   plan, and K4 (REPEAT_CHECKED), launch twice and must give bit-identical
   outputs. K1's point pass and camera pass, and K4's row blocks and
   sums, are timed apart (``torch.profiler``, by kernel:
   ``kernel_profile.device_ms``). Then phase 6 for the problem.
3. Solves both problems with ``levenberg_marquardt_jit`` and
   ``bench.py``'s options (``bench.SOLVE_OPTS`` of the port) on each
   kernel route (``normal.CAM_SCATTER``
   True, then False): a warm-up, five timed solves (launch counts reset
   before each and checked against its iterations, accepts and CG steps
   after it, and the W kernels' launches by W's storage dtype against
   them), and a solve on the plain route (``normal.PALLAS_MODE`` off, the
   solver's own plain-route decision: no kernel launched). Checks that the
   kernel and plain routes agree, that the two kernel routes agree, and
   that the rmse lands on the data-fixed anchors. Then Dubrovnik-356 in
   float64, as the default constructor builds it (on the card): a warm-up
   and a timed solve, which take the plain route by the solver's decision
   (no kernel launched), its rmse on the anchor, and its objective's
   relative gap to route A's float32 solve.
4. Builds synthetic Final-4585 (the BAL Final problem
   ``problem-4585-1324582-9125125``'s sizes) once, runs phase 2 on it
   (every kernel but K9, timed there too) and phase 6's Final form, and
   solves it with the default gates on
   route B1 (camera scatter on: more than ``GATHER_TABLE_MAX_CAMS``
   cameras) and route B2 (camera scatter off: more rows than
   ``GATHER_DIRECT_MAX_BYTES`` allows): a warm-up, three timed solves and
   a plain-route solve each, checked as in 3 against the rmse the data
   fixes (0.8851 px); B1 and B2 must agree. Then, on route B1, the
   one-pass Schur pieces against their two-pass forms (the only launches
   of K2's W C W' product, which no solve makes; counted apart).
5. The streaming-read probe (K9) against its plain version and against
   ``torch.sum`` (the one-call yardstick, ``library_ms``), at Dubrovnik-356's
   and Final-4585's row counts with 0, 1 and 2 small rows, each rate beside
   the H100's published 3.35 TB/s.
6. Every kernel that reads or writes W with W stored in bfloat16 and in
   float16 (``facto_dtype``), against its plain version at LadyBug-49 and
   Dubrovnik-356 shapes (all but K7 at Final-4585's too), timed in
   turns: the
   readers to the tolerances of phase 2 (both sides widen the same stored
   W), the writers' W to those tolerances plus one ulp of the storage
   dtype (two float32 W within tolerance may round to neighbours), with at
   most STORE_MISMATCH_MAX of the entries not bit-equal (a store that
   rounds another way than to nearest changes about half).
7. ``facto_dtype`` solves: Dubrovnik-356 with bfloat16 and float16 W on
   routes A and C (a warm-up and five timed solves, launches checked as in
   3, W's storage dtype checked as in 3, rmse anchored as in 3; each
   route makes the JAX package's decisions recorded in ``BENCH_r05.json``:
   its status, iterations within one), then Final-4585 with bfloat16 W on
   B1 and B2 (three timed solves each, no plain-route solve, for the time
   limit; the two routes agree on status and on iterations within one).
8. The drivers and step solvers (``check_chunked``, ``check_solvers``):
   at Dubrovnik-356 on route A, ``levenberg_marquardt_jit_chunked`` with
   ``chunk_iters=3`` bit-identical to the one-shot solve (and its
   launches checked), a run stopped after one chunk with a checkpoint and
   resumed bit-identical to it, ``max_time=0`` stopping with status
   ``max_time``; then each case of SOLVER_CASES — the host-stepped driver
   (``levenberg_marquardt``) with PCG on routes A and C, held to phase
   3's one-shot decisions (``host_status``); the power series (routes A
   and C), CGLS and dense steps through both drivers, dense at LadyBug-49
   too — a warm-up and three timed solves (dense at Dubrovnik-356: one),
   launches checked as in 3, a solved status and the rmse on the anchor;
   the median seconds printed beside the card.
9. The precision cascade and the surface (``check_cascade`` and after):
   ``precision_cascade`` with stages ``("bfloat16", "float32")`` at
   Dubrovnik-356 on routes A and C (a warm-up, three timed cascades, one
   on the plain route): each stage's launches checked against its record
   (the bfloat16 stage runs the route's kernels with W in bfloat16), the
   bfloat16 stage within the CASCADE_ITERS / CASCADE_REL bar of the plain
   route's decisions, the float32 stage within ``agree`` and on the rmse
   anchor; the cascade with a float64 stage once (that stage on the plain
   route, no launch); ``facto_solve`` with bfloat16 and float16 W (half
   the W bytes, phase 7's decisions); the float64 anchor record (the
   float32 solve's objective gap to a float64 solve at LadyBug-49,
   Dubrovnik-356 and Final-4585); the native BAL parser built into the
   package's ``_build/`` and held to the numpy reader on the fixture; the
   CLI as processes (the fixture with ``--save``, LadyBug-49 in bfloat16
   and through the host driver); the campaign runner over the synthetic
   suite up to 50,000 observations and its Markdown table.
10. The bench leg (``python -m bundleadjustment_jl_tpu_torch.bench``): its
   JSON line, once, with the launches of its run checked (route A's
   kernels and the probe).
11. Prints the run's wall time, the kernel table as one JSON line (each
   kernel's time beside its least time on the card, ``bench.bound_ms``,
   from this run's shapes, at each problem; the plans' build times and
   the repeat checks under their kernels), the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero before the last
line. It needs a CUDA card and the repository checkout beside it; it
imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "bundleadjustment_jl_tpu_torch"

# bench.py's problems (`bench.PROBLEMS`, synthetic, seed 0, f32), then
# Final-4585, and the solver-level anchors the data fixes: rmse at the
# solution. LadyBug-49 and Dubrovnik-356: BENCH_r05.json's solver outputs;
# Final-4585: the expected fitted rmse under unit pixel noise,
# sqrt(1 - (9 ncams + 3 npnts) / (2 nobs)) (it gives 0.8653 and 0.7861 for
# the other two).
PROBLEMS = ("ladybug49", "dubrovnik356")
FINAL = "final4585"
RMSE = {"ladybug49": 0.7849, "dubrovnik356": 0.8648, "final4585": 0.8851}
REPEATS = 5          # timed kernel-route solves per problem; median kept
FINAL_REPEATS = 3    # at Final-4585, for the run's time limit
# The JAX package's decisions with W stored narrow at Dubrovnik-356
# (BENCH_r05.json, bench.py's bf16facto_* / f16facto_* keys): status and
# iterations, which the port's narrow solves must make.
FACTO_RECORD = {"bfloat16": ("small_obj_change", 9),
                "float16": ("first_order", 9)}
# Cycles the card spins a timed call before a window of ``time_pair``
# (~0.5 ms at the H100's 1.98 GHz): time for the host to enqueue the call.
SPIN_CYCLES = 1_000_000
# Kernel vs plain, |kernel - plain| <= rtol |plain| + afrac max|plain|:
# summation order differs (blocks, FMA contraction), nothing else.
TOL = {"W": (1e-5, 1e-6), "hp12": (1e-4, 1e-3), "hc90": (1e-4, 1e-3),
       "obj": (1e-5, 0.0), "cam_reduce": (1e-4, 1e-4),
       "matvec": (1e-4, 1e-4), "objective": (1e-5, 0.0),
       "linearize": (1e-5, 1e-6), "seg_prod_pnt12": (1e-4, 1e-3),
       "seg_prod_cam90": (1e-4, 1e-3), "seg_prod_wcw81": (1e-4, 1e-4),
       "seg_block_point": (1e-4, 1e-4), "seg_block_camera": (1e-4, 1e-4),
       "cam_reduce_w_op": (1e-4, 1e-4), "cam_reduce_wcw81": (1e-4, 1e-4),
       "cam_reduce_cam90": (1e-4, 1e-3), "linearize_w_only": (1e-5, 1e-6),
       "schur": (1e-4, 1e-4),
       # sums of (32 + nsmall) rows of n uniform [0, 1) values, f32 partial
       # sums in another order
       "stream_probe": (1e-5, 0.0)}
# name: (source, TPU kernel it replaces, its launch counters, the
# comparisons whose largest error the table reports)
KERNELS = {
    "assemble": ("csrc/assemble.cu",
                 "bundleadjustment_jl_tpu/ops/pallas_assemble.py:284",
                 ["assemble"], ["W"]),
    "cam_reduce": ("csrc/cam_reduce.cu",
                   "bundleadjustment_jl_tpu/ops/pallas_schur.py:1109",
                   ["cam_reduce", "cam_reduce_w_op", "cam_reduce_wcw81",
                    "cam_reduce_cam90"],
                   ["cam_reduce", "cam_reduce_w_op", "cam_reduce_wcw81",
                    "cam_reduce_cam90"]),
    "matvec": ("csrc/matvec.cu",
               "bundleadjustment_jl_tpu/ops/pallas_schur.py:1550",
               ["matvec"], ["matvec"]),
    "objective": ("csrc/objective.cu",
                  "bundleadjustment_jl_tpu/ops/pallas_assemble.py:484",
                  ["objective"], ["objective"]),
    "linearize": ("csrc/linearize.cu",
                  "bundleadjustment_jl_tpu/ops/pallas_linearize.py:314",
                  ["linearize"], ["linearize"]),
    "linearize_w_only": ("csrc/linearize.cu",
                         "bundleadjustment_jl_tpu/ops/pallas_linearize.py:258",
                         ["linearize_w_only"], ["linearize_w_only"]),
    "seg_prod_reduce": ("csrc/seg_prod_reduce.cu",
                        "bundleadjustment_jl_tpu/ops/pallas_schur.py:969",
                        ["seg_prod_pnt12", "seg_prod_cam90",
                         "seg_prod_wcw81"],
                        ["seg_prod_pnt12", "seg_prod_cam90",
                         "seg_prod_wcw81"]),
    "seg_block_reduce": ("csrc/seg_block_reduce.cu",
                         "bundleadjustment_jl_tpu/ops/pallas_schur.py:647",
                         ["seg_block_point", "seg_block_camera"],
                         ["seg_block_point", "seg_block_camera"]),
    "stream_probe": ("csrc/stream_probe.cu", "scripts/tpu_mv_sweep.py:120",
                     ["stream_probe"], ["stream_probe"]),
}
# The forms that read their rows through a launch plan (`ops/plans.py`:
# K2's four, K5's both directions, K3 = K5 point + K2 W op, K1's point
# pass and K6's point product = K5's point walk, K6's W C W', K8) and K4's
# fixed row blocks: a second launch must give bit-identical output
# (fixed-order sums, no atomics).
REPEAT_CHECKED = ("cam_reduce", "cam_reduce_w_op", "cam_reduce_wcw81",
                  "cam_reduce_cam90", "seg_block_point", "matvec",
                  "assemble", "seg_block_camera", "seg_prod_wcw81",
                  "linearize_w_only", "seg_prod_pnt12", "objective")
# K4's trial states checked against its plain version (1: a solve without
# the line search; 5 = 1 + ls_max: with it; 3 and 9: other counts) and
# those timed.
OBJECTIVE_SCALES = (1, 3, 5, 9)
OBJECTIVE_TIMED = (1, 5)
# counter -> its row of the kernel table
KERNEL_OF = {c: k for k, (_, _, counters, _) in KERNELS.items()
             for c in counters}
# Storage dtypes of W checked and timed beside float32 (2 bytes a value).
NARROW = ("bfloat16", "float16")
# A writer's stored W against its plain version's: the largest share of
# entries that may differ at all. The two float32 W differ in their last
# bits (FMA contraction) before the store rounds them, so a few round to
# the neighbour: on an H100 at Dubrovnik-356, 4.5e-5 of the entries in
# bfloat16 and 3.0e-4 in float16 (8x finer). A store that rounds toward
# zero instead of to nearest changes about half.
STORE_MISMATCH_MAX = 1e-3
# Counters no solve launches: K2's W C W' serves `schur_diag_blocks` on
# blocks without a camera-sorted W, which no solve calls (route B1's
# diagonal comes from K2's W C W' | W t, as in the JAX driver). Only the
# Schur check of phase 4 launches it; its count is kept apart from the
# solves'.
SCHUR_CHECK_ONLY = ("cam_reduce_wcw81",)
ROUTES = {True: "fused", False: "sorted"}   # normal.CAM_SCATTER -> name
# Phase 8: the chunked driver's chunk, and the step solvers and drivers
# solved: (problem, solver, driver, normal.CAM_SCATTER values, timed solves).
# Each is warmed up once and timed DRIVER_REPEATS times, but dense at
# Dubrovnik-356 (~14 TFLOP of float32 product an iteration) once, its path
# warmed by the LadyBug-49 dense solves.
CHUNK_ITERS = 3
DRIVER_REPEATS = 3
SOLVER_CASES = (
    ("ladybug49", "dense", "jit", (True,), DRIVER_REPEATS),
    ("ladybug49", "dense", "host", (True,), DRIVER_REPEATS),
    ("dubrovnik356", "pcg", "host", (True, False), DRIVER_REPEATS),
    ("dubrovnik356", "power", "jit", (True, False), DRIVER_REPEATS),
    ("dubrovnik356", "power", "host", (True,), DRIVER_REPEATS),
    ("dubrovnik356", "cgls", "jit", (True,), DRIVER_REPEATS),
    ("dubrovnik356", "cgls", "host", (True,), DRIVER_REPEATS),
    ("dubrovnik356", "dense", "jit", (True,), 1),
    ("dubrovnik356", "dense", "host", (True,), 1),
)
# Phase 9: the precision cascade's stages, timed solves of each (after a
# warm-up; the median kept), and the bar a bfloat16 stage of the kernel
# route is held to against the plain route's: the JAX package's own spread
# between its two XLA precision settings (status, iterations within
# CASCADE_ITERS, objective within CASCADE_REL).
CASCADE = ("bfloat16", "float32")
POLISH = ("bfloat16", "float32", "float64")
CASCADE_REPEATS = 3
CASCADE_ITERS, CASCADE_REL = 2, 0.05
# The CLI's --json keys (the JAX CLI's), the parser's fixture and the
# LadyBug-49 problem as the CLI's synthetic: spec builds it.
CLI_KEYS = {"problem", "status", "objective", "rmse_px", "iterations",
            "elapsed_s", "dual_feas", "solver", "driver", "dtype", "backend"}
FIXTURE = "tests/fixtures/problem-24-800-pre.txt.bz2"
LADYBUG_SPEC = ("synthetic:ncams=49,npnts=7776,obs_per_pnt=4,noise_px=1.0,"
                "perturb=0.02,seed=0,pad_obs_to=512")
# The reference's "solved" statuses.
SOLVED = ("first_order", "small_residual", "small_step", "small_obj_change")
# Each route's metric-name suffix and "route" entry in its solve line.
ROUTE_TAGS = {"fused": ("", None), "sorted": ("_sorted", "camera_sorted"),
              "scatter_split": ("_scatter_split", "scatter_split"),
              "sorted_relin": ("_sorted_relin", "sorted_relin")}


def compare(name, got, ref, errs):
    """Raise unless ``got`` matches ``ref`` within TOL[name]; record the
    max abs error."""
    import torch
    rtol, afrac = TOL[name]
    got, ref = got.double(), ref.double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (got - ref).abs()
    scale = float(ref.abs().max())
    bound = rtol * ref.abs() + afrac * scale
    bad = int((diff > bound).sum())
    err = float(diff.max())
    print(f"  {name:10s} max_abs_err {err:.3e}  max|plain| {scale:.3e}  "
          f"rtol {rtol:g} atol {afrac:g}*max  violations {bad}")
    if bad:
        raise AssertionError(f"{name}: {bad} entries outside tolerance")
    errs[name] = max(errs.get(name, 0.0), err)


def compare_stored(name, got, ref, errs):
    """Raise unless the writer's stored W ``got`` matches its plain
    version's ``ref`` (both in the storage dtype) within one ulp of that
    dtype on top of the float32 tolerance TOL[name] (the two float32 W
    differ by that much — on cancelling entries by more than their last
    bit — before the store rounds them), with at most STORE_MISMATCH_MAX
    of the entries not bit-equal, and with any non-finite entries (a raw
    float16 W past 65504) at the same places; record the max abs error of
    the finite ones."""
    import torch
    mant, emin = {torch.bfloat16: (7, -126), torch.float16: (10, -14)}[
        got.dtype]
    if got.dtype != ref.dtype:
        raise AssertionError(f"{name}: stored as {got.dtype}, plain "
                             f"{ref.dtype}")
    g, r = got.float(), ref.float()
    fin = torch.isfinite(r)
    if not (torch.equal(fin, torch.isfinite(g))
            and torch.equal(g[~fin], r[~fin])):
        raise AssertionError(f"{name}: non-finite entries differ")
    g, r = g[fin], r[fin]
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp(
        min=2.0 ** emin))) - mant)
    rtol, afrac = TOL[name]
    diff = (g - r).abs()
    bad = int((diff > ulp + rtol * r.abs()
               + afrac * float(r.abs().max())).sum())
    differ = int((diff != 0).sum())
    err = float(diff.max()) if diff.numel() else 0.0
    print(f"  {name:10s} {str(got.dtype)[6:]} max_abs_err {err:.3e}  "
          f"non-finite {int((~fin).sum())}  beyond TOL + one ulp {bad}  "
          f"not bit-equal {differ} of {got.numel()}")
    if bad:
        raise AssertionError(f"{name}: {bad} entries beyond TOL + one ulp")
    if differ > STORE_MISMATCH_MAX * got.numel():
        raise AssertionError(f"{name}: {differ} of {got.numel()} entries "
                             f"not bit-equal to the plain version's")
    errs[name] = max(errs.get(name, 0.0), err)


def time_pair(kernel, plain, reps):
    """Median ms per call of ``kernel`` and ``plain``, timed in turns
    (plain, kernel, kernel, plain) with CUDA events over ``reps`` calls.
    Before each window the card spins SPIN_CYCLES a call
    (``torch.cuda._sleep``) while the host enqueues the window's calls, so
    the window times the card's work: a wrapper's host work takes about as
    long as a small kernel (~0.1 ms), and without the spin the window held
    it."""
    import torch
    times = {"kernel": [], "plain": []}
    fns = {"kernel": kernel, "plain": plain}
    kernel(), plain()
    for _ in range(3):
        for which in ("plain", "kernel", "kernel", "plain"):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES * reps)
            start.record()
            for _ in range(reps):
                fns[which]()
            stop.record()
            torch.cuda.synchronize()
            times[which].append(start.elapsed_time(stop) / reps)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    return med["kernel"], med["plain"]


def pass_times(fn, tag) -> dict:
    """Device ms a call of each pass of ``fn`` (its kernels, by name,
    under ``torch.profiler``: ``kernel_profile.device_ms``): K1's point
    pass (``ba_assemble_point_kernel``) and camera pass (the rest: the
    camera kernel and the objective's sum)."""
    from bundleadjustment_jl_tpu_torch.kernel_profile import device_ms
    by_name = device_ms(fn, tag)
    point = sum(ms for k, ms in by_name.items() if "point_kernel" in k)
    return {"point": point, "camera": sum(by_name.values()) - point,
            "kernels": by_name}


def check_kernels(name, problem, errs, timings, facts):
    """Phase 2 for one problem: route A's kernels (K1-K4) against their
    plain versions."""
    import torch
    from bundleadjustment_jl_tpu_torch.ops import fused_assemble as fa
    from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
    from bundleadjustment_jl_tpu_torch.ops.normal import inv3x3_damped_flat

    print(f"[kernels] {name}: nobs_pad {problem.nobs_pad}, ncams "
          f"{problem.ncams}, npnts {problem.npnts}")
    cams, points = problem.cams, problem.points
    gen = torch.Generator(device="cuda").manual_seed(0)
    reps = 20 if problem.nobs_pad < 1 << 18 else 5

    def assemble():
        return fa.assemble_scatter(problem, cams, points)
    W_t, hp12, hc90, obj = assemble()
    torch.cuda.synchronize()
    check_repeat("assemble", name, assemble, (W_t, hp12, hc90, obj), facts)
    pW, php, phc, pobj = fa._assemble_plain(problem, cams, points)
    compare("W", W_t, pW, errs)
    compare("hp12", hp12, php, errs)
    compare("hc90", hc90, phc, errs)
    compare("obj", obj.reshape(1), pobj.reshape(1), errs)
    timings.setdefault("assemble", {})[name] = time_pair(
        assemble, lambda: fa._assemble_plain(problem, cams, points), reps)
    passes = pass_times(assemble, f"{name}_assemble")
    facts.setdefault("assemble", {}).setdefault("pass_ms", {})[name] = passes
    print(f"  K1 passes (device ms a call): {json.dumps(passes)}")
    check = checker(name, problem, errs, timings, facts)

    # Damped point blocks as the solver forms them (lambda_0, "diag").
    lam = 1e-3 * float(torch.maximum(hc90[:, :81:10].max(),
                                     hp12[:, :9:4].max()))
    hpp_inv = inv3x3_damped_flat(hp12[:, :9].reshape(-1), lam)
    g_p = hp12[:, 9:12].contiguous()
    t = torch.einsum("pab,pb->pa", hpp_inv.reshape(-1, 3, 3), g_p)
    check("cam_reduce",
          lambda: fs.cam_reduce_wcw_rhs(W_t, problem, hpp_inv, t),
          lambda: fs._cam_reduce_wcw_rhs_plain(W_t, problem, hpp_inv, t))
    v = torch.randn((problem.ncams, 9), generator=gen, device="cuda")
    gp_f = g_p.reshape(-1)
    check("matvec",
          lambda: fs.matvec_cam_scatter(W_t, v, problem, hpp_inv, gp_f=gp_f,
                                        sign=-1.0, with_dp=True),
          lambda: fs._matvec_plain(W_t, v, problem, hpp_inv, gp_f, -1.0))
    check("matvec",        # the Schur matvec's form, timed
          lambda: fs.matvec_cam_scatter(W_t, v, problem, hpp_inv),
          lambda: fs._matvec_plain(W_t, v, problem, hpp_inv, None, 1.0)[0])

    check_objective(name, problem, errs, timings, facts, reps)
    for k in ("assemble", "cam_reduce", "matvec", "objective"):
        kms, pms = timings[k][name]
        print(f"  time {k:10s} kernel {kms:.4f} ms  plain {pms:.4f} ms")


def check_objective(name, problem, errs, timings, facts, reps):
    """K4 at OBJECTIVE_SCALES trial states (scales 1, 1/2, ...: S = 5 is
    a solve's line search) against its plain version, each launched twice (bit-identical); timed
    at S = 1 (the kernel table's row: a solve without the line search) and
    S = 5 (``facts``), each beside its bound, and its passes by kernel
    (``kernel_profile.device_ms``)."""
    import torch
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.kernel_profile import (
        device_ms, trial_states)
    from bundleadjustment_jl_tpu_torch.ops import fused_assemble as fa

    row = facts.setdefault("objective", {})
    for S in OBJECTIVE_SCALES:
        cams_all, pts_all = trial_states(problem.cams, problem.points,
                                         S)

        def kernel():
            return fa.objective_scatter(problem, cams_all, pts_all)

        def plain():
            return fa._objective_plain(problem, cams_all, pts_all)
        got = kernel()
        torch.cuda.synchronize()
        check_repeat("objective", f"{name}@S{S}", kernel, got, facts)
        compare("objective", got, plain(), errs)
        if S not in OBJECTIVE_TIMED:
            continue
        kms, pms = time_pair(kernel, plain, reps)
        bound = bench.bound_ms("objective", problem, scales=S)[0]
        if S == 1:
            timings.setdefault("objective", {})[name] = (kms, pms)
        row.setdefault(f"S{S}", {})[name] = {
            "ms": kms, "plain_ms": pms, "bound_ms": bound,
            "share_of_bound": bound / kms}
        passes = device_ms(kernel, f"{name}_objective_S{S}")
        row.setdefault("pass_ms", {})[f"{name}@S{S}"] = passes
        print(f"  K4 S = {S}: kernel {kms:.4f} ms  plain {pms:.4f} ms  "
              f"bound {bound:.4f} ms ({bound / kms:.3f} of it); passes "
              f"(device ms a call): {json.dumps(passes)}")


def outputs(x):
    return list(x) if isinstance(x, tuple) else [x]


def check_repeat(key, tag, kernel, got, facts):
    """For the redesigned forms (REPEAT_CHECKED): launch ``kernel`` again
    and raise unless its output is bit-identical to ``got`` (fixed-order
    sums, no atomics); recorded under the kernel's row in ``facts``."""
    import torch
    if key not in REPEAT_CHECKED:
        return
    again = kernel()
    torch.cuda.synchronize()
    same = all(torch.equal(g, a)
               for g, a in zip(outputs(got), outputs(again)))
    facts.setdefault(KERNEL_OF[key], {}).setdefault(
        "repeat_bit_identical", {})[f"{key}@{tag}"] = same
    if not same:
        raise AssertionError(f"{key} at {tag}: a repeat launch is not "
                             f"bit-identical")


def checker(name, problem, errs, timings, facts):
    """``check(key, kernel, plain)``: run the kernel (twice for the
    redesigned forms: ``check_repeat``), compare it with its plain version
    under TOL[key], time both (``time_pair``) and return the kernel's
    output."""
    import torch
    reps = 20 if problem.nobs_pad < 1 << 18 else 5

    def check(key, kernel, plain):
        got = kernel()
        torch.cuda.synchronize()
        check_repeat(key, name, kernel, got, facts)
        ref = plain()
        for g, r in zip(outputs(got), outputs(ref)):
            compare(key, g, r, errs)
        timings.setdefault(key, {})[name] = time_pair(kernel, plain, reps)
        return got
    return check


def plan_times(name, problem, facts):
    """Build each plan of ``problem`` twice more from scratch
    (``ops/plans.py``, on a copy of the problem with no plans, so shared
    pieces such as ``cam_pnt`` are built too) and record the second
    build's time (the first loads torch's sort kernels in a fresh
    process): K2's tiles under the K2 and K3 rows, K5's point ranges under
    the K5 and K3 rows, K5's column ranges under the K5 row, K6's under
    the K6 row, K8's camera-order rows under the K8 row. (K1 reads the
    point ranges.)"""
    import dataclasses

    import torch
    from bundleadjustment_jl_tpu_torch.ops import plans
    for label, build, rows in (
            ("tile_plan", plans.build_tile_plan, ("cam_reduce", "matvec")),
            ("point_blocks", plans.build_point_blocks,
             ("seg_block_reduce", "matvec")),
            ("cam_col_plan", plans.build_cam_col_plan,
             ("seg_block_reduce",)),
            ("wcw_col_plan", lambda p: plans.build_cam_col_plan(
                p, plans.WCW_BLOCK_COLS), ("seg_prod_reduce",)),
            ("cam_row_plan", plans.build_cam_row_plan,
             ("linearize_w_only",))):
        build(dataclasses.replace(problem, plans={}))
        torch.cuda.synchronize()
        fresh = dataclasses.replace(problem, plans={})
        t0 = time.perf_counter()
        plan = build(fresh)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if label == "point_blocks":
            size = f"{plan.shape[0] - 1} blocks"
        elif label == "cam_row_plan":
            nbytes = sum(t.numel() * t.element_size() for t in plan)
            size = f"{nbytes / 1e6:.1f} MB"
        else:
            size = (f"{plan.nruns} runs, {plan.nruns / problem.nobs_pad:.3f}"
                    f" a row")
        print(f"  plan {label:12s} {name}: {ms:.2f} ms ({size})")
        for k in rows:
            facts.setdefault(k, {}).setdefault("plan_build_ms", {})[
                f"{label}@{name}"] = ms


def check_sorted_kernels(name, problem, errs, timings, facts):
    """Phase 2 for one problem, camera-sorted route: K7, K6 (its three
    products) and K5 (both directions) against their plain versions, at
    the shapes the route's solve gives them."""
    import torch
    from bundleadjustment_jl_tpu_torch.ops import linearize as lz
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
    from bundleadjustment_jl_tpu_torch.ops.normal import inv3x3_damped_flat

    cams, points = problem.cams, problem.points
    gen = torch.Generator(device="cuda").manual_seed(1)
    check = checker(name, problem, errs, timings, facts)

    JR_t, W_t = check("linearize",
                      lambda: lz.linearize_w_kminor(problem, cams, points),
                      lambda: lz._linearize_plain(problem, cams, points))
    perm = problem.cam_perm.long()
    JR_cam_t, W_cam_t = JR_t[:, perm], W_t[:, perm]
    hp12 = check("seg_prod_pnt12", lambda: sr.jtj_pnt_reduce(JR_t, problem),
                 lambda: sr._jtj_pnt_plain(JR_t, problem))
    hc90 = check("seg_prod_cam90",
                 lambda: sr.jtj_cam_reduce(JR_cam_t, problem),
                 lambda: sr._jtj_cam_plain(JR_cam_t, problem))
    # Damped point blocks as the solver forms them (lambda_0, "diag").
    lam = 1e-3 * float(torch.maximum(hc90[:, :81:10].max(),
                                     hp12[:, :9:4].max()))
    hpp_inv = inv3x3_damped_flat(hp12[:, :9].reshape(-1), lam)
    check("seg_prod_wcw81",
          lambda: sr.wcw_cam_reduce(W_cam_t, problem, hpp_inv),
          lambda: sr._wcw_cam_plain(W_cam_t, problem, hpp_inv))
    v = torch.randn((problem.ncams, 9), generator=gen, device="cuda")
    g_p = hp12[:, 9:12].reshape(-1).contiguous()
    for kw in ({}, dict(hpp_inv_f=hpp_inv, add_f=g_p, sign=-1.0),
               dict(hpp_inv_f=hpp_inv)):      # the matvec's form, timed
        t = check("seg_block_point",
                  lambda: sr.wtv_point_reduce(W_t, v, problem, **kw),
                  lambda: sr._wtv_point_plain(W_t, v, problem, **kw))
    check("seg_block_camera", lambda: sr.wt_cam_reduce(W_cam_t, t, problem),
          lambda: sr._wt_cam_plain(W_cam_t, t, problem))
    for k in ("linearize", "seg_prod_pnt12", "seg_prod_cam90",
              "seg_prod_wcw81", "seg_block_point", "seg_block_camera"):
        kms, pms = timings[k][name]
        print(f"  time {k:16s} kernel {kms:.4f} ms  plain {pms:.4f} ms")


def check_split_kernels(name, problem, errs, timings, facts):
    """Phase 2 for one problem, the Final-scale routes' kernels: K8 against
    its plain version and against K7's W in camera order (``facts`` keeps
    whether the two are bit-identical), K2's cam90, W C W' and W op
    products against theirs, at the shapes the routes' solves give them."""
    import torch
    from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
    from bundleadjustment_jl_tpu_torch.ops import linearize as lz
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
    from bundleadjustment_jl_tpu_torch.ops.normal import inv3x3_damped_flat

    print(f"[split kernels] {name}: nobs_pad {problem.nobs_pad}, ncams "
          f"{problem.ncams}, npnts {problem.npnts}")
    cams, points = problem.cams, problem.points
    gen = torch.Generator(device="cuda").manual_seed(2)
    check = checker(name, problem, errs, timings, facts)
    JR_t, W_t = lz.linearize_w_kminor(problem, cams, points)
    W_cam_t = check("linearize_w_only",
                    lambda: lz.linearize_w_only(problem, cams, points),
                    lambda: lz._linearize_w_only_plain(problem, cams, points))
    W_perm = W_t[:, problem.cam_perm.long()]
    compare("linearize_w_only", W_cam_t, W_perm, errs)
    same = bool(torch.equal(W_cam_t, W_perm))
    facts.setdefault("linearize_w_only", {}).setdefault(
        "k8_bit_identical_to_k7", {})[name] = same
    print(f"  K8 W_cam_t vs K7 W_t[:, cam_perm] bit-identical: {same}")
    del W_cam_t, W_perm
    hc90 = check("cam_reduce_cam90", lambda: fs.cam_reduce_cam90(JR_t, problem),
                 lambda: fs._cam_reduce_cam90_plain(JR_t, problem))
    hp12 = sr.jtj_pnt_reduce(JR_t, problem)
    del JR_t
    # Damped point blocks as the solver forms them (lambda_0, "diag").
    lam = 1e-3 * float(torch.maximum(hc90[:, :81:10].max(),
                                     hp12[:, :9:4].max()))
    hpp_inv = inv3x3_damped_flat(hp12[:, :9].reshape(-1), lam)
    check("cam_reduce_wcw81", lambda: fs.cam_reduce_wcw(W_t, problem, hpp_inv),
          lambda: fs._cam_reduce_wcw_plain(W_t, problem, hpp_inv))
    # The matvec's operand: its point pass on a random camera vector.
    v = torch.randn((problem.ncams, 9), generator=gen, device="cuda")
    t = sr.wtv_point_reduce(W_t, v, problem, hpp_inv_f=hpp_inv)
    check("cam_reduce_w_op", lambda: fs.cam_reduce_w_op(W_t, problem, t),
          lambda: fs._cam_reduce_w_op_plain(W_t, problem, t))
    for k in ("linearize_w_only", "cam_reduce_cam90", "cam_reduce_wcw81",
              "cam_reduce_w_op"):
        kms, pms = timings[k][name]
        print(f"  time {k:16s} kernel {kms:.4f} ms  plain {pms:.4f} ms")


def check_probe(errs, timings, probe):
    """Phase 5: K9 against its plain version at Dubrovnik-356's and
    Final-4585's row counts, 0-2 small rows. With no small row the plain
    version is ``torch.sum(big, 1)``, the one-call yardstick: its time is
    the probe's ``library_ms``. ``probe`` gets, per row count, the rates in
    GB/s."""
    import torch
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.ops.stream_probe import (
        _stream_probe_plain, stream_probe)

    for name in ("dubrovnik356", FINAL):
        shape = bench.shape(name)
        n = shape.nobs_pad
        gen = torch.Generator(device="cuda").manual_seed(4)
        big = torch.rand((32, n), generator=gen, device="cuda")
        small = [torch.rand((n,), generator=gen, device="cuda")
                 for _ in range(2)]
        for nsmall in (0, 1, 2):
            args = (big, *small[:nsmall])
            got = stream_probe(*args)
            torch.cuda.synchronize()
            compare("stream_probe", got, _stream_probe_plain(*args), errs)
            kms, pms = time_pair(lambda: stream_probe(*args),
                                 lambda: _stream_probe_plain(*args), 10)
            nbytes = bench.kernel_bytes("stream_probe", shape, nsmall=nsmall)
            gbs = nbytes / (kms * 1e-3) / 1e9
            of_peak = gbs / bench.PEAK_HBM_GBS
            line = {"kernel_gbs": gbs, "kernel_ms": kms, "plain_ms": pms,
                    "of_peak_hbm": of_peak}
            if nsmall == 0:
                timings.setdefault("stream_probe", {})[name] = (kms, pms)
                timings.setdefault("library", {})[name] = pms
            probe.setdefault(name, {})[f"nsmall{nsmall}"] = line
            print(f"  probe {name} nsmall {nsmall}: kernel {kms:.4f} ms "
                  f"({gbs:.1f} GB/s, {of_peak:.3f} of "
                  f"{bench.PEAK_HBM_GBS / 1e3:g} TB/s)  plain"
                  f"{' (torch.sum)' if nsmall == 0 else ''} {pms:.4f} ms")
        del big, small


def check_narrow(name, problem, errs, timings, facts, final=False):
    """Phase 6 for one problem: every kernel that reads or writes W, with W
    in bfloat16 and in float16, against its plain version (``final``:
    all but K7, which writes W for route C alone), timed in
    turns, five launches a window as
    phase 2 times the float32 forms at this size (two at Final-4585, where
    each launch takes milliseconds and the plain versions are slow); the
    planned forms launched twice, bit-identical (``check_repeat``). Times
    go to ``timings["<key>@<dtype>"]``."""
    import torch
    from bundleadjustment_jl_tpu_torch.ops import fused_assemble as fa
    from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
    from bundleadjustment_jl_tpu_torch.ops import linearize as lz
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
    from bundleadjustment_jl_tpu_torch.ops.normal import inv3x3_damped_flat
    from bundleadjustment_jl_tpu_torch.solver import lm_jit

    print(f"[narrow W] {name}: nobs_pad {problem.nobs_pad}")
    cams, points = problem.cams, problem.points
    gen = torch.Generator(device="cuda").manual_seed(5)
    JR_t, W32 = lz.linearize_w_kminor(problem, cams, points)
    hp12 = sr.jtj_pnt_reduce(JR_t, problem)
    del JR_t
    lam = 1e-3 * float(hp12[:, :9:4].max())
    hpp_inv = inv3x3_damped_flat(hp12[:, :9].reshape(-1), lam)
    g_p = hp12[:, 9:12].reshape(-1).contiguous()
    t = torch.einsum("pab,pb->pa", hpp_inv.reshape(-1, 3, 3),
                     g_p.reshape(-1, 3))
    v = torch.randn((problem.ncams, 9), generator=gen, device="cuda")
    perm = problem.cam_perm.long()
    for dt in NARROW:
        dtype = getattr(torch, dt)

        def check(key, kernel, plain, stored=(), tols=None):
            """``stored``: indices of outputs that are W (compared to
            TOL + one ulp); the rest to TOL[key], or TOL[tols[i]] for
            output i."""
            got = kernel()
            torch.cuda.synchronize()
            check_repeat(key, f"{name}@{dt}", kernel, got, facts)
            ref = plain()
            pairs = list(zip(outputs(got), outputs(ref)))
            for i, (g, r) in enumerate(pairs):
                if i in stored:
                    compare_stored(tols[i] if tols else key, g, r, errs)
                else:
                    compare(tols[i] if tols else key, g.reshape(-1),
                            r.reshape(-1), errs)
            timings.setdefault(f"{key}@{dt}", {})[name] = time_pair(
                kernel, plain, 2 if final else 5)

        W = lm_jit.narrow_w(W32, dtype)
        check("assemble",
              lambda: fa.assemble_scatter(problem, cams, points, dtype),
              lambda: fa._assemble_plain(problem, cams, points, dtype),
              stored=(0,), tols=("W", "hp12", "hc90", "obj"))
        if not final:
            check("linearize",
                  lambda: lz.linearize_w_kminor(problem, cams, points, dtype),
                  lambda: lz._linearize_plain(problem, cams, points, dtype),
                  stored=(1,))
        check("linearize_w_only",
              lambda: lz.linearize_w_only(problem, cams, points, dtype),
              lambda: lz._linearize_w_only_plain(problem, cams, points,
                                                 dtype), stored=(0,))
        check("cam_reduce_w_op", lambda: fs.cam_reduce_w_op(W, problem, t),
              lambda: fs._cam_reduce_w_op_plain(W, problem, t))
        check("cam_reduce",
              lambda: fs.cam_reduce_wcw_rhs(W, problem, hpp_inv, t),
              lambda: fs._cam_reduce_wcw_rhs_plain(W, problem, hpp_inv, t))
        check("cam_reduce_wcw81",
              lambda: fs.cam_reduce_wcw(W, problem, hpp_inv),
              lambda: fs._cam_reduce_wcw_plain(W, problem, hpp_inv))
        check("matvec",
              lambda: fs.matvec_cam_scatter(W, v, problem, hpp_inv),
              lambda: fs._matvec_plain(W, v, problem, hpp_inv, None,
                                       1.0)[0])
        check("seg_block_point",
              lambda: sr.wtv_point_reduce(W, v, problem, hpp_inv_f=hpp_inv),
              lambda: sr._wtv_point_plain(W, v, problem, hpp_inv))
        W_cam = W[:, perm].contiguous()
        check("seg_block_camera",
              lambda: sr.wt_cam_reduce(W_cam, t, problem),
              lambda: sr._wt_cam_plain(W_cam, t, problem))
        check("seg_prod_wcw81",
              lambda: sr.wcw_cam_reduce(W_cam, problem, hpp_inv),
              lambda: sr._wcw_cam_plain(W_cam, problem, hpp_inv))
        del W_cam
        del W
    for k in sorted(k for k in timings if "@" in k and name in timings[k]):
        kms, pms = timings[k][name]
        print(f"  time {k:26s} kernel {kms:.4f} ms  plain {pms:.4f} ms")


@contextlib.contextmanager
def plain_route():
    """``normal.PALLAS_MODE`` off (the JAX package's ``PALLAS_MODE``): the
    solver's stage table (`ops/normal.py:solve_stages`) is then the plain
    twins for every stage of a solve on CUDA tensors."""
    from bundleadjustment_jl_tpu_torch.ops import normal
    old = normal.PALLAS_MODE
    normal.PALLAS_MODE = False
    try:
        yield
    finally:
        normal.PALLAS_MODE = old


def check_launches(name, res, counts, w_counts, route, facto,
                   solver="pcg", work=None):
    """Each kernel launched as often as the solve's own record implies
    (``lm_jit.expected_launches`` for its step ``solver``; a host-driver
    ``LMResult``: ``lm.expected_host_launches``), and none of the other
    routes'; the W kernels' launches ``w_counts`` (``_cuda.W_LAUNCHES``)
    with W in the dtypes ``facto`` and the working dtype ``work`` (None:
    float32) imply (``lm_jit.expected_w_launches``)."""
    import torch
    from bundleadjustment_jl_tpu_torch.solver.lm import (
        LMResult, expected_host_launches)
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
        expected_launches, expected_w_launches)
    expect = dict.fromkeys(counts, 0)
    if isinstance(res, LMResult):
        expect.update(expected_host_launches(route, res, solver))
    else:
        it = res.iterations
        expect.update(expected_launches(route, it, res.naccepts,
                                        int(res.hist_cg[:it].sum()), solver))
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts} != {expect}")
    w_expect = expected_w_launches(counts, facto, work or torch.float32)
    if w_counts != w_expect:
        raise AssertionError(f"{name}: W launches by storage dtype "
                             f"{w_counts} != {w_expect}")


def agree(res, ref) -> bool:
    """Same status, iterations within one, objective to rel 1e-4."""
    return (res.status_name() == ref.status_name()
            and abs(res.iterations - ref.iterations) <= 1
            and abs(res.objective - ref.objective) <= 1e-4 * ref.objective)


def agree_decisions(res, ref) -> bool:
    """Same status, iterations within one (the narrow-W solves' check:
    their objectives carry the storage dtype's noise)."""
    return (res.status_name() == ref.status_name()
            and abs(res.iterations - ref.iterations) <= 1)


def check_route(name, make, cam_scatter, launches_total, repeats=REPEATS,
                facto=None, plain_solve=True):
    """Phase 3 for one problem on the kernel route the gates pick with
    ``normal.CAM_SCATTER = cam_scatter``, W stored in ``facto``
    (``facto_dtype``; None: float32); returns its solve. With
    ``plain_solve`` the plain route solves it too, and must agree."""
    import torch
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.ops import _cuda, normal

    normal.CAM_SCATTER = cam_scatter
    bench.solve_cfg(make(1), facto)                   # warm-up
    problem = make(0)
    route = normal.kernel_route(problem)
    times = []
    for _ in range(repeats):
        _cuda.reset_launches()
        secs, res = bench.timed_solve(problem, facto)
        counts, w_counts = dict(_cuda.LAUNCHES), dict(_cuda.W_LAUNCHES)
        times.append(secs)
        check_launches(name, res, counts, w_counts, route, facto)
        for k, v in counts.items():
            launches_total[k] += v
    secs = sorted(times)[len(times) // 2]

    it, cg = res.iterations, int(res.hist_cg[:res.iterations].sum())
    nequ = 2 * problem.nobs
    rmse = (2.0 * res.objective / nequ) ** 0.5
    suffix, route_name = ROUTE_TAGS[route]
    tag = {None: "", torch.bfloat16: "_bf16facto",
           torch.float16: "_f16facto"}[facto]
    line = {
        "metric": f"{name}_synth_lm_solve{suffix}{tag}", "value": secs,
        "unit": "s", "values": times,
        "status": res.status_name(), "iterations": it, "cg_matvecs": cg,
        "per_iter_ms": 1e3 * secs / max(it, 1),
        "objective": res.objective, "rmse_px": rmse,
        "naccepts": res.naccepts,
        "launches": {k: v for k, v in counts.items() if v},
        "w_launches": {str(k)[6:]: v for k, v in w_counts.items() if v},
    }
    if plain_solve:
        with plain_route():
            _cuda.reset_launches()
            plain_secs, plain = bench.timed_solve(problem, facto)
            plain_counts = dict(_cuda.LAUNCHES)
        line.update({"plain_value": plain_secs,
                     "plain_status": plain.status_name(),
                     "plain_iterations": plain.iterations,
                     "plain_objective": plain.objective})
    if route_name:
        line["route"] = route_name
    if facto is not None:
        line["facto_dtype"] = str(facto)[6:]
    if repeats != REPEATS:
        line["repeats"] = repeats
    print(json.dumps(line))

    if not (torch.isfinite(res.cams).all() and torch.isfinite(
            res.points).all()) or res.cams.shape != problem.cams.shape \
            or res.points.shape != problem.points.shape:
        raise AssertionError(f"{name}: bad solution state")
    if res.status_name() == "exception":
        raise AssertionError(f"{name}: the solve ended in an exception")
    if plain_solve:
        if any(plain_counts.values()):
            raise AssertionError(f"{name}: plain route launched "
                                 f"{plain_counts}")
        if not agree(res, plain):
            raise AssertionError(f"{name}: kernel and plain routes disagree "
                                 f"({route})")
    if abs(rmse - RMSE[name]) > 0.01 * RMSE[name]:
        raise AssertionError(f"{name}: rmse {rmse} not within 1% of "
                             f"{RMSE[name]} ({route})")
    return res


def check_solves(name, launches_total):
    """Phase 3 for one problem: both kernel routes, which must agree;
    returns ``{normal.CAM_SCATTER: the route's solve}``."""
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.ops import normal

    default = normal.CAM_SCATTER
    try:
        res = {cs: check_route(name, lambda seed: bench.make_problem(
            name, seed), cs, launches_total) for cs in ROUTES}
    finally:
        normal.CAM_SCATTER = default
    if not agree(res[False], res[True]):
        raise AssertionError(f"{name}: the fused and camera-sorted kernel "
                             f"routes disagree")
    return res


def final_routes(problem, launches_total, facto=None, plain_solve=True):
    """Final-4585 on the routes the default gates pick with camera scatter
    on (B1) and off (B2), W stored in ``facto``: ``{route: its solve}``.
    The warm-up solves the same problem (it is not rebuilt)."""
    from bundleadjustment_jl_tpu_torch.ops import normal

    default = normal.CAM_SCATTER
    res = {}
    try:
        for cs, route in ((True, "scatter_split"), (False, "sorted_relin")):
            normal.CAM_SCATTER = cs
            if normal.kernel_route(problem) != route:
                raise AssertionError(f"{FINAL}: the gates pick "
                                     f"{normal.kernel_route(problem)}, "
                                     f"not {route}")
            res[route] = check_route(FINAL, lambda seed: problem, cs,
                                     launches_total, repeats=FINAL_REPEATS,
                                     facto=facto, plain_solve=plain_solve)
    finally:
        normal.CAM_SCATTER = default
    return res


def check_f64_solve(f32_res):
    """Phase 3, float64: Dubrovnik-356 built by the default constructor
    (float64, on the card) from the same seed and options as the float32
    problem, solved with bench's options after a warm-up (seed 1): the
    solver's plain route, no kernel launched; the rmse on the anchor; the
    relative gap of its objective to ``f32_res`` (route A's float32
    solve)."""
    import torch
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
    from bundleadjustment_jl_tpu_torch.ops import _cuda, normal

    name = "dubrovnik356"

    def make(seed):
        return synthetic_bal(**bench.PROBLEMS[name], noise_px=1.0,
                             perturb=2e-2, seed=seed, pad_obs_to=512)[0]
    bench.solve_cfg(make(1))                            # warm-up
    problem = make(0)
    if problem.dtype != torch.float64 or not problem.cams.is_cuda:
        raise AssertionError(f"{name}: the default constructor built "
                             f"{problem.dtype} on {problem.cams.device}")
    if normal.solve_stages(problem.dtype) is not normal.PLAIN:
        raise AssertionError(f"{name}: float64 is not on the plain route")
    _cuda.reset_launches()
    secs, res = bench.timed_solve(problem)
    counts = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    it = res.iterations
    rmse = (2.0 * res.objective / (2 * problem.nobs)) ** 0.5
    gap = abs(f32_res.objective - res.objective) / res.objective
    print(json.dumps({
        "metric": f"{name}_synth_lm_solve_f64", "value": secs, "unit": "s",
        "status": res.status_name(), "iterations": it,
        "cg_matvecs": int(res.hist_cg[:it].sum()),
        "objective": res.objective, "rmse_px": rmse, "route": "plain",
        "launches": counts, "f32_objective": f32_res.objective,
        "f32_status": f32_res.status_name(),
        "f32_iterations": f32_res.iterations, "rel_gap_f32_f64": gap}))
    if counts:
        raise AssertionError(f"{name}: the float64 solve launched {counts}")
    if res.status_name() == "exception" or not (
            torch.isfinite(res.cams).all() and torch.isfinite(
                res.points).all()):
        raise AssertionError(f"{name}: the float64 solve failed")
    if abs(rmse - RMSE[name]) > 0.01 * RMSE[name]:
        raise AssertionError(f"{name}: float64 rmse {rmse} not within 1% of "
                             f"{RMSE[name]}")
    return {"value": secs, "rel_gap_f32_f64": gap, "objective": res.objective,
            "f32_objective": f32_res.objective}


def check_final_solves(problem, launches_total):
    """Phase 4: Final-4585 on B1 and B2, which must agree; returns
    ``{route: its solve}``."""
    res = final_routes(problem, launches_total)
    if not agree(res["sorted_relin"], res["scatter_split"]):
        raise AssertionError(f"{FINAL}: routes B1 and B2 disagree")
    return res


def check_final_schur(name, problem, errs):
    """Phase 4, route B1's one-pass Schur pieces against their two-pass
    forms at Final-4585 (the check of tests/test_cam_scatter.py at this
    size): ``reduce_and_diag`` against ``reduce_system`` plus
    ``schur_diag_blocks`` (K2's W C W' | W t product against its W op and
    W C W' products), ``back_substitute_quad`` against ``back_substitute``
    plus ``quad_form``. Checks and returns its own launch counts (K2's W
    op: the reduced right-hand side and the two |J d|^2 cross terms),
    which are no solve's."""
    import torch
    from bundleadjustment_jl_tpu_torch.ops import _cuda
    from bundleadjustment_jl_tpu_torch.ops import schur as sc
    from bundleadjustment_jl_tpu_torch.ops.normal import assemble_blocks

    _cuda.reset_launches()
    blocks = assemble_blocks(problem, route="scatter_split")
    lam = 1e-3 * float(torch.maximum(blocks.Hcc_f.reshape(-1, 81)[:, ::10]
                                     .max(), blocks.Hpp_f.reshape(-1, 9)
                                     [:, ::4].max()))
    sys1, Sd1 = sc.reduce_and_diag(problem, blocks, lam)
    sys2 = sc.reduce_system(problem, blocks, lam)
    Sd2 = sc.schur_diag_blocks(sys2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    dc = 1e-3 * torch.randn(problem.cams.shape, generator=gen, device="cuda")
    dp1, q1 = sc.back_substitute_quad(problem, blocks, sys1, dc)
    dp2 = sc.back_substitute(sys2, dc)
    q2 = sc.quad_form(problem, blocks, dc, dp2)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    print(f"[schur B1] {name}")
    compare("schur", sys1.b, sys2.b, errs)
    compare("schur", Sd1, Sd2, errs)
    compare("schur", dp1, dp2, errs)
    compare("schur", q1.reshape(1), q2.reshape(1), errs)
    expect = dict.fromkeys(counts, 0)
    expect.update(linearize=1, cam_reduce_cam90=1, seg_prod_pnt12=1,
                  cam_reduce=1, cam_reduce_w_op=3, cam_reduce_wcw81=1,
                  seg_block_point=2)
    if counts != expect:
        raise AssertionError(f"{name}: Schur check launches {counts} != "
                             f"{expect}")
    return counts


def check_facto_solves(final, launches_total):
    """Phase 7: ``facto_dtype`` solves. Dubrovnik-356 with bfloat16 and
    float16 W on routes A and C, each held to the JAX package's record
    (FACTO_RECORD: its status, iterations within one), then Final-4585 with
    bfloat16 W on B1 and B2. The two routes of a problem must agree.
    Returns ``{dtype name: its Dubrovnik-356 solve on route A}``."""
    import torch
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.ops import normal

    name = "dubrovnik356"
    built = {seed: bench.make_problem(name, seed) for seed in (0, 1)}
    default = normal.CAM_SCATTER
    route_a = {}
    try:
        for dt in NARROW:
            status, iters = FACTO_RECORD[dt]
            res = {}
            for cs in ROUTES:
                r = res[cs] = check_route(
                    name, built.__getitem__, cs, launches_total,
                    facto=getattr(torch, dt), plain_solve=False)
                print(f"  {name} W {dt} route {ROUTES[cs]}: "
                      f"{r.status_name()} / {r.iterations} iterations "
                      f"(the JAX package's record: {status} / {iters})")
                if (r.status_name() != status
                        or abs(r.iterations - iters) > 1):
                    raise AssertionError(
                        f"{name}: W in {dt} on route {ROUTES[cs]} ends "
                        f"{r.status_name()} / {r.iterations}, not the JAX "
                        f"record {status} / {iters}")
            if not agree_decisions(res[True], res[False]):
                raise AssertionError(f"{name}: routes A and C disagree with "
                                     f"W in {dt}")
            route_a[dt] = res[True]
    finally:
        normal.CAM_SCATTER = default
    del built
    res = final_routes(final, launches_total, facto=torch.bfloat16,
                       plain_solve=False)
    if not agree_decisions(res["scatter_split"], res["sorted_relin"]):
        raise AssertionError(f"{FINAL}: routes B1 and B2 disagree with W in "
                             f"bfloat16")
    return route_a


def run_solver(problem, solver, driver):
    """One solve of ``problem`` with bench.py's options by step ``solver``
    through the one-shot (``"jit"``) or the host-stepped (``"host"``)
    driver."""
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.solver import (
        LMOptions, levenberg_marquardt)
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
        levenberg_marquardt_jit)
    if driver == "host":
        return levenberg_marquardt(problem, LMOptions(solver=solver,
                                                      **bench.SOLVE_OPTS))
    use = {} if solver == "pcg" else {f"use_{solver}": True}
    return levenberg_marquardt_jit(problem, **bench.SOLVE_OPTS, **use)


def host_status(res) -> str:
    """The status the host-stepped driver gives where the one-shot solve
    ``res`` ended: the same, but for a last step that passed both the
    first-order and the small objective change tests. The one-shot driver
    tests first-order first; the host driver tests the objective change
    right after the accept and first-order only at the next iteration's
    start (the JAX drivers' order, `solver/lm_jit.py:612-621` and
    `solver/lm.py:403-407` there), so it says small_obj_change."""
    from bundleadjustment_jl_tpu_torch import bench
    status, it = res.status_name(), res.iterations
    if status != "first_order" or it == 0:
        return status
    prev = float(res.hist_obj[it - 1])
    tol = bench.SOLVE_OPTS["oatol"] + bench.SOLVE_OPTS["ortol"] * abs(prev)
    return "small_obj_change" if prev - res.objective < tol else status


def check_chunked(problem, launches_total):
    """Phase 8, the chunked driver on route A at Dubrovnik-356: with
    ``chunk_iters`` = CHUNK_ITERS bit-identical to the one-shot solve
    (status, iterations, histories, cams, points) with the launches
    ``lm_jit.expected_launches`` gives; stopped after one chunk with a
    checkpoint (in a temporary directory under the git-ignored build
    directory) and resumed, bit-identical to it from the resumed iteration
    on; ``max_time=0`` stops with status ``max_time`` after 0 iterations.
    Returns its JSON line."""
    import tempfile

    import numpy as np
    import torch
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.ops import _cuda, normal
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
        levenberg_marquardt_jit_chunked)

    def same(a, b, start=0):
        n = b.iterations
        return ((a.status, a.iterations, a.objective) ==
                (b.status, b.iterations, b.objective)
                and all(np.array_equal(getattr(a, k)[start:n],
                                       getattr(b, k)[start:n])
                        for k in ("hist_obj", "hist_gnorm", "hist_lam",
                                  "hist_cg"))
                and torch.equal(a.cams, b.cams)
                and torch.equal(a.points, b.points))

    opts = dict(bench.SOLVE_OPTS, chunk_iters=CHUNK_ITERS)
    route = normal.kernel_route(problem)
    one = run_solver(problem, "pcg", "jit")
    _cuda.reset_launches()
    chk = levenberg_marquardt_jit_chunked(problem, **opts)
    counts = dict(_cuda.LAUNCHES)
    check_launches("chunked", chk, counts, dict(_cuda.W_LAUNCHES), route,
                   None)
    for k, v in counts.items():
        launches_total[k] += v
    build = ROOT / PKG / "_build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        part = levenberg_marquardt_jit_chunked(
            problem, checkpoint_dir=d, stop_after_chunks=1, **opts)
        resumed = levenberg_marquardt_jit_chunked(
            problem, checkpoint_dir=d, resume=True, **opts)
    timed_out = levenberg_marquardt_jit_chunked(problem, max_time=0.0,
                                                **opts)
    line = {"metric": "dubrovnik356_chunked", "route": route,
            "chunk_iters": CHUNK_ITERS, "status": chk.status_name(),
            "iterations": chk.iterations, "elapsed_time": chk.elapsed_time,
            "launches": {k: v for k, v in counts.items() if v},
            "bit_identical_to_one_shot": same(chk, one),
            "resumed_from": part.iterations,
            "resume_bit_identical": same(resumed, one, part.iterations),
            "max_time_0": [timed_out.status_name(), timed_out.iterations]}
    print(json.dumps(line))
    if not line["bit_identical_to_one_shot"]:
        raise AssertionError("chunked solve differs from the one-shot solve")
    if part.iterations != CHUNK_ITERS or not line["resume_bit_identical"]:
        raise AssertionError("resumed solve differs from the one-shot solve")
    if line["max_time_0"] != ["max_time", 0]:
        raise AssertionError(f"max_time=0 gave {line['max_time_0']}")
    return line


def check_solvers(solves, launches_total, card):
    """Phase 8, each case of SOLVER_CASES: on each of its routes a warm-up
    (seed 1; none with one timed solve) and its timed solves, each launch
    count checked against the solve's own record (``check_launches``);
    the status solved, the rmse within 1% of the problem's anchor; the
    host driver's pcg solve makes phase 3's one-shot decisions (status,
    iterations within one). Prints and returns a JSON line a case and
    route, the median seconds beside the card, with the peak device
    memory of its timed solves."""
    import torch
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.ops import _cuda, normal
    from bundleadjustment_jl_tpu_torch.solver.lm import LMResult

    built = {}
    lines = []
    default = normal.CAM_SCATTER
    try:
        for name, solver, driver, scatter, repeats in SOLVER_CASES:
            if name not in built:
                built.clear()
                built[name] = [bench.make_problem(name, seed)
                               for seed in (0, 1)]
            problem, warm = built[name]
            for cs in scatter:
                normal.CAM_SCATTER = cs
                route = normal.kernel_route(problem)
                tag = f"{name}_{driver}_{solver}{ROUTE_TAGS[route][0]}"
                if repeats > 1:
                    run_solver(warm, solver, driver)
                torch.cuda.reset_peak_memory_stats()
                times = []
                for _ in range(repeats):
                    _cuda.reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = run_solver(problem, solver, driver)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    counts = dict(_cuda.LAUNCHES)
                    check_launches(tag, res, counts,
                                   dict(_cuda.W_LAUNCHES), route, None,
                                   solver)
                    for k, v in counts.items():
                        launches_total[k] += v
                host = isinstance(res, LMResult)
                status = res.status if host else res.status_name()
                cg = (sum(r["cg_iters"] for r in res.history) if host
                      else int(res.hist_cg[:res.iterations].sum()))
                rmse = (res.objective / problem.nobs) ** 0.5
                line = {"metric": f"{tag}_synth_lm_solve",
                        "value": sorted(times)[len(times) // 2],
                        "unit": "s", "values": times, "card": card,
                        "status": status, "iterations": res.iterations,
                        "cg_matvecs": cg, "objective": res.objective,
                        "rmse_px": rmse, "route": route,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "launches": {k: v for k, v in counts.items() if v}}
                print(json.dumps(line))
                lines.append(line)
                if status not in SOLVED or not (
                        torch.isfinite(res.cams).all()
                        and torch.isfinite(res.points).all()):
                    raise AssertionError(f"{tag}: ended {status}")
                if abs(rmse - RMSE[name]) > 0.01 * RMSE[name]:
                    raise AssertionError(f"{tag}: rmse {rmse} not within 1% "
                                         f"of {RMSE[name]}")
                if solver == "pcg":
                    ref = solves[name][cs]
                    want = host_status(ref)
                    if (status != want
                            or abs(res.iterations - ref.iterations) > 1):
                        raise AssertionError(
                            f"{tag}: {status} / {res.iterations}, the "
                            f"one-shot solve {ref.status_name()} / "
                            f"{ref.iterations} (host: {want})")
    finally:
        normal.CAM_SCATTER = default
    return lines

@contextlib.contextmanager
def recorded_solves(calls):
    """Each one-shot solve `benchmark/precision.py` makes, recorded in
    ``calls`` as ``(result, launches, W launches, working dtype)``, its
    launches counted from 0 (``_cuda.LAUNCHES`` and ``W_LAUNCHES`` are
    reset before it and read after it)."""
    from bundleadjustment_jl_tpu_torch.benchmark import precision
    from bundleadjustment_jl_tpu_torch.ops import _cuda
    solve = precision.levenberg_marquardt_jit

    def recording(problem, **kwargs):
        _cuda.reset_launches()
        res = solve(problem, **kwargs)
        calls.append((res, dict(_cuda.LAUNCHES), dict(_cuda.W_LAUNCHES),
                      problem.dtype))
        return res

    precision.levenberg_marquardt_jit = recording
    try:
        yield
    finally:
        precision.levenberg_marquardt_jit = solve


def stage_line(tag, row, call, problem, card, **extra):
    """The JSON line of one cascade stage (a row of ``precision_cascade``
    and its recorded solve)."""
    res, counts, w_counts, _ = call
    line = {"metric": tag, "stage": row["stage"], "status": row["status"],
            "iterations": row["iterations"],
            "cg_matvecs": int(res.hist_cg[:res.iterations].sum()),
            "objective": row["objective"],
            "rmse_px": (row["objective"] / problem.nobs) ** 0.5,
            "dual_feas": row["dual_feas"], "facto_bytes": row["facto_bytes"],
            "launches": {k: v for k, v in counts.items() if v},
            "w_launches": {str(k)[6:]: v for k, v in w_counts.items() if v},
            "card": card}
    line.update(extra)
    return line


def check_cascade(problem, warm, launches_total, card):
    """Phase 9: ``precision_cascade`` with stages CASCADE at Dubrovnik-356
    (bench.py's float32 problem and options) on route A (the default) and
    route C: a warm-up (seed 1), CASCADE_REPEATS timed cascades (each
    stage's seconds: the median of its ``elapsed_s``, which ends at a host
    read of the objective) and one on the plain route. Each stage's
    launches are checked against its own record (``check_launches``: the
    bfloat16 stage runs the route's kernels with W written and read in
    bfloat16), the plain cascade launches nothing, the bfloat16 stage
    makes the plain route's decisions to the CASCADE_ITERS /
    CASCADE_REL bar, the float32 stage to ``agree``'s, and its rmse lands
    on the anchor. ``problem`` and ``warm``: Dubrovnik-356 from seeds 0
    and 1. Returns the lines."""
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.benchmark.precision import (
        precision_cascade)
    from bundleadjustment_jl_tpu_torch.ops import normal

    name = "dubrovnik356"
    lines = []
    default = normal.CAM_SCATTER
    try:
        for cs in ROUTES:
            normal.CAM_SCATTER = cs
            route = normal.kernel_route(problem)
            precision_cascade(warm, CASCADE, **bench.SOLVE_OPTS)
            runs = []
            for _ in range(CASCADE_REPEATS):
                calls = []
                with recorded_solves(calls):
                    rows = precision_cascade(problem, CASCADE,
                                             **bench.SOLVE_OPTS)
                runs.append((rows, calls))
                for i, stage in enumerate(CASCADE):
                    res, counts, w_counts, dt = calls[i]
                    check_launches(f"{name} cascade {stage} ({route})", res,
                                   counts, w_counts, route, None, work=dt)
                    for k, v in counts.items():
                        launches_total[k] += v
            plain_calls = []
            with plain_route(), recorded_solves(plain_calls):
                plain = precision_cascade(problem, CASCADE,
                                          **bench.SOLVE_OPTS)
            rows, calls = runs[-1]
            for i, stage in enumerate(CASCADE):
                secs = sorted(r[i]["elapsed_s"] for r, _ in runs)
                tag = f"{name}_cascade_{stage}{ROUTE_TAGS[route][0]}"
                line = stage_line(
                    tag, rows[i], calls[i], problem, card, route=route,
                    value=secs[len(secs) // 2], unit="s", values=secs,
                    plain_status=plain[i]["status"],
                    plain_iterations=plain[i]["iterations"],
                    plain_objective=plain[i]["objective"],
                    plain_value=plain[i]["elapsed_s"])
                print(json.dumps(line))
                lines.append(line)
                res, plain_res = calls[i][0], plain_calls[i][0]
                if any(plain_calls[i][1].values()):
                    raise AssertionError(f"{tag}: the plain route launched "
                                         f"{plain_calls[i][1]}")
                if stage == "bfloat16":
                    ok = (res.status == plain_res.status
                          and abs(res.iterations - plain_res.iterations)
                          <= CASCADE_ITERS
                          and abs(res.objective - plain_res.objective)
                          <= CASCADE_REL * plain_res.objective)
                else:
                    ok = agree(res, plain_res)
                    rmse = line["rmse_px"]
                    if abs(rmse - RMSE[name]) > 0.01 * RMSE[name]:
                        raise AssertionError(f"{tag}: rmse {rmse} not "
                                             f"within 1% of {RMSE[name]}")
                if not ok:
                    raise AssertionError(f"{tag}: kernel route {line} and "
                                         f"plain route disagree")
                if res.status_name() == "exception":
                    raise AssertionError(f"{tag}: ended in an exception")
    finally:
        normal.CAM_SCATTER = default
    return lines


def check_polish(problem, launches_total, card):
    """Phase 9: the cascade POLISH once at Dubrovnik-356 on route A; its
    bfloat16 and float32 stages' launches checked as in ``check_cascade``,
    its float64 stage on the plain route with no launch, its rmse on the
    anchor. Returns the lines."""
    import torch
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.benchmark.precision import (
        precision_cascade)
    from bundleadjustment_jl_tpu_torch.ops import normal

    name = "dubrovnik356"
    route = normal.kernel_route(problem)
    calls = []
    with recorded_solves(calls):
        rows = precision_cascade(problem, POLISH, **bench.SOLVE_OPTS)
    lines = []
    for i, stage in enumerate(POLISH):
        res, counts, w_counts, dt = calls[i]
        tag = f"{name}_polish_{stage}"
        if dt == torch.float64:
            if any(counts.values()) or normal.solve_stages(dt) is not \
                    normal.PLAIN:
                raise AssertionError(f"{tag}: launched {counts}")
        else:
            check_launches(tag, res, counts, w_counts, route, None, work=dt)
            for k, v in counts.items():
                launches_total[k] += v
        line = stage_line(tag, rows[i], calls[i], problem, card,
                          route="plain" if dt == torch.float64 else route,
                          value=rows[i]["elapsed_s"], unit="s")
        print(json.dumps(line))
        lines.append(line)
    rmse = lines[-1]["rmse_px"]
    if rows[-1]["status"] not in SOLVED or abs(rmse - RMSE[name]) > \
            0.01 * RMSE[name] or rows[-1]["cams"].dtype != torch.float64:
        raise AssertionError(f"{name}: the float64 polish ended "
                             f"{rows[-1]['status']}, rmse {rmse}")
    return lines


def check_facto_module(problem, facto_ref, launches_total, card):
    """Phase 9: ``facto_solve`` at Dubrovnik-356 (route A) with W in
    bfloat16 and float16: its W bytes half the float32 W's, its status and
    iterations those of phase 7's route-A solve with the same W (the
    kernels sum in a fixed order, so the same solve), its launches checked.
    Returns the rows."""
    import torch
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.benchmark.precision import facto_solve
    from bundleadjustment_jl_tpu_torch.ops import normal

    name = "dubrovnik356"
    route = normal.kernel_route(problem)
    out = []
    for dt in NARROW:
        calls = []
        with recorded_solves(calls):
            row = facto_solve(problem, dt, **bench.SOLVE_OPTS)
        res, counts, w_counts, _ = calls[0]
        check_launches(f"{name} facto_solve {dt}", res, counts, w_counts,
                       route, getattr(torch, dt))
        for k, v in counts.items():
            launches_total[k] += v
        ref = facto_ref[dt]
        row = dict(row, card=card, route=route,
                   launches={k: v for k, v in counts.items() if v},
                   phase7=[ref.status_name(), ref.iterations])
        print(json.dumps(row))
        out.append(row)
        if row["facto_bytes"] * 2 != row["facto_bytes_full"]:
            raise AssertionError(f"facto_solve {dt}: W bytes {row}")
        if (row["status"], row["iterations"]) != (ref.status_name(),
                                                  ref.iterations):
            raise AssertionError(f"facto_solve {dt}: {row['status']} / "
                                 f"{row['iterations']}, phase 7's route-A "
                                 f"solve {ref.status_name()} / "
                                 f"{ref.iterations}")
    return out


def make_f64(name):
    """``(problem, build s)``: problem ``name`` as the default constructor
    builds it (float64, on the card) from bench.py's seed 0 and options."""
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
    t0 = time.perf_counter()
    problem = synthetic_bal(**bench.PROBLEMS[name], noise_px=1.0,
                            perturb=2e-2, seed=0, pad_obs_to=512)[0]
    return problem, time.perf_counter() - t0


def check_f64_anchors(solves, dub_f64, final_f32, final64, card):
    """Phase 9: the float64 anchor record, |obj_f32 - obj_f64| / obj_f64
    at LadyBug-49, Dubrovnik-356 (phase 3's float64 solve) and Final-4585
    (``final64``: ``make_f64(FINAL)``): the float32 solve of the default
    route (phases 3 and 4) against one float64 solve of the problem the
    default constructor builds from the same seed (on the card, the plain
    route: no launch). Returns the record."""
    import torch
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.ops import _cuda

    record = {"dubrovnik356": dict(route="fused", f32=dub_f64["f32_objective"],
                                   f64=dub_f64["objective"],
                                   f64_s=dub_f64["value"])}
    for name, f32_res, route, built in (
            ("ladybug49", solves["ladybug49"][True], "fused",
             make_f64("ladybug49")),
            (FINAL, final_f32["scatter_split"], "scatter_split", final64)):
        problem, build_s = built
        if problem.dtype != torch.float64 or not problem.cams.is_cuda:
            raise AssertionError(f"{name}: built {problem.dtype}")
        _cuda.reset_launches()
        secs, res = bench.timed_solve(problem)
        counts = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        if counts or res.status_name() not in SOLVED:
            raise AssertionError(f"{name}: the float64 solve ended "
                                 f"{res.status_name()}, launched {counts}")
        record[name] = dict(route=route, f32=f32_res.objective,
                            f64=res.objective, f64_s=secs, build_s=build_s,
                            f64_status=res.status_name(),
                            f64_iterations=res.iterations)
        del problem, res, built
    for name, r in record.items():
        r["rel_gap"] = abs(r["f32"] - r["f64"]) / r["f64"]
    print(json.dumps({"metric": "f64_anchor", "record": record,
                      "card": card}))
    return record


def run_cli(args):
    """``python -m bundleadjustment_jl_tpu_torch`` with ``args`` from the
    checkout's root, as a process of its own (started, not waited for)."""
    import subprocess
    return subprocess.Popen([sys.executable, "-m", PKG, *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def check_parser(card):
    """Phase 9: the native parser's ``.so`` built from
    ``csrc/bal_parser.cpp`` into the package's ``_build/``, the fixture
    parsed by it and by the numpy reader: the arrays identical."""
    import numpy as np
    from bundleadjustment_jl_tpu_torch.io import bal, native

    t0 = time.perf_counter()
    so = native.build()
    native.lib()
    build_s = time.perf_counter() - t0
    if so.parent != ROOT / PKG / "_build":
        raise AssertionError(f"the parser was built at {so}")
    fixture = str(ROOT / FIXTURE)
    t0 = time.perf_counter()
    a = native.parse_bal_native(fixture)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = bal._read_raw(fixture)
    numpy_s = time.perf_counter() - t0
    same = all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))
    print(json.dumps({"metric": "bal_parser", "so": str(so),
                      "build_s": build_s, "native_s": native_s,
                      "numpy_s": numpy_s, "identical": same,
                      "libbz2": native.NATIVE_BZ2, "card": card}))
    if not same:
        raise AssertionError("the native and numpy parsers disagree")


def start_cli(tmp):
    """Phase 9: the CLI as processes on the card, all started at once:
    the fixture with ``--json`` and ``--save`` (into the directory
    ``tmp``), and LadyBug-49 (``synthetic:``) with ``--dtype bf16`` and
    with ``--driver host``. Returns what ``check_cli`` reads."""
    saved = str(Path(tmp) / "refined.txt.bz2")
    cases = {"fixture": [FIXTURE, "--json", "--save", saved],
             "ladybug49_bf16": [LADYBUG_SPEC, "--dtype", "bf16", "--json"],
             "ladybug49_host": [LADYBUG_SPEC, "--driver", "host", "--json"]}
    return dict(saved=saved, cases=cases, t0=time.perf_counter(),
                procs={k: run_cli(v) for k, v in cases.items()})


def check_cli(started, card):
    """Phase 9: the processes of ``start_cli``, waited for. Each prints the
    JSON stats keys of the JAX CLI with ``backend`` cuda; the fixture and
    the host solves end solved; the saved solution reads back with the
    printed objective. Returns the lines."""
    import torch
    from bundleadjustment_jl_tpu_torch.io import bal
    from bundleadjustment_jl_tpu_torch.ops.fused_assemble import (
        _objective_plain)

    cases, saved = started["cases"], started["saved"]
    outs = {k: p.communicate(timeout=600) + (p.returncode,)
            for k, p in started["procs"].items()}
    wall = time.perf_counter() - started["t0"]
    lines = []
    for k, (out, err, rc) in outs.items():
        if not out.strip():
            raise AssertionError(f"cli {k}: rc {rc}, no output:\n{err}")
        stats = json.loads(out.strip().splitlines()[-1])
        line = {"metric": f"cli_{k}", "args": cases[k], "rc": rc,
                "stats": stats, "card": card}
        print(json.dumps(line))
        lines.append(line)
        solved = stats["status"] in SOLVED
        if set(stats) != CLI_KEYS or stats["backend"] != "cuda" or \
                rc != (0 if solved else 1):
            raise AssertionError(f"cli {k}: {line}\n{err}")
        if stats["status"] == "exception" or (
                k != "ladybug49_bf16" and not solved):
            raise AssertionError(f"cli {k}: ended {stats['status']}")
    if lines[1]["stats"]["dtype"] != "bf16":
        raise AssertionError("cli: --dtype bf16 not taken")
    back = bal.read_bal(saved, dtype=torch.float64, device="cuda")
    obj = float(_objective_plain(back, back.cams[None],
                                 back.points[None])[0])
    ref = lines[0]["stats"]["objective"]
    print(json.dumps({"metric": "cli_saved_readback", "objective": obj,
                      "printed_objective": ref, "processes_wall_s": wall,
                      "card": card}))
    if abs(obj - ref) > 1e-4 * ref:
        raise AssertionError(f"cli --save: read back objective {obj}, "
                             f"printed {ref}")
    return lines


def check_runner(launches_total, card):
    """Phase 9: ``run_campaign`` with the one-shot (chunked, which times
    itself) and the host-stepped PCG solvers over
    ``synthetic_suite(max_nobs=50_000)`` in float32 on the card
    (LadyBug-49 and LadyBug-73, route A), its Markdown table and the time
    profile (no plot: ``out_path`` None). Every run solved, route A's
    kernels launched. Returns the rows."""
    import torch
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.benchmark import problems, runner
    from bundleadjustment_jl_tpu_torch.ops import _cuda
    from bundleadjustment_jl_tpu_torch.solver import (
        LMOptions, levenberg_marquardt)
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
        levenberg_marquardt_jit_chunked)

    solvers = {
        "jit_pcg": lambda p: levenberg_marquardt_jit_chunked(
            p, **bench.SOLVE_OPTS),
        "host_pcg": lambda p: levenberg_marquardt(
            p, LMOptions(solver="pcg", **bench.SOLVE_OPTS)),
    }
    _cuda.reset_launches()
    rows = runner.run_campaign(
        solvers, problems.synthetic_suite(max_nobs=50_000,
                                          dtype=torch.float32),
        logger=lambda s: None)
    counts = dict(_cuda.LAUNCHES)
    for k, v in counts.items():
        launches_total[k] += v
    print(runner.markdown_table(rows))
    taus, profile = runner.performance_profile(rows)
    print(json.dumps({"metric": "campaign", "rows": rows, "card": card,
                      "profile_at_tau_1": {k: float(v[0])
                                           for k, v in profile.items()},
                      "launches": {k: v for k, v in counts.items() if v}}))
    if len(rows) != 4 or any(r["status"] not in SOLVED for r in rows):
        raise AssertionError(f"campaign: {[r['status'] for r in rows]}")
    missing = [k for k in ("assemble", "cam_reduce", "matvec", "objective")
               if counts[k] == 0]
    if missing:
        raise AssertionError(f"campaign: kernels {missing} never launched")
    return rows


def check_bench(launches_total):
    """Phase 10: the bench leg, once; its launches counted from 0 and every
    kernel of its route and the probe launched. Returns its line."""
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.ops import _cuda
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import expected_launches

    _cuda.reset_launches()
    line = bench.bench_line()
    counts = dict(_cuda.LAUNCHES)
    print(json.dumps(line))
    need = [k for k, v in expected_launches(line["route"], 1, 0, 0).items()
            if v] + ["stream_probe"]
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"bench: kernels {missing} never launched")
    for k, v in counts.items():
        launches_total[k] += v
    for tag, anchor in (("", RMSE["dubrovnik356"]),
                        ("ladybug49_", RMSE["ladybug49"]),
                        ("bf16facto_", RMSE["dubrovnik356"]),
                        ("f16facto_", RMSE["dubrovnik356"])):
        if line[f"{tag}status"] == "exception" or abs(
                line[f"{tag}rmse_px"] - anchor) > 0.01 * anchor:
            raise AssertionError(f"bench: {tag}status / rmse "
                                 f"{line[tag + 'status']} "
                                 f"{line[tag + 'rmse_px']}")
    return line


def kernel_table(launches, schur_launches, errs, timings,
                 facts) -> list[dict]:
    """One row per kernel. ``launches``: the main paths' launches (the
    solves and the bench leg). ``ms``: one launch of each of the kernel's
    forms (its counters) summed, on Dubrovnik-356, then LadyBug-49 and
    Final-4585 (where every form was timed there); each form's own times
    beside it where it has several. ``bound_ms``: the same forms' least
    time on the card at those shapes (``bench.bound_ms``: bytes over
    3.35 TB/s or operations over 67 TFLOP/s, the larger). ``narrow``: the
    W forms' times with W in bfloat16 and float16, each beside its bound.
    A form that only the Schur check launches (SCHUR_CHECK_ONLY) carries
    that check's launches apart."""
    from bundleadjustment_jl_tpu_torch import bench

    shapes = {k: bench.shape(k) for k in (*PROBLEMS, FINAL)}
    table = []
    for k, (src, replaces, counters, err_keys) in KERNELS.items():
        row = {"name": k, "route": "cuda", "source": f"{PKG}/{src}",
               "replaces": replaces,
               "launches": sum(launches[c] for c in counters),
               "max_abs_err": max(errs[e] for e in err_keys)}
        side = [c for c in counters if c in SCHUR_CHECK_ONLY]
        if side:
            row["schur_check_only_launches"] = {
                c: schur_launches[c] for c in side}
        for prob, tag in (("dubrovnik356", ""), ("ladybug49", "_ladybug49"),
                          (FINAL, f"_{FINAL}")):
            if not all(prob in timings.get(c, {}) for c in counters):
                continue
            parts = {c: timings[c][prob] for c in counters}
            bounds = {c: bench.bound_ms(c, shapes[prob]) for c in counters}
            row["ms" + tag] = sum(kms for kms, _ in parts.values())
            row["plain_ms" + tag] = sum(pms for _, pms in parts.values())
            row["bound_ms" + tag] = sum(b for b, _ in bounds.values())
            row["bound_by" + tag] = max(bounds.values())[1]
            lib = timings.get("library", {}).get(prob) if k == \
                "stream_probe" else None
            row["library_ms" + tag] = lib
            if len(parts) > 1:
                row["parts" + tag] = {
                    c: {"ms": kms, "plain_ms": pms, "bound_ms": bounds[c][0]}
                    for c, (kms, pms) in parts.items()}
        narrow = {}
        for c in counters:
            for dt in NARROW:
                for prob, (kms, pms) in timings.get(f"{c}@{dt}", {}).items():
                    narrow.setdefault(c, {}).setdefault(dt, {})[prob] = {
                        "ms": kms, "plain_ms": pms,
                        "bound_ms": bench.bound_ms(c, shapes[prob], 2)[0]}
        if narrow:
            row["narrow"] = narrow
        row.update(facts.get(k, {}))
        table.append(row)
    return table


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.ops import _cuda

    wall0 = time.perf_counter()
    card = bench.card()["nvidia_smi"]
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}")
    print(f"card: {card}")
    t0 = time.perf_counter()
    so_path = _cuda.build()
    _cuda.lib()
    print(f"[build] {so_path} in {time.perf_counter() - t0:.1f} s")
    for ln in (so_path.parent / "build.log").read_text().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print("  " + ln.strip())

    errs, timings, facts, probe = {}, {}, {}, {}
    for name in PROBLEMS:
        problem = bench.make_problem(name, 0)
        plan_times(name, problem, facts)
        check_kernels(name, problem, errs, timings, facts)
        check_sorted_kernels(name, problem, errs, timings, facts)
        check_split_kernels(name, problem, errs, timings, facts)
        check_narrow(name, problem, errs, timings, facts)
        del problem
    print("[probe] K9 vs plain and torch.sum")
    check_probe(errs, timings, probe)

    launches = dict.fromkeys(_cuda.LAUNCHES, 0)
    solves = {name: check_solves(name, launches) for name in PROBLEMS}
    f64 = check_f64_solve(solves["dubrovnik356"][True])

    t0 = time.perf_counter()
    final = bench.make_problem(FINAL, 0)
    torch.cuda.synchronize()
    print(f"[{FINAL}] built in {time.perf_counter() - t0:.1f} s: nobs "
          f"{final.nobs}, nobs_pad {final.nobs_pad}")
    plan_times(FINAL, final, facts)
    check_kernels(FINAL, final, errs, timings, facts)
    check_sorted_kernels(FINAL, final, errs, timings, facts)
    check_split_kernels(FINAL, final, errs, timings, facts)
    check_narrow(FINAL, final, errs, timings, facts, final=True)
    final_f32 = check_final_solves(final, launches)
    schur_launches = check_final_schur(FINAL, final, errs)
    facto_ref = check_facto_solves(final, launches)
    del final
    print("[drivers] chunked, host-stepped; power, dense and CGLS steps")
    chunked = check_chunked(bench.make_problem("dubrovnik356", 0), launches)
    drivers = check_solvers(solves, launches, card)
    print("[precision] cascade, float64 polish, facto_solve, f64 anchors")
    steps = {}

    def step(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        steps[name] = time.perf_counter() - t
        return out
    dub = [bench.make_problem("dubrovnik356", seed) for seed in (0, 1)]
    precision = {
        "cascade": step("cascade", check_cascade, *dub, launches, card),
        "polish": step("polish", check_polish, dub[0], launches, card),
        "facto_solve": step("facto_solve", check_facto_module, dub[0],
                            facto_ref, launches, card)}
    del dub
    print("[surface] BAL parser, CLI, campaign runner")
    step("parser", check_parser, card)
    with tempfile.TemporaryDirectory(dir=ROOT / PKG / "_build") as tmp:
        # The CLI processes run while this one builds Final-4585 in
        # float64 (host work), and end before its float64 solve.
        started = start_cli(tmp)
        try:
            final64 = step("final64_build", make_f64, FINAL)
            surface = {"cli": step("cli_wait", check_cli, started, card)}
        finally:
            for proc in started["procs"].values():
                if proc.poll() is None:
                    proc.kill()
    precision["f64_anchor"] = step("f64_anchor", check_f64_anchors, solves,
                                   f64, final_f32, final64, card)
    del final64
    surface["campaign"] = step("campaign", check_runner, launches, card)
    print(json.dumps({"phase9_s": steps}))
    check_bench(launches)
    for k, v in launches.items():
        if v == 0 and k not in SCHUR_CHECK_ONLY:
            raise AssertionError(f"kernel {k} never launched on the path")
    for k in SCHUR_CHECK_ONLY:
        if schur_launches[k] == 0:
            raise AssertionError(f"kernel {k} never launched by the Schur "
                                 f"check")

    print(f"[wall] {time.perf_counter() - wall0:.1f} s")
    print(json.dumps({"probe": probe, "f64_solve": f64, "chunked": chunked,
                      "drivers": drivers,
                      "f64_anchor": precision["f64_anchor"],
                      "cli": [ln["stats"] for ln in surface["cli"]]}))
    print(json.dumps({"kernels": kernel_table(launches, schur_launches, errs,
                                              timings, facts)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
