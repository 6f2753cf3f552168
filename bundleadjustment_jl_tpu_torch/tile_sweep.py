"""Time K2's camera pass and K3 at several tile sizes, stage depths and
block counts, K5's camera direction and K6's W C W' at several column
ranges, K4 at several row blocks and K6's point product at several chunks,
on one card: the measurements behind ``csrc/cam_pass.cuh:BA_TILE_ROWS`` and
``BA_STAGES``, ``ops/plans.py:CAM_BLOCKS``, ``ops/plans.py:CAM_BLOCK_COLS``,
``ops/plans.py:WCW_BLOCK_COLS`` with ``csrc/seg_prod_reduce.cu:BA_WCW_COLS``,
``csrc/objective.cu:BA_OBJ_ROWS`` and
``csrc/seg_prod_reduce.cu:BA_PNT12_ROWS_PER_THREAD``.

    python -m bundleadjustment_jl_tpu_torch.tile_sweep \
        [--sweep tiles|cam_cols|wcw|objective|pnt12] [--problems a,b]

Without ``--sweep`` all run. A constant of the CUDA sources is swept by
building a copy of ``csrc/`` with that constant changed under the
git-ignored ``_build/tile_sweep/`` and loading it in place of the
package's kernels (``ops/_cuda.py``'s ``CSRC`` and ``BUILD_DIR`` pointed at
the copy); a plan size is swept by setting it in ``ops/plans.py`` and
dropping the problem's plan (the kernels take it at run time). The
package's sources are not changed. Each sweep's first setting comes again
last, to show the run-to-run spread.

- ``tiles``: for each (C, S, S9, G, B) of :data:`TILE_ORDER`,
  ``BA_TILE_ROWS = C``, ``BA_STAGES = S``, ``BA_STAGES_K9 = S9`` and
  ``TILE_ROWS = C``, ``CAM_BLOCKS = G``, ``BLOCKS_PER_SM = {9: B}``: the
  plan's build time, tiles and runs, and the
  device ms (``kernel_profile.device_ms``, by kernel, summed) of K2's four
  forms and K3, W in float32 and bfloat16, with the path and blocks each
  took, at
  synthetic Dubrovnik-356, Venice-1778, Final-4585 and Final-13682
  (:data:`TILE_PROBLEMS`; ``kernel_profile.make``). A setting whose stages
  pass the card's shared memory is recorded as refused.
- ``cam_cols``: K5's camera direction over the camera-sorted W in
  float32, bfloat16 and float16 at each C of :data:`COLS_ORDER`.
- ``wcw``: K6's W C W' over the camera-sorted W in float32, bfloat16 and
  float16, at each (``BA_WCW_COLS``, ``WCW_BLOCK_COLS``) of
  :data:`WCW_ORDER`, also at the card tests' ``many_cameras`` and
  ``empty_cameras_ragged`` shapes (:data:`EDGE_SHAPES`).
- ``objective``: K4 at S = 1 and 5 trial states at each
  ``BA_OBJ_ROWS`` of :data:`OBJ_ORDER` (``csrc/objective.cu``).
- ``pnt12``: K6's point product at each ``BA_PNT12_ROWS_PER_THREAD`` of
  :data:`PNT12_ORDER` (``csrc/seg_prod_reduce.cu``).

``cam_cols`` and ``wcw`` time with CUDA events, L2 flushed before each
launch (``utils/timing.timed``, host enqueue included, 10-15% spread run
to run); the others time the card alone: each kernel's device ms under
``torch.profiler`` (``kernel_profile.device_ms``), summed over the
wrapper's kernels.

Prints one line per (problem, setting, form) and, last, all of it as one
JSON object. A run that finds no card raises.
"""

from __future__ import annotations

import json
import re
import shutil
import time

import numpy as np
import torch

from bundleadjustment_jl_tpu_torch import bench

# (BA_TILE_ROWS, BA_STAGES, BA_STAGES_K9, CAM_BLOCKS, BLOCKS_PER_SM of the
# 9-sum forms): rows a tile at most, tiles in flight a block (45- and
# 54-sum forms; W op and K3), blocks a wave, blocks an SM holds at most
TILE_ORDER = ((512, 2, 1, 132, 4), (512, 2, 2, 132, 4), (256, 2, 1, 132, 4),
              (256, 2, 2, 132, 4), (512, 2, 1, 132, 2), (512, 2, 1, 132, 4))
TILE_PROBLEMS = ("dubrovnik356", "venice1778", "final4585", "final13682")
COLS_ORDER = (2048, 1024, 4096, 8192, 2048)
# (BA_WCW_COLS, WCW_BLOCK_COLS): columns a lane, columns a range
WCW_ORDER = ((2, 512), (2, 256), (2, 1024), (2, 2048), (4, 512), (2, 512))
# BA_OBJ_ROWS: K4's rows a block
OBJ_ORDER = (1024, 256, 512, 2048, 4096, 1024)
# BA_PNT12_ROWS_PER_THREAD: K6 pnt12's chunk, 256 threads of this many rows
PNT12_ORDER = (5, 4, 3, 5)
REPS = 10
W_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def use_constants(source: str, **values: int) -> None:
    """Build and load the kernels with ``constexpr int <name> = value;`` in
    ``csrc/<source>`` for each of ``values``, the other sources as the
    package has them."""
    from bundleadjustment_jl_tpu_torch.ops import _cuda
    tag = "_".join(f"{k}{v}" for k, v in sorted(values.items()))
    root = _cuda._PKG / "_build" / "tile_sweep" / tag
    src = root / "csrc"
    if not src.exists():
        shutil.copytree(_cuda._PKG / "csrc", src)
        head = src / source
        text = head.read_text()
        for name, value in values.items():
            text, count = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {value};", text)
            if count != 1:
                raise RuntimeError(f"{name} not found in {source}")
        head.write_text(text)
    _cuda.CSRC, _cuda.BUILD_DIR = src, root / "_build"
    _cuda.lib.cache_clear()
    _cuda.cam_pass_bytes.cache_clear()
    _cuda.lib()


def edge_problem(case: str):
    """The card tests' ``many_cameras`` (700 cameras of a few rows each,
    more than a K2 tile has rows) and ``empty_cameras_ragged`` (cameras
    without rows, 1203 rows) shapes (``tests/test_torch_cuda.py``), f32 on
    the card, from seed 7."""
    from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
    rng = np.random.default_rng(7)
    if case == "many_cameras":
        ncams, npnts, pad = 700, 400, 512
        pnt = np.repeat(np.arange(npnts), 5)
        cam = rng.integers(0, ncams, size=pnt.size)
    else:
        ncams, npnts, pad = 50, 401, 1
        pnt = np.repeat(np.arange(npnts), 3)
        cam = rng.integers(10, ncams, size=pnt.size)
    return BAProblem.from_arrays(
        rng.standard_normal((ncams, 9)), rng.standard_normal((npnts, 3)),
        cam, pnt, rng.standard_normal((pnt.size, 2)), dtype=torch.float32,
        pad_obs_to=pad, device="cuda")


EDGE_SHAPES = ("many_cameras", "empty_cameras_ragged")


def sweep(problems=TILE_PROBLEMS) -> dict:
    """K2's four forms and K3 at each (C, S, S9, G, B) of
    :data:`TILE_ORDER` on each of ``problems``."""
    bench.require_card()
    from bundleadjustment_jl_tpu_torch.kernel_profile import device_ms, make
    from bundleadjustment_jl_tpu_torch.ops import _cuda
    from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
    from bundleadjustment_jl_tpu_torch.ops import linearize as lz
    from bundleadjustment_jl_tpu_torch.ops import plans
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
    from bundleadjustment_jl_tpu_torch.ops.normal import inv3x3_damped_flat

    defaults = (plans.TILE_ROWS, plans.CAM_BLOCKS, plans.BLOCKS_PER_SM)
    out = {"device": bench.card(), "lines": []}
    try:
        for name in problems:
            p = make(name)
            JR_t, W32 = lz.linearize_w_kminor(p, p.cams, p.points)
            hp12 = sr.jtj_pnt_reduce(JR_t, p)
            hpp = inv3x3_damped_flat(hp12[:, :9].reshape(-1),
                                     1e-3 * float(hp12[:, :9:4].max()))
            del hp12
            gen = torch.Generator(device="cuda").manual_seed(0)
            t = torch.randn((p.npnts, 3), generator=gen, device="cuda")
            v = torch.randn((p.ncams, 9), generator=gen, device="cuda")
            Ws = {"float32": W32, "bfloat16": W32.to(torch.bfloat16)}
            forms = {"cam_reduce_cam90": (
                "cam90", 0, lambda: fs.cam_reduce_cam90(JR_t, p), 4)}
            for dt, W in Ws.items():
                code, size = _cuda.W_CODES[W.dtype], W.element_size()
                forms.update({
                    f"cam_reduce_w_op@{dt}": (
                        "w_op", code,
                        lambda W=W: fs.cam_reduce_w_op(W, p, t), size),
                    f"cam_reduce@{dt}": (
                        "wcw_rhs", code,
                        lambda W=W: fs.cam_reduce_wcw_rhs(W, p, hpp, t),
                        size),
                    f"cam_reduce_wcw81@{dt}": (
                        "wcw", code, lambda W=W: fs.cam_reduce_wcw(W, p, hpp),
                        size),
                    f"matvec@{dt}": (
                        "matvec", code,
                        lambda W=W: fs.matvec_cam_scatter(W, v, p, hpp),
                        size)})
            for rows, stages, stages9, blocks, per_sm in TILE_ORDER:
                use_constants("cam_pass.cuh", BA_TILE_ROWS=rows,
                              BA_STAGES=stages, BA_STAGES_K9=stages9)
                plans.TILE_ROWS, plans.CAM_BLOCKS = rows, blocks
                plans.BLOCKS_PER_SM = {9: per_sm}
                for key in ("tiles", "records"):
                    p.plans.pop(key, None)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plan = plans.tile_plan(p)
                torch.cuda.synchronize()
                build_ms = 1e3 * (time.perf_counter() - t0)
                for form, (kind, code, fn, size) in forms.items():
                    key = form.split("@")[0]
                    bound = bench.bound_ms(key, p, size)[0]
                    line = {"problem": name, "rows": rows, "stages": stages,
                            "stages_k9": stages9, "blocks": blocks,
                            "per_sm": per_sm,
                            "form": form,
                            "path": fs.cam_path(kind, p, code),
                            "bound_ms": bound, "ntiles": plan.ntiles,
                            "nruns": plan.nruns, "runs_per_row":
                            plan.nruns / p.nobs_pad,
                            "plan_build_ms": build_ms}
                    try:
                        by_name = device_ms(
                            fn, f"tiles_{name}_{rows}_{stages}_{stages9}_"
                            f"{blocks}_{per_sm}_{form.replace('@', '_')}")
                    except RuntimeError as e:   # stages past the card's
                        line["refused"] = str(e).splitlines()[0]
                        out["lines"].append(line)
                        print(f"{name:13s} C {rows:5d} S {stages} {stages9} "
                              f"G {blocks:4d} B {per_sm} {form:24s} refused",
                              flush=True)
                        continue
                    ms = sum(by_name.values())
                    line.update(ms=ms, kernels=by_name)
                    out["lines"].append(line)
                    print(f"{name:13s} C {rows:5d} S {stages} {stages9} G "
                          f"{blocks:4d} B {per_sm} {form:24s} "
                          f"{line['path'][0]:7s} "
                          f"{line['path'][1]:4d} {ms:9.4f} ms  "
                          f"bound {bound:.4f} ({bound / ms:.3f})  tiles "
                          f"{plan.ntiles}  runs/row "
                          f"{line['runs_per_row']:.3f}  plan "
                          f"{build_ms:.1f} ms", flush=True)
            del p, JR_t, W32, Ws, forms
            torch.cuda.empty_cache()
    finally:
        plans.TILE_ROWS, plans.CAM_BLOCKS, plans.BLOCKS_PER_SM = defaults
    return out


def sweep_cam_cols() -> dict:
    bench.require_card()
    from bundleadjustment_jl_tpu_torch.ops import linearize as lz
    from bundleadjustment_jl_tpu_torch.ops import plans
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import narrow_w
    from bundleadjustment_jl_tpu_torch.utils.timing import timed

    default = plans.CAM_BLOCK_COLS
    out = {"device": bench.card(), "lines": []}
    try:
        for name in ("dubrovnik356", "final4585"):
            p = bench.make_problem(name, 0)
            W = lz.linearize_w_only(p, p.cams, p.points)
            gen = torch.Generator(device="cuda").manual_seed(0)
            t = torch.randn((p.npnts, 3), generator=gen, device="cuda")
            Ws = {str(dt)[6:]: narrow_w(W, dt) for dt in
                  (torch.float32, torch.bfloat16, torch.float16)}
            for cols in COLS_ORDER:
                plans.CAM_BLOCK_COLS = cols
                p.plans.pop("cam_cols", None)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plan = plans.cam_col_plan(p)
                torch.cuda.synchronize()
                build_ms = 1e3 * (time.perf_counter() - t0)
                for dt, Wc in Ws.items():
                    size = Wc.element_size()
                    ms = timed(sr.wt_cam_reduce, (Wc, t, p), reps=REPS,
                               flush_l2=True).ms
                    bound = bench.bound_ms("seg_block_camera", p,
                                           size)[0]
                    line = {"problem": name, "cols": cols,
                            "form": f"seg_block_camera@{dt}", "ms": ms,
                            "bound_ms": bound, "nruns": plan.nruns,
                            "nranges": plan.nranges,
                            "plan_build_ms": build_ms}
                    out["lines"].append(line)
                    print(f"{name:13s} C {cols:5d} "
                          f"{line['form']:26s} {ms:9.4f} ms  bound "
                          f"{bound:.4f} ({bound / ms:.3f})  runs "
                          f"{plan.nruns}  plan {build_ms:.1f} ms",
                          flush=True)
            del p, W, Ws
    finally:
        plans.CAM_BLOCK_COLS = default
    return out


def wcw_operands(p):
    """Camera-sorted W in each of :data:`W_DTYPES` and a damped Hpp_inv
    for K6's W C W' on ``p``: the problem's own at its state for the
    synthetic problems, random ones (from seed 8) at the edge shapes."""
    from bundleadjustment_jl_tpu_torch.ops import linearize as lz
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
    from bundleadjustment_jl_tpu_torch.ops.normal import inv3x3_damped_flat
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import narrow_w
    if p.nobs_pad > 1 << 16:
        JR_t, W = lz.linearize_w_kminor(p, p.cams, p.points)
        hp12 = sr.jtj_pnt_reduce(JR_t, p)
        hpp = inv3x3_damped_flat(hp12[:, :9].reshape(-1),
                                 1e-3 * float(hp12[:, :9:4].max()))
    else:
        gen = torch.Generator(device="cuda").manual_seed(8)
        W = torch.randn((27, p.nobs_pad), generator=gen, device="cuda")
        A = torch.randn((p.npnts, 3, 3), generator=gen, device="cuda")
        hpp = (A @ A.transpose(1, 2) + torch.eye(3, device="cuda")).reshape(
            -1).contiguous()
    perm = p.cam_perm.long()
    return ({str(dt)[6:]: narrow_w(W, dt)[:, perm].contiguous()
             for dt in W_DTYPES}, hpp)


def sweep_wcw() -> dict:
    """K6's W C W' at each (columns a lane, columns a range) of
    :data:`WCW_ORDER`."""
    bench.require_card()
    from bundleadjustment_jl_tpu_torch.ops import plans
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
    from bundleadjustment_jl_tpu_torch.utils.timing import timed

    default = plans.WCW_BLOCK_COLS
    out = {"device": bench.card(), "lines": []}
    problems = {name: bench.make_problem(name, 0)
                for name in ("dubrovnik356", "final4585")}
    problems.update({name: edge_problem(name) for name in EDGE_SHAPES})
    ops = {name: wcw_operands(p) for name, p in problems.items()}
    try:
        for lane_cols, cols in WCW_ORDER:
            use_constants("seg_prod_reduce.cu", BA_WCW_COLS=lane_cols)
            plans.WCW_BLOCK_COLS = cols
            for name, p in problems.items():
                p.plans.pop("wcw_cols", None)
                plan = plans.wcw_col_plan(p)
                Ws, hpp = ops[name]
                for dt, Wc in Ws.items():
                    ms = timed(sr.wcw_cam_reduce, (Wc, p, hpp), reps=REPS,
                               flush_l2=True).ms
                    bound = bench.bound_ms("seg_prod_wcw81", p,
                                           Wc.element_size())[0]
                    line = {"problem": name, "lane_cols": lane_cols,
                            "cols": cols,
                            "form": f"seg_prod_wcw81@{dt}", "ms": ms,
                            "bound_ms": bound, "nruns": plan.nruns,
                            "nranges": plan.nranges}
                    out["lines"].append(line)
                    print(f"{name:20s} V {lane_cols} C {cols:5d} "
                          f"{line['form']:24s} {ms:9.4f} ms  bound "
                          f"{bound:.4f} ({bound / ms:.3f})  runs "
                          f"{plan.nruns}", flush=True)
    finally:
        plans.WCW_BLOCK_COLS = default
    return out


def sweep_device_ms(source: str, name: str, order, forms) -> dict:
    """For each value of ``order`` of ``source``'s constant ``name``, the
    device ms a call of each form of ``forms(problems)`` (``{(problem,
    form): (fn, bound ms)}``), by kernel (``kernel_profile.device_ms``)
    and summed, at synthetic Dubrovnik-356 and Final-4585."""
    bench.require_card()
    from bundleadjustment_jl_tpu_torch.kernel_profile import device_ms

    out = {"device": bench.card(), "lines": []}
    calls = forms({name: bench.make_problem(name, 0)
                   for name in ("dubrovnik356", "final4585")})
    for value in order:
        use_constants(source, **{name: value})
        for (prob, form), (fn, bound) in calls.items():
            by_name = device_ms(fn, f"sweep_{prob}_{form}")
            ms = sum(by_name.values())
            out["lines"].append({"problem": prob, name: value, "form": form,
                                 "ms": ms, "bound_ms": bound,
                                 "kernels": by_name})
            print(f"{prob:13s} {name} {value:5d} {form:16s} {ms:9.4f} ms  "
                  f"bound {bound:.4f} ({bound / ms:.3f})  "
                  f"{[round(v, 4) for v in by_name.values()]}", flush=True)
    return out


def sweep_objective() -> dict:
    """K4 at S = 1 and 5 (``kernel_profile.SCALES``) at each setting of
    :data:`OBJ_ORDER`."""
    from bundleadjustment_jl_tpu_torch.kernel_profile import (
        SCALES, trial_states)
    from bundleadjustment_jl_tpu_torch.ops import fused_assemble as fa

    def forms(problems):
        calls = {}
        for name, p in problems.items():
            for S in SCALES:
                cams_all, pts_all = trial_states(p.cams, p.points, S)
                calls[name, f"objective@S{S}"] = (
                    lambda p=p, c=cams_all, x=pts_all:
                    fa.objective_scatter(p, c, x),
                    bench.bound_ms("objective", p, scales=S)[0])
        return calls
    return sweep_device_ms("objective.cu", "BA_OBJ_ROWS", OBJ_ORDER, forms)


def sweep_pnt12() -> dict:
    """K6's point product over K7's JR at each rows a thread of its point
    walk's chunk (``BA_PNT12_ROWS_PER_THREAD``) of :data:`PNT12_ORDER`."""
    from bundleadjustment_jl_tpu_torch.ops import linearize as lz
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr

    def forms(problems):
        calls = {}
        for name, p in problems.items():
            JR_t = lz.linearize_w_kminor(p, p.cams, p.points)[0]
            calls[name, "seg_prod_pnt12"] = (
                lambda p=p, JR_t=JR_t: sr.jtj_pnt_reduce(JR_t, p),
                bench.bound_ms("seg_prod_pnt12", p)[0])
        return calls
    return sweep_device_ms("seg_prod_reduce.cu", "BA_PNT12_ROWS_PER_THREAD",
                           PNT12_ORDER, forms)


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", choices=("tiles", "cam_cols", "wcw",
                                        "objective", "pnt12"))
    ap.add_argument("--problems", default=",".join(TILE_PROBLEMS),
                    help="the tiles sweep's problems")
    args = ap.parse_args()
    which = args.sweep
    outs = {}
    if which in (None, "cam_cols"):
        outs["cam_cols"] = sweep_cam_cols()
    if which in (None, "wcw"):
        outs["wcw"] = sweep_wcw()
    if which in (None, "tiles"):
        outs["tiles"] = sweep(args.problems.split(","))
    if which in (None, "objective"):
        outs["objective"] = sweep_objective()
    if which in (None, "pnt12"):
        outs["pnt12"] = sweep_pnt12()
    card = next(iter(outs.values()))["device"]["nvidia_smi"]
    print(f"card: {card}")
    print(json.dumps(outs))


if __name__ == "__main__":
    main()
