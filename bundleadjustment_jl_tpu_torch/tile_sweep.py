"""Time K2's tiled camera reduce and K3 at several tile sizes, and K5's
camera direction at several column ranges, on one card: the measurements
behind ``csrc/cam_prod.cuh:BA_TILE_ROWS`` and
``ops/plans.py:CAM_BLOCK_COLS``.

    python -m bundleadjustment_jl_tpu_torch.tile_sweep [--sweep tiles|cam_cols]

Without ``--sweep`` both run. Column ranges (``cam_cols``): for each C
of :data:`COLS_ORDER` (2048 first and last, for the spread)
``plans.CAM_BLOCK_COLS = C`` and the problem's K5 plan rebuilt (the kernel
takes C at run time), then K5's camera direction timed over the
camera-sorted W in float32, bfloat16 and float16 at synthetic
Dubrovnik-356 and Final-4585, as below. Tile sizes (``tiles``):

For each tile size R of :data:`ORDER` (1024 first and last, to show the
run-to-run spread), a copy of ``csrc/`` with ``BA_TILE_ROWS = R`` is built
under the git-ignored ``_build/tile_sweep/`` and loaded in place of the
package's kernels (``ops/_cuda.py``'s ``CSRC`` and ``BUILD_DIR`` pointed
at the copy), with ``ops/plans.py:TILE_ROWS = R`` and the problems' plans
dropped. Then, at synthetic Dubrovnik-356 and Final-4585: the plan's build
time and run count, and the time of K2's four forms and K3 (CUDA events,
L2 flushed before each launch: ``utils/timing.timed``), W in float32 and
bfloat16. Prints one line per (problem, R, form) and, last, all of it as
one JSON object. The package's sources are not changed. A run that finds
no card raises.
"""

from __future__ import annotations

import json
import re
import shutil
import time

import torch

from bundleadjustment_jl_tpu_torch import bench

ORDER = (1024, 256, 512, 1024)
COLS_ORDER = (2048, 1024, 4096, 8192, 2048)
REPS = 10


def use_tile_rows(rows: int) -> None:
    """Build and load the kernels with ``BA_TILE_ROWS = rows``."""
    from bundleadjustment_jl_tpu_torch.ops import _cuda, plans
    root = _cuda._PKG / "_build" / "tile_sweep" / f"R{rows}"
    src = root / "csrc"
    if not src.exists():
        shutil.copytree(_cuda._PKG / "csrc", src)
        head = src / "cam_prod.cuh"
        text, count = re.subn(r"constexpr int BA_TILE_ROWS = \d+;",
                              f"constexpr int BA_TILE_ROWS = {rows};",
                              head.read_text())
        if count != 1:
            raise RuntimeError("BA_TILE_ROWS not found in cam_prod.cuh")
        head.write_text(text)
    _cuda.CSRC, _cuda.BUILD_DIR = src, root / "_build"
    _cuda.lib.cache_clear()
    _cuda.lib()
    plans.TILE_ROWS = rows


def sweep() -> dict:
    bench.require_card()
    from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
    from bundleadjustment_jl_tpu_torch.ops import linearize as lz
    from bundleadjustment_jl_tpu_torch.ops import plans
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
    from bundleadjustment_jl_tpu_torch.ops.normal import inv3x3_damped_flat
    from bundleadjustment_jl_tpu_torch.utils.timing import timed

    out = {"device": bench.card(), "lines": []}
    for name in ("dubrovnik356", "final4585"):
        p = bench.make_problem(name, 0)
        JR_t, W32 = lz.linearize_w_kminor(p, p.cams, p.points)
        hp12 = sr.jtj_pnt_reduce(JR_t, p)
        hpp = inv3x3_damped_flat(hp12[:, :9].reshape(-1),
                                 1e-3 * float(hp12[:, :9:4].max()))
        gen = torch.Generator(device="cuda").manual_seed(0)
        t = torch.randn((p.npnts, 3), generator=gen, device="cuda")
        v = torch.randn((p.ncams, 9), generator=gen, device="cuda")
        Ws = {"float32": W32, "bfloat16": W32.to(torch.bfloat16)}
        for rows in ORDER:
            use_tile_rows(rows)
            p.plans.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = plans.tile_plan(p)
            torch.cuda.synchronize()
            build_ms = 1e3 * (time.perf_counter() - t0)
            forms = {"cam_reduce_cam90": (fs.cam_reduce_cam90, (JR_t, p), 4)}
            for dt, W in Ws.items():
                size = W.element_size()
                forms.update({
                    f"cam_reduce_w_op@{dt}": (fs.cam_reduce_w_op, (W, p, t),
                                              size),
                    f"cam_reduce@{dt}": (fs.cam_reduce_wcw_rhs,
                                         (W, p, hpp, t), size),
                    f"cam_reduce_wcw81@{dt}": (fs.cam_reduce_wcw,
                                               (W, p, hpp), size),
                    f"matvec@{dt}": (fs.matvec_cam_scatter, (W, v, p, hpp),
                                     size)})
            for form, (fn, args, size) in forms.items():
                key = form.split("@")[0]
                ms = timed(fn, args, reps=REPS, flush_l2=True).ms
                bound = bench.bound_ms(key, p, size)[0]
                line = {"problem": name, "rows": rows, "form": form,
                        "ms": ms, "bound_ms": bound,
                        "nruns": plan.nruns, "runs_per_row":
                        plan.nruns / p.nobs_pad, "plan_build_ms": build_ms}
                out["lines"].append(line)
                print(f"{name:13s} R {rows:5d} {form:24s} {ms:9.4f} ms  "
                      f"bound {bound:.4f} ({bound / ms:.3f})  runs/row "
                      f"{line['runs_per_row']:.3f}  plan {build_ms:.1f} ms",
                      flush=True)
        del p, JR_t, W32, Ws
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


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", choices=("tiles", "cam_cols"))
    which = ap.parse_args().sweep
    outs = {}
    if which in (None, "cam_cols"):
        outs["cam_cols"] = sweep_cam_cols()
    if which in (None, "tiles"):
        outs["tiles"] = sweep()
    card = next(iter(outs.values()))["device"]["nvidia_smi"]
    print(f"card: {card}")
    print(json.dumps(outs))


if __name__ == "__main__":
    main()
