"""Smoke run of the PyTorch port (`bundleadjustment_jl_tpu_torch`) on one
CUDA card.

    python3 chip_smoke.py

1. Prints the torch / CUDA versions and the card (``nvidia-smi``), builds
   the four CUDA kernels from ``bundleadjustment_jl_tpu_torch/csrc`` and
   prints the build time and the compiler's register report.
2. Checks each kernel against its plain PyTorch version on the card, at
   the shapes of synthetic LadyBug-49 and Dubrovnik-356 (as ``bench.py``
   builds them), and times both in turns (plain, kernel, kernel, plain).
3. Solves both problems with ``levenberg_marquardt_jit`` and
   ``bench.py``'s options: a warm-up, five timed solves on the kernel
   route (launch counts reset before each and checked against its
   iterations, accepts and CG steps after it), and a solve on the plain
   route. Checks that both routes agree and that the rmse lands on the
   data-fixed anchors.
4. Prints the kernel table as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero before the last
line. It needs a CUDA card and the repository checkout beside it; it
imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "bundleadjustment_jl_tpu_torch"

# bench.py's problems (synthetic, seed 0, f32) and the solver-level anchors
# the data fixes: rmse at the solution.
PROBLEMS = {
    "ladybug49": dict(ncams=49, npnts=7776, obs_per_pnt=4, rmse=0.7849),
    "dubrovnik356": dict(ncams=356, npnts=226730, obs_per_pnt=6,
                         rmse=0.8648),
}
REPEATS = 5          # timed kernel-route solves per problem; median kept
SOLVE_OPTS = dict(max_iters=100, pcg_max_iters=100, lam0_mode="diag",
                  satol=0.0, srtol=0.0, atol=0.0, rtol=1e-5, oatol=0.0,
                  ortol=1e-4)
# Kernel vs plain, |kernel - plain| <= rtol |plain| + afrac max|plain|:
# summation order differs (blocks, FMA contraction), nothing else.
TOL = {"W": (1e-5, 1e-6), "hp12": (1e-4, 1e-3), "hc90": (1e-4, 1e-3),
       "obj": (1e-5, 0.0), "cam_reduce": (1e-4, 1e-4),
       "matvec": (1e-4, 1e-4), "objective": (1e-5, 0.0)}
KERNELS = {
    "assemble": ("csrc/assemble.cu",
                 "bundleadjustment_jl_tpu/ops/pallas_assemble.py:284"),
    "cam_reduce": ("csrc/cam_reduce.cu",
                   "bundleadjustment_jl_tpu/ops/pallas_schur.py:1109"),
    "matvec": ("csrc/matvec.cu",
               "bundleadjustment_jl_tpu/ops/pallas_schur.py:1550"),
    "objective": ("csrc/objective.cu",
                  "bundleadjustment_jl_tpu/ops/pallas_assemble.py:484"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def time_pair(kernel, plain, reps):
    """Median ms per call of ``kernel`` and ``plain``, timed in turns
    (plain, kernel, kernel, plain) with CUDA events over ``reps`` calls."""
    import torch
    times = {"kernel": [], "plain": []}
    fns = {"kernel": kernel, "plain": plain}
    kernel(), plain()
    for _ in range(3):
        for which in ("plain", "kernel", "kernel", "plain"):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[which]()
            stop.record()
            torch.cuda.synchronize()
            times[which].append(start.elapsed_time(stop) / reps)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    return med["kernel"], med["plain"]


def check_kernels(name, problem, errs, timings):
    """Phase 2 for one problem: every kernel against its plain version."""
    import torch
    from bundleadjustment_jl_tpu_torch.ops import fused_assemble as fa
    from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
    from bundleadjustment_jl_tpu_torch.ops.normal import inv3x3_damped_flat

    print(f"[kernels] {name}: nobs_pad {problem.nobs_pad}, ncams "
          f"{problem.ncams}, npnts {problem.npnts}")
    cams, points = problem.cams, problem.points
    gen = torch.Generator(device="cuda").manual_seed(0)
    reps = 20 if problem.nobs_pad < 1 << 18 else 5

    W_t, hp12, hc90, obj = fa.assemble_scatter(problem, cams, points)
    torch.cuda.synchronize()
    pW, php, phc, pobj = fa._assemble_plain(problem, cams, points)
    compare("W", W_t, pW, errs)
    compare("hp12", hp12, php, errs)
    compare("hc90", hc90, phc, errs)
    compare("obj", obj.reshape(1), pobj.reshape(1), errs)
    timings.setdefault("assemble", {})[name] = time_pair(
        lambda: fa.assemble_scatter(problem, cams, points),
        lambda: fa._assemble_plain(problem, cams, points), reps)

    # Damped point blocks as the solver forms them (lambda_0, "diag").
    lam = 1e-3 * float(torch.maximum(hc90[:, :81:10].max(),
                                     hp12[:, :9:4].max()))
    hpp_inv = inv3x3_damped_flat(hp12[:, :9].reshape(-1), lam)
    g_p = hp12[:, 9:12].contiguous()
    t = torch.einsum("pab,pb->pa", hpp_inv.reshape(-1, 3, 3), g_p)
    out = fs.cam_reduce_wcw_rhs(W_t, problem, hpp_inv, t)
    torch.cuda.synchronize()
    compare("cam_reduce", out,
            fs._cam_reduce_wcw_rhs_plain(W_t, problem, hpp_inv, t), errs)
    timings.setdefault("cam_reduce", {})[name] = time_pair(
        lambda: fs.cam_reduce_wcw_rhs(W_t, problem, hpp_inv, t),
        lambda: fs._cam_reduce_wcw_rhs_plain(W_t, problem, hpp_inv, t),
        reps)

    v = torch.randn((problem.ncams, 9), generator=gen, device="cuda")
    out = fs.matvec_cam_scatter(W_t, v, problem, hpp_inv)
    torch.cuda.synchronize()
    compare("matvec", out,
            fs._matvec_plain(W_t, v, problem, hpp_inv, None, 1.0)[0], errs)
    gp_f = g_p.reshape(-1)
    out, dp = fs.matvec_cam_scatter(W_t, v, problem, hpp_inv, gp_f=gp_f,
                                    sign=-1.0, with_dp=True)
    torch.cuda.synchronize()
    pout, pdp = fs._matvec_plain(W_t, v, problem, hpp_inv, gp_f, -1.0)
    compare("matvec", out, pout, errs)
    compare("matvec", dp, pdp, errs)
    timings.setdefault("matvec", {})[name] = time_pair(
        lambda: fs.matvec_cam_scatter(W_t, v, problem, hpp_inv),
        lambda: fs._matvec_plain(W_t, v, problem, hpp_inv, None, 1.0), reps)

    dc = 1e-3 * torch.randn(cams.shape, generator=gen, device="cuda")
    dpt = 1e-3 * torch.randn(points.shape, generator=gen, device="cuda")
    scales = torch.tensor([1.0, 0.5, 0.25], device="cuda")
    cams_all = (cams[None] + scales[:, None, None] * dc[None]).contiguous()
    pts_all = (points[None] + scales[:, None, None] * dpt[None]).contiguous()
    got = fa.objective_scatter(problem, cams_all, pts_all)
    torch.cuda.synchronize()
    compare("objective", got, fa._objective_plain(problem, cams_all, pts_all),
            errs)
    timings.setdefault("objective", {})[name] = time_pair(
        lambda: fa.objective_scatter(problem, cams_all[:1], pts_all[:1]),
        lambda: fa._objective_plain(problem, cams_all[:1], pts_all[:1]),
        reps)
    for k, per in timings.items():
        kms, pms = per[name]
        print(f"  time {k:10s} kernel {kms:.4f} ms  plain {pms:.4f} ms")


@contextlib.contextmanager
def plain_route():
    """Point the solver's four kernel call sites at the plain versions,
    so a solve on CUDA tensors runs the plain PyTorch route."""
    from bundleadjustment_jl_tpu_torch.ops import fused_assemble as fa
    from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
    from bundleadjustment_jl_tpu_torch.ops import normal, schur
    from bundleadjustment_jl_tpu_torch.solver import lm_jit

    def matvec_plain(W_t, v, problem, hpp_inv_f, gp_f=None, sign=1.0,
                     with_dp=False):
        out, t = fs._matvec_plain(W_t, v, problem, hpp_inv_f, gp_f, sign)
        return (out, t) if with_dp else out

    sites = [(normal, "assemble_scatter", fa._assemble_plain),
             (schur, "cam_reduce_wcw_rhs", fs._cam_reduce_wcw_rhs_plain),
             (schur, "matvec_cam_scatter", matvec_plain),
             (lm_jit, "objective_scatter", fa._objective_plain)]
    saved = [getattr(mod, attr) for mod, attr, _ in sites]
    try:
        for mod, attr, fn in sites:
            setattr(mod, attr, fn)
        yield
    finally:
        for (mod, attr, _), fn in zip(sites, saved):
            setattr(mod, attr, fn)


def solve(problem):
    import torch
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
        levenberg_marquardt_jit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = levenberg_marquardt_jit(problem, **SOLVE_OPTS)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def check_launches(name, res, counts):
    """Each kernel launched as often as the solve's own record implies:
    K1 at init and per accept, K2 and K4 once per iteration, K3 once per
    CG step plus the initial residual and the back-substitution."""
    it = res.iterations
    expect = {"assemble": 1 + res.naccepts, "cam_reduce": it,
              "matvec": int(res.hist_cg[:it].sum()) + 2 * it,
              "objective": it}
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts} != {expect}")


def check_solves(name, spec, launches_total):
    """Phase 3 for one problem."""
    import torch
    from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
    from bundleadjustment_jl_tpu_torch.ops import _cuda

    def make(seed):
        return synthetic_bal(
            ncams=spec["ncams"], npnts=spec["npnts"],
            obs_per_pnt=spec["obs_per_pnt"], noise_px=1.0, perturb=2e-2,
            seed=seed, dtype=torch.float32, pad_obs_to=512,
            device="cuda")[0]

    solve(make(1))                                    # warm-up
    problem = make(0)
    times = []
    for _ in range(REPEATS):
        _cuda.reset_launches()
        secs, res = solve(problem)
        counts = dict(_cuda.LAUNCHES)
        times.append(secs)
        check_launches(name, res, counts)
        for k, v in counts.items():
            launches_total[k] += v
    secs = sorted(times)[len(times) // 2]
    with plain_route():
        _cuda.reset_launches()
        plain_secs, plain = solve(problem)
        plain_counts = dict(_cuda.LAUNCHES)

    it, cg = res.iterations, int(res.hist_cg[:res.iterations].sum())
    nequ = 2 * problem.nobs
    rmse = (2.0 * res.objective / nequ) ** 0.5
    line = {
        "metric": f"{name}_synth_lm_solve", "value": secs, "unit": "s",
        "values": times,
        "status": res.status_name(), "iterations": it, "cg_matvecs": cg,
        "per_iter_ms": 1e3 * secs / max(it, 1),
        "objective": res.objective, "rmse_px": rmse,
        "naccepts": res.naccepts, "launches": counts,
        "plain_value": plain_secs, "plain_status": plain.status_name(),
        "plain_iterations": plain.iterations,
        "plain_objective": plain.objective,
    }
    print(json.dumps(line))

    if any(plain_counts.values()):
        raise AssertionError(f"{name}: plain route launched {plain_counts}")
    if not (torch.isfinite(res.cams).all() and torch.isfinite(
            res.points).all()) or res.cams.shape != problem.cams.shape \
            or res.points.shape != problem.points.shape:
        raise AssertionError(f"{name}: bad solution state")
    if res.status_name() != plain.status_name() \
            or abs(it - plain.iterations) > 1 \
            or abs(res.objective - plain.objective) > 1e-4 * plain.objective:
        raise AssertionError(f"{name}: kernel and plain routes disagree")
    if abs(rmse - spec["rmse"]) > 0.01 * spec["rmse"]:
        raise AssertionError(f"{name}: rmse {rmse} not within 1% of "
                             f"{spec['rmse']}")


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
    from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
    from bundleadjustment_jl_tpu_torch.ops import _cuda

    card = card_line()
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

    errs, timings = {}, {}
    for name, spec in PROBLEMS.items():
        problem = synthetic_bal(
            ncams=spec["ncams"], npnts=spec["npnts"],
            obs_per_pnt=spec["obs_per_pnt"], noise_px=1.0, perturb=2e-2,
            seed=0, dtype=torch.float32, pad_obs_to=512, device="cuda")[0]
        check_kernels(name, problem, errs, timings)
        del problem

    launches = dict.fromkeys(_cuda.LAUNCHES, 0)
    for name, spec in PROBLEMS.items():
        check_solves(name, spec, launches)
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} never launched on the path")

    main_err = {"assemble": "W", "cam_reduce": "cam_reduce",
                "matvec": "matvec", "objective": "objective"}
    table = []
    for k, (src, replaces) in KERNELS.items():
        kms, pms = timings[k]["dubrovnik356"]
        lkms, lpms = timings[k]["ladybug49"]
        table.append({"name": k, "route": "cuda", "source": f"{PKG}/{src}",
                      "replaces": replaces, "launches": launches[k],
                      "max_abs_err": errs[main_err[k]], "ms": kms,
                      "plain_ms": pms, "ms_ladybug49": lkms,
                      "plain_ms_ladybug49": lpms})
    print(json.dumps({"kernels": table}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
