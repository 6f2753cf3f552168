"""Device time of each CUDA kernel that K1 (the assembly), K2 (its four
forms), K3, K4 (the trial objectives), K5's camera direction, K6's point
product and W C W', and K8 launch, by kernel name, on one card.

    python -m bundleadjustment_jl_tpu_torch.kernel_profile \
        [--problems dubrovnik356,final4585] [--kernels all|camera]

At synthetic Dubrovnik-356 and Final-4585 (``bench.make_problem``; the
capacity sizes of ``capacity.py``, e.g. ``final13682``, by name): K1 with
W in float32; K4 at S = 1 and S = 5 trial states (:data:`SCALES`: a solve
without and with its line search, ``ls_max`` 4); K6's point product over
K7's JR; K5's camera direction and K6's W C W' over the camera-sorted W,
and K8 writing it, in float32, bfloat16 and float16; K2's cam90 over K7's
JR and its W forms and K3 over K7's W in float32, bfloat16 and float16,
with the path each took (``fused_schur.cam_path``; ``--kernels camera``:
these alone); each called :data:`REPS` times under ``torch.profiler``
after a warm-up. Prints one JSON line per problem with, per call, the
device ms per call of each kernel it launched (the trace's kernel events,
:func:`kernel_sums`), and the card's name and power limit.
A wrapper's passes are separate kernels, so this times them apart: K1's
point pass and its camera pass, K4's row pass and sums, the range and
run-sum passes, K2's and K3's block pass and block sums or record writes
and record sums. These are device times with the L2 as the previous call
left it; ``chip_smoke.py``'s ``time_pair`` times a window of calls with
CUDA events, host gaps between launches included.

To compare two trees, run it from the root of each checkout and compare
the JSON lines; it uses only the wrappers' public calls, so a copy of this
file in an older tree's package times that tree too. A run that finds no
card raises.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from pathlib import Path

import torch

from bundleadjustment_jl_tpu_torch import bench
from bundleadjustment_jl_tpu_torch.ops import _cuda

REPS = 10
# Profiled windows a call may take: a trace can hold no kernel event at all
# (seen once in a sweep on an H100), and then the window is taken again.
TRACE_TRIES = 3
# K4's trial states a call: the solver's scales 1, 1/2, ... (lm_jit).
SCALES = (1, 5)


def kernel_sums(trace_path: Path) -> dict:
    """``{kernel name: {"ms": device ms, "launches": n}}`` summed over the
    kernel events of the Chrome trace at ``trace_path``, the most ms first.
    Raises ``ValueError`` when the trace holds no kernel event."""
    by_name = defaultdict(lambda: [0.0, 0])
    for e in json.loads(Path(trace_path).read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            by_name[e["name"]][0] += e["dur"] / 1e3
            by_name[e["name"]][1] += 1
    if not by_name:
        raise ValueError(f"{trace_path}: no kernel event")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {k: {"ms": ms, "launches": n} for k, (ms, n) in top}


def device_ms(fn, tag: str, reps: int = REPS) -> dict:
    """``{kernel name: device ms per call}`` of ``fn()`` over ``reps``
    calls under ``torch.profiler``, after two unprofiled calls; the trace
    goes to the git-ignored kernel build directory as ``<tag>.json``. The
    trace can miss a kernel's events (often the window's first launch: 9
    of 10 recorded), so a kernel's time a call is its mean over the
    launches recorded times its launches a call, ceil(recorded / reps).
    A window whose trace holds no kernel event is taken again, up to
    :data:`TRACE_TRIES` windows."""
    from torch.profiler import ProfilerActivity, profile
    bench.require_card()
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = _cuda.BUILD_DIR / "kernel_profile"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{tag}.json"
    for attempt in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        try:
            kernels = kernel_sums(path)
            break
        except ValueError:      # the trace holds no kernel event
            if attempt == TRACE_TRIES - 1:
                raise
    return {name: k["ms"] / k["launches"] * -(-k["launches"] // reps)
            for name, k in kernels.items()}


def trial_states(cams, points, S: int, seed: int = 0):
    """``(cams_all, pts_all)``: the state ``(cams, points)`` plus scales
    1, 1/2, ... of a random step (1e-3 a coordinate, from ``seed``), as
    the solver forms its S trial states."""
    dev = cams.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    dc = 1e-3 * torch.randn(cams.shape, generator=gen, device=dev)
    dpt = 1e-3 * torch.randn(points.shape, generator=gen, device=dev)
    sc = 0.5 ** torch.arange(S, dtype=cams.dtype, device=dev)
    return ((cams[None] + sc[:, None, None] * dc[None]).contiguous(),
            (points[None] + sc[:, None, None] * dpt[None]).contiguous())


def make(name: str):
    """Problem ``name`` on the card: ``bench.make_problem`` (seed 0), or a
    capacity size of ``capacity.py`` by its name."""
    from bundleadjustment_jl_tpu_torch import capacity
    if name in bench.PROBLEMS:
        return bench.make_problem(name, 0)
    return capacity.make(name)[0]


def camera_pass(name: str, p) -> dict:
    """K2's four forms and K3 on ``p``: cam90 over K7's JR (and re-derived
    in camera order, ``cam_relin_cam90``), the W forms and K3 over K7's W
    in each storage dtype (and W C W' | W t re-derived in camera order,
    ``cam_relin_wcw_rhs``), device ms by kernel and
    the path (``fused_schur.cam_path``) of each."""
    from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
    from bundleadjustment_jl_tpu_torch.ops import linearize as lz
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
    from bundleadjustment_jl_tpu_torch.ops.normal import inv3x3_damped_flat
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
        f16_scale, narrow_w)
    # A tree older than fused_schur.cam_path (copied in to compare two
    # trees in one call) has one path: None.
    cam_path = getattr(fs, "cam_path", lambda form, p, code: None)
    JR_t, W = lz.linearize_w_kminor(p, p.cams, p.points)
    line = {"cam_reduce_cam90": device_ms(
        lambda: fs.cam_reduce_cam90(JR_t, p), f"{name}_cam_reduce_cam90"),
        "cam_relin_cam90": device_ms(
            lambda: fs.cam_relin_cam90(p, p.cams, p.points),
            f"{name}_cam_relin_cam90")}
    paths = {"cam_reduce_cam90": cam_path("cam90", p, 0)}
    hp12 = sr.jtj_pnt_reduce(JR_t, p)
    del JR_t
    hpp = inv3x3_damped_flat(hp12[:, :9].reshape(-1),
                             1e-3 * float(hp12[:, :9:4].max()))
    del hp12
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = torch.randn((p.npnts, 3), generator=gen, device="cuda")
    v = torch.randn((p.ncams, 9), generator=gen, device="cuda")
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        tag = str(dt)[6:]
        Wd = narrow_w(W, dt)
        code = _cuda.W_CODES[dt]
        for key, form, fn in (
                ("cam_reduce", "wcw_rhs",
                 lambda: fs.cam_reduce_wcw_rhs(Wd, p, hpp, t)),
                ("cam_reduce_w_op", "w_op",
                 lambda: fs.cam_reduce_w_op(Wd, p, t)),
                ("cam_reduce_wcw81", "wcw",
                 lambda: fs.cam_reduce_wcw(Wd, p, hpp)),
                ("matvec", "matvec",
                 lambda: fs.matvec_cam_scatter(Wd, v, p, hpp))):
            line[f"{key}@{tag}"] = device_ms(fn, f"{name}_{key}_{tag}")
            paths[f"{key}@{tag}"] = cam_path(form, p, code)
        del Wd
        s = f16_scale(W) if dt == torch.float16 else None
        line[f"cam_relin_wcw_rhs@{tag}"] = device_ms(
            lambda: fs.cam_relin_wcw_rhs(p, p.cams, p.points, hpp, t, dt, s),
            f"{name}_cam_relin_wcw_rhs_{tag}")
    line["paths"] = paths
    return line


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--problems", default="dubrovnik356,final4585")
    ap.add_argument("--kernels", choices=("all", "camera"), default="all")
    args = ap.parse_args(argv)
    from bundleadjustment_jl_tpu_torch.ops import fused_assemble as fa
    from bundleadjustment_jl_tpu_torch.ops import linearize as lz
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
    from bundleadjustment_jl_tpu_torch.ops.normal import inv3x3_damped_flat
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import narrow_w
    bench.require_card()
    card = bench.card()["nvidia_smi"]
    for name in args.problems.split(","):
        p = make(name)
        if args.kernels == "camera":
            line = {"problem": name, "card": card, **camera_pass(name, p)}
            print(json.dumps(line), flush=True)
            del p
            continue
        W = fa.assemble_scatter(p, p.cams, p.points)[0]
        line = {"problem": name, "card": card,
                "assemble@float32": device_ms(
                    lambda: fa.assemble_scatter(p, p.cams, p.points),
                    f"{name}_assemble")}
        for S in SCALES:
            cams_all, pts_all = trial_states(p.cams, p.points, S)
            line[f"objective@S{S}"] = device_ms(
                lambda: fa.objective_scatter(p, cams_all, pts_all),
                f"{name}_objective_S{S}")
            del cams_all, pts_all
        JR_t = lz.linearize_w_kminor(p, p.cams, p.points)[0]
        line["seg_prod_pnt12"] = device_ms(
            lambda: sr.jtj_pnt_reduce(JR_t, p), f"{name}_seg_prod_pnt12")
        hp12 = sr.jtj_pnt_reduce(JR_t, p)
        del JR_t
        hpp_inv = inv3x3_damped_flat(hp12[:, :9].reshape(-1),
                                     1e-3 * float(hp12[:, :9:4].max()))
        gen = torch.Generator(device="cuda").manual_seed(0)
        t = torch.randn((p.npnts, 3), generator=gen, device="cuda")
        perm = p.cam_perm.long()
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            tag = str(dt)[6:]
            W_cam = narrow_w(W, dt)[:, perm].contiguous()
            line[f"seg_block_camera@{tag}"] = device_ms(
                lambda: sr.wt_cam_reduce(W_cam, t, p),
                f"{name}_seg_block_camera_{tag}")
            line[f"seg_prod_wcw81@{tag}"] = device_ms(
                lambda: sr.wcw_cam_reduce(W_cam, p, hpp_inv),
                f"{name}_seg_prod_wcw81_{tag}")
            del W_cam
            line[f"linearize_w_only@{tag}"] = device_ms(
                lambda: lz.linearize_w_only(p, p.cams, p.points, dt),
                f"{name}_linearize_w_only_{tag}")
        del W
        line.update(camera_pass(name, p))
        print(json.dumps(line), flush=True)
        del p, hp12, hpp_inv
    return 0


if __name__ == "__main__":
    sys.exit(main())
