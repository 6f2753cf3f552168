"""Command-line driver: solve one BA problem (PyTorch port of
`bundleadjustment_jl_tpu/cli.py`, with its flags, its ``--json`` stats
line and its ``--save`` / ``--verbose`` output).

Usage:
    python -m bundleadjustment_jl_tpu_torch <problem.txt[.bz2]> [options]
    python -m bundleadjustment_jl_tpu_torch synthetic:ncams=49,npnts=7776 [...]

It runs on the card (``--device cuda``, the default) unless ``--device
cpu`` asks for the CPU. The working dtype defaults to float32 on the card
and float64 on the CPU, as the JAX CLI picks it by backend; ``--dtype
bf16`` solves in bfloat16. ``--pallas`` / ``--no-pallas`` and
``--cam-scatter`` / ``--no-cam-scatter`` set `ops/normal.py`'s
``PALLAS_MODE`` and ``CAM_SCATTER`` (both on by default: the kernels, on
the camera-scatter routes). The multi-device options (``--driver spmd``,
``--mesh``, ``--multihost``) are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# The multi-device options and the title of their item in ROADMAP.md's
# queue A.
MULTI_GPU_ITEM = "Multi-GPU, last: the target is one H100"
DTYPES = {"f32": "float32", "f64": "float64", "bf16": "bfloat16"}
FACTO_DTYPES = {"bf16": "bfloat16", "f16": "float16"}
SOLVED = ("first_order", "small_residual", "small_step", "small_obj_change")


def _parse_synthetic(spec: str) -> dict:
    """synthetic:ncams=49,npnts=7776,obs_per_pnt=4,noise_px=0.5,seed=0"""
    out = {}
    body = spec.split(":", 1)[1] if ":" in spec else ""
    for kv in filter(None, body.split(",")):
        k, v = kv.split("=")
        out[k] = float(v) if "." in v or "e" in v.lower() else int(v)
    return out


def build_parser() -> argparse.ArgumentParser:
    from bundleadjustment_jl_tpu_torch.ops import normal
    p = argparse.ArgumentParser(
        prog="bundleadjustment_jl_tpu_torch",
        description="Bundle adjustment of BAL problems on an NVIDIA GPU")
    p.add_argument("problem",
                   help="BAL .txt/.txt.bz2 path or 'synthetic:k=v,...'")
    p.add_argument("--solver", choices=["pcg", "dense", "cgls", "power"],
                   default="pcg",
                   help="linear-step solver: Schur+PCG (default), dense "
                        "Schur Cholesky, damped CGLS on J, or the power "
                        "series")
    p.add_argument("--driver", choices=["host", "jit", "chunked", "spmd"],
                   default="jit",
                   help="host-stepped loop (rich logging), the one-shot "
                        "driver, or the chunked one (max-time and "
                        "checkpoints); spmd is not ported yet")
    p.add_argument("--chunk-iters", type=int, default=25,
                   help="iterations per chunk (chunked driver)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="rotating step-<n>.npz checkpoints (host/chunked)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint before solving")
    p.add_argument("--facto-dtype", choices=sorted(FACTO_DTYPES),
                   default=None,
                   help="store W in this dtype inside the full-precision "
                        "LM (jit/chunked drivers)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                   help="working precision (default: f32 on cuda, f64 on "
                        "cpu)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the problem and the solve live")
    p.add_argument("--max-iters", type=int, default=200)
    p.add_argument("--max-time", type=float, default=3600.0,
                   help="host and chunked drivers")
    p.add_argument("--linesearch", action="store_true",
                   help="step-halving linesearch")
    p.add_argument("--pcg-max-iters", type=int, default=100)
    p.add_argument("--pcg-rtol", type=float, default=None,
                   help="fixed PCG tolerance (default: adaptive forcing)")
    p.add_argument("--lam0", type=float, default=None)
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="shard over N devices (not ported yet)")
    p.add_argument("--pallas", action=argparse.BooleanOptionalAction,
                   default=normal.PALLAS_MODE,
                   help="the CUDA kernels (default) or the plain route")
    p.add_argument("--cam-scatter", action=argparse.BooleanOptionalAction,
                   default=normal.CAM_SCATTER,
                   help="camera sums over the point-sorted rows (routes A, "
                        "B1; default) or over camera-sorted copies (C, B2)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process solve (not ported yet)")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line instead of the stats block")
    p.add_argument("--save", default=None, metavar="PATH",
                   help="write the refined problem as a BAL file")
    return p


def _multi_gpu(option: str):
    raise NotImplementedError(
        f"{option} is not ported yet (ROADMAP.md, queue A: {MULTI_GPU_ITEM})")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.driver == "spmd":
        _multi_gpu("--driver spmd")
    if args.mesh:
        _multi_gpu("--mesh")
    if args.multihost:
        _multi_gpu("--multihost")

    import numpy as np
    import torch

    from bundleadjustment_jl_tpu_torch.io.bal import read_bal, write_bal
    from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
    from bundleadjustment_jl_tpu_torch.ops import normal

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(ask for the CPU with --device cpu)")
    dtype_name = args.dtype or ("f64" if args.device == "cpu" else "f32")
    dtype = DTYPES[dtype_name]
    normal.PALLAS_MODE = args.pallas
    normal.CAM_SCATTER = args.cam_scatter

    t0 = time.perf_counter()
    if args.problem.startswith("synthetic"):
        problem, _ = synthetic_bal(dtype=dtype, device=args.device,
                                   **_parse_synthetic(args.problem))
    else:
        problem = read_bal(args.problem, dtype=dtype, device=args.device)
    load_s = time.perf_counter() - t0
    if args.verbose:
        print(f"# {problem.name}: ncams={problem.ncams} "
              f"npnts={problem.npnts} nobs={problem.nobs} "
              f"nvar={problem.nvar} nequ={problem.nequ} "
              f"[{args.device}/{dtype_name}, route "
              f"{normal.kernel_route(problem)}, load {load_s:.2f}s]")

    facto_dtype = (getattr(torch, FACTO_DTYPES[args.facto_dtype])
                   if args.facto_dtype else None)
    t0 = time.perf_counter()
    if args.driver == "host":
        from bundleadjustment_jl_tpu_torch.solver.lm import (
            LMOptions, levenberg_marquardt)
        res = levenberg_marquardt(problem, LMOptions(
            max_iters=args.max_iters, max_time=args.max_time,
            solver=args.solver, linesearch=args.linesearch,
            pcg_max_iters=args.pcg_max_iters, pcg_rtol=args.pcg_rtol,
            lam0=args.lam0, verbose=args.verbose,
            checkpoint_dir=args.checkpoint_dir, resume=args.resume))
        status, obj = res.status, res.objective
        iters, dual = res.iterations, res.dual_feas
    else:
        from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
            STATUS_NAMES, levenberg_marquardt_jit,
            levenberg_marquardt_jit_chunked)
        kw = dict(max_iters=args.max_iters, lam0=args.lam0,
                  pcg_rtol=args.pcg_rtol, pcg_max_iters=args.pcg_max_iters,
                  use_dense=args.solver == "dense",
                  use_cgls=args.solver == "cgls",
                  use_power=args.solver == "power",
                  linesearch=args.linesearch, facto_dtype=facto_dtype)
        if args.driver == "chunked":
            res = levenberg_marquardt_jit_chunked(
                problem, chunk_iters=args.chunk_iters,
                max_time=args.max_time, checkpoint_dir=args.checkpoint_dir,
                resume=args.resume, **kw)
        else:
            res = levenberg_marquardt_jit(problem, **kw)
        status = STATUS_NAMES[int(res.status)]
        obj, iters = float(res.objective), int(res.iterations)
        dual = float(res.dual_feas)
        if args.verbose:
            print(f"{'iter':>5} {'obj':>14} {'|J.r|':>11} {'lambda':>9} "
                  f"{'cg':>4}")
            for i in range(iters):
                print(f"{i:5d} {float(res.hist_obj[i]):14.6e} "
                      f"{float(res.hist_gnorm[i]):11.4e} "
                      f"{float(res.hist_lam[i]):9.2e} "
                      f"{int(np.asarray(res.hist_cg)[i]):4d}")
    elapsed = time.perf_counter() - t0

    rmse = (2.0 * obj / max(problem.nequ, 1)) ** 0.5
    stats = {
        "problem": problem.name, "status": status, "objective": obj,
        "rmse_px": rmse, "iterations": iters, "elapsed_s": elapsed,
        "dual_feas": dual, "solver": args.solver, "driver": args.driver,
        "dtype": dtype_name, "backend": args.device,
    }
    if args.json:
        print(json.dumps(stats))
    else:
        print(f"status:      {status}")
        print(f"objective:   {obj:.6e}   (rmse {rmse:.4f} px)")
        print(f"dual_feas:   {dual:.4e}")
        print(f"iterations:  {iters}")
        print(f"elapsed:     {elapsed:.2f} s")

    if args.save:
        write_bal(args.save, problem.with_state(res.cams, res.points))
        if args.verbose:
            print(f"# wrote {args.save}")
    return 0 if status in SOLVED else 1


if __name__ == "__main__":
    sys.exit(main())
