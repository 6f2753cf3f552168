"""The host-stepped Levenberg-Marquardt driver (PyTorch port of
`bundleadjustment_jl_tpu/solver/lm.py`).

Per-iteration control in Python with the reference's semantics: lambda_0
= max(30, 1e10 / ||J'r_0||) (or ``lam0_mode="diag"``), accept iff ared >=
1e-4 pred, the reference's lambda schedule (or Nielsen's), up to
``ls_max`` sequential step halvings with ``linesearch``, the stopping
tests (small_step, first_order, small_residual, small_obj_change,
max_time) and a log row per iteration (``verbose``, ``callback``, the
result's ``history``). Its scalar arithmetic is the JAX driver's: Python
floats on the host, device values read in the working dtype.

Unlike the JAX host driver, which assembles with XLA, it runs the port's
kernel routes: the route (`ops/normal.py:kernel_route`) and the stage
table (`ops/normal.py:solve_stages`) are picked once per call, so a float32
``pcg`` solve on the card runs K1-K4 on route A; each trial objective is
one K4 launch with one trial state and one host read. A 2-byte working
dtype (bfloat16 or float16) runs as in the one-shot driver: the stages get
float32 vectors and round their results back (`ops/normal.py`), W is
stored in the working dtype, and the tolerances come from its eps.

It takes a mesh shard (`parallel/mesh.py:shard_problem`) as the one-shot
driver does (`solver/lm_jit.py`): every rank runs the loop on its shard
under `ops/spmdctx.py`'s hooks. The stage table all-reduces the camera
sums and the trial objectives (on camera groups the point sums too);
every other scalar the host reads (the gradient norm, g'd, ||d||, ||x||,
the predicted reduction's ||J d||^2, lambda_0's max Hpp, the max-time
test) has its point part all-reduced where the points are the rank's own,
so the ranks take the same decisions. Rank 0 logs (``verbose``) and writes
the checkpoints; the result's points are the global ones on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from bundleadjustment_jl_tpu_torch.models.problem import (
    HALF_DTYPES, BAProblem, torch_dtype)
from bundleadjustment_jl_tpu_torch.ops import spmdctx
from bundleadjustment_jl_tpu_torch.ops.normal import (
    assemble_blocks, gradient_norm, kernel_route, solve_stages)
from bundleadjustment_jl_tpu_torch.ops.pcg import forcing_rtol
from bundleadjustment_jl_tpu_torch.ops.schur import (
    check_dense_feasible, dense_pair_count)
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    SOLVERS, _any_rank, _check_lockstep, _global_points, _local_points,
    _rank0, _ranks, _whole, expected_launches, solve_step)
from bundleadjustment_jl_tpu_torch.utils.checkpoint import CheckpointManager


@dataclasses.dataclass
class LMOptions:
    """Solver options; the JAX package's ``LMOptions``, with its defaults.
    ``None`` tolerances resolve to the reference's defaults in the working
    dtype (:meth:`resolved_tols`): restol / ortol / rtol = eps^(1/3),
    satol / srtol / oatol / atol = sqrt(eps)."""
    max_iters: int = 200
    max_time: float = 3600.0              # seconds
    atol: Optional[float] = None          # first-order absolute
    rtol: Optional[float] = None          # first-order relative
    restol: Optional[float] = None        # small residual
    satol: Optional[float] = None         # small step absolute
    srtol: Optional[float] = None         # small step relative
    oatol: Optional[float] = None         # small obj change absolute
    ortol: Optional[float] = None         # small obj change relative
    lam0: Optional[float] = None          # None -> lam0_mode
    lam0_mode: str = "ref"                # "ref": max(30, 1e10/|J'r0|);
    #                                       "diag": 1e-3 max diag(J'J)
    nu_d: float = 3.0                     # accept decrease factor
    nu_m: float = 3.0                     # reject increase factor
    accept_ratio: float = 1e-4            # ared / pred acceptance
    good_ratio: float = 0.9               # bonus-decrease threshold
    lam_min: float = 1e-8                 # lambda floor
    lam_strategy: str = "ref"             # "ref" or "nielsen"
    linesearch: bool = False              # step halvings on reject
    ls_max: int = 4                       # max halvings
    solver: str = "pcg"                   # one of lm_jit.SOLVERS
    pcg_rtol: Optional[float] = None      # None -> forcing sequence
    pcg_max_iters: int = 100
    pcg_warm: bool = False                # warm-start CG from previous dc
    verbose: bool = False
    checkpoint_dir: Optional[str] = None  # rotate step-<n>.npz checkpoints
    checkpoint_every: int = 10
    resume: bool = False                  # restore latest checkpoint first

    def resolved_tols(self, dtype) -> dict:
        """The seven tolerances as Python floats, ``None`` resolved from
        the eps of ``dtype`` (torch or numpy)."""
        eps = float(torch.finfo(torch_dtype(dtype)).eps)
        cbrt, sqrt = eps ** (1.0 / 3.0), eps ** 0.5
        return {
            "atol": sqrt if self.atol is None else self.atol,
            "rtol": cbrt if self.rtol is None else self.rtol,
            "restol": cbrt if self.restol is None else self.restol,
            "satol": sqrt if self.satol is None else self.satol,
            "srtol": sqrt if self.srtol is None else self.srtol,
            "oatol": sqrt if self.oatol is None else self.oatol,
            "ortol": cbrt if self.ortol is None else self.ortol,
        }


@dataclasses.dataclass
class LMResult:
    """The JAX package's ``LMResult`` (the reference's
    ``GenericExecutionStats``)."""
    status: str                     # first_order | small_step |
    #                                 small_residual | small_obj_change |
    #                                 max_iter | max_time | exception
    objective: float
    iterations: int
    elapsed_time: float
    dual_feas: float                # ||J'r|| at the solution
    cams: torch.Tensor
    points: torch.Tensor
    neval_residual: int = 0
    neval_jac: int = 0
    history: List[dict] = dataclasses.field(default_factory=list)

    @property
    def rmse_px(self) -> float:
        """NaN, as in the JAX package (the result holds no problem)."""
        return float("nan")

    def solved(self) -> bool:
        """The reference's "solved" statuses."""
        return self.status in ("first_order", "small_residual", "small_step",
                               "small_obj_change")


def expected_host_launches(route: str, res: LMResult, solver: str,
                           facto_dtype=None,
                           work_dtype: torch.dtype = torch.float32) -> dict:
    """The kernel launches a :func:`levenberg_marquardt` solve on ``route``
    with ``solver`` makes, from its own counters: the assembly once per
    ``neval_jac``, K4 ``neval_residual - neval_jac`` times (one trial
    state a launch), and per step solve (a history row) the step's
    launches of :func:`lm_jit.expected_launches` with its CG steps and W's
    storage. A ``small_step`` stop and an ``exception`` (a NaN
    step at lambda > 1e20) compute a step that no row records, so it
    raises there."""
    if res.status in ("small_step", "exception"):
        raise ValueError(f"a {res.status} stop's last step is not in the "
                         f"history")
    cg = sum(row["cg_iters"] for row in res.history)
    out = expected_launches(route, len(res.history), res.neval_jac - 1, cg,
                            solver, facto_dtype, work_dtype)
    out["objective"] = res.neval_residual - res.neval_jac
    return out


_LOG_HEADER = (f"{'iter':>5} {'obj':>14} {'‖J′r‖':>11} {'λ':>9} "
               f"{'‖δ‖':>9} {'ρ':>9} {'cg':>4} status")


def levenberg_marquardt(problem: BAProblem,
                        options: Optional[LMOptions] = None,
                        cams=None, points=None,
                        callback: Optional[Callable] = None) -> LMResult:
    """Solve ``min 0.5 ||r(cams, points)||^2`` by Levenberg-Marquardt,
    host-stepped, with the JAX package's decisions; returns an
    :class:`LMResult`. On a mesh shard every rank of its group calls it
    alike; ``points``, when given, and the result's are the global
    (npnts, 3) arrays."""
    with _ranks(problem):
        res = _solve(problem, options or LMOptions(), cams, points, callback)
        res.points = _global_points(problem, res.points)
    return res


def _solve(problem: BAProblem, opts: LMOptions, cams, points,
           callback: Optional[Callable]) -> LMResult:
    """The body of :func:`levenberg_marquardt`, inside the rank group's
    hooks on a mesh shard; returns the rank's own points."""
    cams = problem.cams if cams is None else cams
    points = (problem.points if points is None
              else _local_points(problem, points))
    tols = opts.resolved_tols(problem.dtype)
    if opts.solver not in SOLVERS:
        raise ValueError(f"unknown solver {opts.solver!r}")
    if opts.solver == "dense":
        check_dense_feasible(problem.ncams, problem.npnts, problem.nobs_pad,
                             4 if problem.dtype in HALF_DTYPES
                             else problem.cams.element_size(),
                             dense_pair_count(problem, problem.dtype))
    # Full-precision f32 products on the card (no TF32), as in lm_jit.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    route = kernel_route(_whole(problem))
    stages = solve_stages(problem.dtype, problem)
    _check_lockstep(problem, route, opts.solver)
    with_jr = opts.solver == "cgls"
    verbose = opts.verbose and _rank0(problem)

    def linearize(c, p):
        """Blocks at (c, p) and their (obj, gnorm, rnorm), one host read."""
        blocks = assemble_blocks(problem, c, p, route=route, stages=stages,
                                 with_jr=with_jr)
        obj = blocks.obj
        vals = torch.stack([obj, gradient_norm(blocks),
                            torch.sqrt(2.0 * obj)]).cpu().tolist()
        return blocks, *vals

    def objective_at(c, p):
        return float(stages.objective_scatter(problem, c[None], p[None])[0])

    ckpt_mgr = None
    resume_lam = None
    it0 = 0
    if opts.checkpoint_dir is not None:
        ckpt_mgr = CheckpointManager(opts.checkpoint_dir,
                                     every=opts.checkpoint_every)
        if opts.resume:
            state = ckpt_mgr.restore_latest()
            if state is not None:
                cams = torch.as_tensor(state["cams"], dtype=problem.dtype,
                                       device=cams.device)
                points = _local_points(problem, torch.as_tensor(
                    state["points"], dtype=problem.dtype,
                    device=points.device))
                resume_lam = state["lam"]
                it0 = state["iteration"]

    t0 = time.perf_counter()
    blocks, obj, gnorm, rnorm = linearize(cams, points)
    nres = njac = 1
    if not np.isfinite(obj):
        return LMResult("exception", obj, 0, time.perf_counter() - t0,
                        gnorm, cams, points, nres, njac, [])

    if resume_lam is not None:
        lam = resume_lam
    elif opts.lam0 is not None:
        lam = float(opts.lam0)
    elif opts.lam0_mode == "diag":
        lam = 1e-3 * float(torch.maximum(
            torch.max(blocks.Hcc_f.reshape(-1, 81)[:, ::10]),
            spmdctx.pmax_points(
                torch.max(blocks.Hpp_f.reshape(-1, 9)[:, ::4]))))
    else:
        lam = max(30.0, 1e10 / max(gnorm, 1e-300))

    # first_order threshold, fixed at entry
    gtol = tols["atol"] + tols["rtol"] * gnorm

    history: List[dict] = []
    status = "max_iter"
    it = it0
    nu = 2.0  # Nielsen reject-growth factor
    dc_prev = None  # PCG warm-start carry (opts.pcg_warm)
    if verbose:
        print(_LOG_HEADER)

    while it < opts.max_iters:
        if _any_rank(time.perf_counter() - t0 > opts.max_time, cams.device):
            status = "max_time"
            break
        if gnorm < gtol:
            status = "first_order"
            break
        if rnorm < tols["restol"]:
            status = "small_residual"
            break

        pcg_rtol = (opts.pcg_rtol if opts.pcg_rtol is not None
                    else float(forcing_rtol(gnorm)))
        dc, dp, Jd2, cg_iters = solve_step(
            problem, blocks, lam, pcg_rtol, opts.solver, opts.pcg_max_iters,
            x0=dc_prev if (opts.pcg_warm and opts.solver == "pcg")
            else None)
        # The point parts of g'd, ||d||^2 and ||x||^2 (one all-reduce on a
        # point-aligned shard; the camera parts are replicated).
        pnt = spmdctx.psum_points(torch.stack([torch.sum(blocks.g_p * dp),
                                        torch.sum(dp * dp),
                                        torch.sum(points ** 2)]))
        gd = torch.sum(blocks.g_c * dc) + pnt[0]
        dnorm = torch.sqrt(torch.sum(dc * dc) + pnt[1])
        xnorm = torch.sqrt(torch.sum(cams ** 2) + pnt[2])
        gd, Jd2, dnorm, xnorm = torch.stack(
            [gd, Jd2, dnorm, xnorm]).cpu().tolist()
        if opts.pcg_warm and np.isfinite(dnorm):
            dc_prev = dc

        if not np.isfinite(dnorm):
            # NaN step: reject and grow lambda; terminate only if lambda is
            # already hopeless.
            if lam > 1e20:
                status = "exception"
                break
            if opts.lam_strategy == "nielsen":
                lam *= nu
                nu *= 2.0
            else:
                lam = lam * opts.nu_m
            it += 1
            history.append({"iter": it - 1, "obj": obj, "gnorm": gnorm,
                            "lam": lam, "dnorm": float("nan"),
                            "rho": float("nan"), "cg_iters": int(cg_iters),
                            "accepted": False})
            continue

        if dnorm < tols["satol"] + tols["srtol"] * xnorm:
            status = "small_step"
            break

        # Trial step(s): full step, then optional halvings.
        scales = [1.0]
        if opts.linesearch:
            scales += [0.5 ** j for j in range(1, opts.ls_max + 1)]
        accepted = False
        for s in scales:
            cams_t = cams + s * dc
            points_t = points + s * dp
            obj_t = objective_at(cams_t, points_t)
            nres += 1
            pred = -s * gd - 0.5 * s * s * Jd2
            ared = obj - obj_t
            rho = ared / pred if pred != 0.0 else -np.inf
            if pred > 0 and ared >= opts.accept_ratio * pred:
                accepted = True
                break

        row = {"iter": it, "obj": obj, "gnorm": gnorm, "lam": lam,
               "dnorm": dnorm * (s if accepted else 1.0), "rho": rho,
               "cg_iters": int(cg_iters), "accepted": accepted}
        history.append(row)
        if verbose:
            print(f"{it:5d} {row['obj']:14.6e} {row['gnorm']:11.4e} "
                  f"{lam:9.2e} {row['dnorm']:9.2e} {rho:9.2e} "
                  f"{row['cg_iters']:4d} "
                  f"{'accept' if accepted else 'reject'}")
        if callback is not None:
            callback(row)

        if accepted:
            prev_obj = obj
            cams, points = cams_t, points_t
            blocks, obj, gnorm, rnorm = linearize(cams, points)
            nres += 1
            njac += 1
            if opts.lam_strategy == "nielsen":
                lam *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                nu = 2.0
            else:
                lam /= opts.nu_d
                if ared >= opts.good_ratio * pred:
                    lam /= opts.nu_d
            lam = max(lam, opts.lam_min)
            it += 1
            if ckpt_mgr is not None and ckpt_mgr.due(it):
                pts = _global_points(problem, points)
                if _rank0(problem):
                    ckpt_mgr.maybe_save(
                        it, cams, pts, lam=lam,
                        meta={"objective": obj,
                              "problem": _whole(problem).name})
            if prev_obj - obj < tols["oatol"] + tols["ortol"] * abs(
                    prev_obj):
                status = "small_obj_change"
                break
        else:
            if opts.lam_strategy == "nielsen":
                lam *= nu
                nu *= 2.0
            else:
                # nu_m^(halvings + 1), halvings = len(scales) - 1
                lam = (max(lam, 1.0 / max(dnorm, 1e-300))
                       * opts.nu_m ** len(scales))
            it += 1

    return LMResult(status=status, objective=obj, iterations=it,
                    elapsed_time=time.perf_counter() - t0, dual_feas=gnorm,
                    cams=cams, points=points, neval_residual=nres,
                    neval_jac=njac, history=history)
