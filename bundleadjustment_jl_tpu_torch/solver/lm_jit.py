"""Levenberg-Marquardt over Schur-PCG on the kernel routes (PyTorch port
of `bundleadjustment_jl_tpu/solver/lm_jit.py:levenberg_marquardt_jit`).

Same algorithm, options and decisions as the JAX driver: the reference's
lambda schedule (or Nielsen's), gain-ratio acceptance with optional
batched linesearch scales, NaN-step rejection, the stopping tests in the
same order, and fixed-length history buffers.

PyTorch runs eagerly, so the loop is Python. The solver state (cameras,
points, the linearized blocks, W) stays on the device; the scalar
decisions run on the host in the working dtype (numpy float32/float64
scalars, so the rounding matches the JAX driver's device arithmetic).
Host reads per LM iteration: one flag per CG step (`ops/pcg.py`), one
packed block (trial objectives, g'd, ||J d||^2, ||d||, ||x||) at the
accept decision, and — after an accepted step — the new objective and
gradient norm that the stopping tests need.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem, np_dtype
from bundleadjustment_jl_tpu_torch.ops.fused_assemble import objective_scatter
from bundleadjustment_jl_tpu_torch.ops.normal import (
    assemble_blocks, gradient_norm)
from bundleadjustment_jl_tpu_torch.ops.pcg import (
    block_jacobi_apply, block_jacobi_inverse, forcing_rtol, pcg)
from bundleadjustment_jl_tpu_torch.ops.schur import (
    back_substitute_quad, reduce_and_diag, schur_matvec)

# The kernel route of a solve (one of `ops/normal.py:ROUTES`, which lists
# each route's kernels): `kernel_route` reads the switch and the gates
# below once per call of `levenberg_marquardt_jit` (one solve never mixes
# routes), as the JAX package's `_assemble_kminor` and `ops/schur.py` read
# theirs. The trial objectives run on K4 on every route.
#
# CAM_SCATTER is the JAX package's `pallas_schur.CAM_SCATTER` and the CLI's
# `--cam-scatter`: camera sums over the point-sorted rows (routes A, B1)
# rather than over camera-sorted copies (C, B2). The JAX default is off
# (env BA_CAM_SCATTER); the fused route is the configuration bench.py
# measures, so the port's default is on.
CAM_SCATTER = True

# The JAX package's three size gates (`ops/pallas_schur.py`), with its
# values. Each value was chosen on a TPU (VMEM tables, tile padding);
# whether it picks the faster route on the H100 is recorded in PERF.md.
#
# GATHER_TABLE_MAX_CAMS: the largest camera count whose camera vector the
# TPU's fused kernels (K1, K3) hold as a VMEM table. Above it the camera
# scatter splits: K7 + K2 assembly and the two-pass matvec (route B1).
GATHER_TABLE_MAX_CAMS = 2048
# CAM_SCATTER_MAX_CAMS: the TPU camera scatter's one-hot work grows with the
# camera count; above this count camera scatter is off whatever CAM_SCATTER
# says.
CAM_SCATTER_MAX_CAMS = 16384
# GATHER_DIRECT_MAX_BYTES: the huge-n test, nobs_pad * 512 B (one row
# tile-padded to 128 f32 lanes on the TPU) above this many bytes. There,
# with camera scatter off, the JAX package builds no camera-sorted JR copy
# (K2 sums [Hcc | g_c]) and re-linearizes W in the camera order (K8) in
# place of permuting it (route B2).
GATHER_DIRECT_MAX_BYTES = 4 << 30


def kernel_route(problem: BAProblem) -> str:
    """The kernel route the JAX package takes for ``problem`` under the
    switch and gates above (`normal.py:_assemble_kminor`,
    `pallas_schur.cam_scatter_ok`)."""
    if CAM_SCATTER and problem.ncams <= CAM_SCATTER_MAX_CAMS:
        return ("fused" if problem.ncams <= GATHER_TABLE_MAX_CAMS
                else "scatter_split")
    huge = problem.nobs_pad * 128 * 4 > GATHER_DIRECT_MAX_BYTES
    return "sorted_relin" if huge else "sorted"


# Settings of the switch and gates above that make `kernel_route` pick each
# route at any problem size (the JAX package's `pallas_schur` takes the
# same attributes to the same route).
FORCE_ROUTE = {
    "fused": dict(CAM_SCATTER=True, GATHER_TABLE_MAX_CAMS=1 << 62,
                  CAM_SCATTER_MAX_CAMS=1 << 62),
    "scatter_split": dict(CAM_SCATTER=True, GATHER_TABLE_MAX_CAMS=0,
                          CAM_SCATTER_MAX_CAMS=1 << 62),
    "sorted": dict(CAM_SCATTER=False, GATHER_DIRECT_MAX_BYTES=1 << 62),
    "sorted_relin": dict(CAM_SCATTER=False, GATHER_DIRECT_MAX_BYTES=0),
}


def expected_launches(route: str, iterations: int, naccepts: int,
                      cg: int) -> dict:
    """The kernel launches (`ops/_cuda.py:LAUNCHES` keys) a solve on
    ``route`` makes, from its iterations, accepts and CG steps (Σ
    ``hist_cg``); every key not named launches 0 times.

    Every route: K4 once per iteration. Fused (A): K1 at init and per
    accept, K2 W C W' | W t once per iteration, K3 once per CG step plus
    the initial residual and the back-substitution. Camera-sorted (C): K7
    and K6's two assembly products at init and per accept, K6's W C W'
    once per iteration, K5's point direction once per CG step plus two,
    its camera direction once more per iteration (the reduced right-hand
    side and the |J d|^2 cross term, less the back-substitution). B1: K7,
    K2 cam90 and K6 pnt12 at init and per accept, K2 W C W' | W t once per
    iteration, K5's point direction and K2's W op each once per CG step
    plus two. B2: C's counts with K2 cam90 in place of K6 cam90, plus K8
    at init and per accept."""
    it, acc = iterations, naccepts
    expect = {"objective": it}
    if route == "fused":
        expect.update(assemble=1 + acc, cam_reduce=it, matvec=cg + 2 * it)
    elif route == "scatter_split":
        expect.update(linearize=1 + acc, cam_reduce_cam90=1 + acc,
                      seg_prod_pnt12=1 + acc, cam_reduce=it,
                      seg_block_point=cg + 2 * it,
                      cam_reduce_w_op=cg + 2 * it)
    else:
        expect.update(linearize=1 + acc, seg_prod_pnt12=1 + acc,
                      seg_prod_wcw81=it, seg_block_point=cg + 2 * it,
                      seg_block_camera=cg + 3 * it)
        if route == "sorted":
            expect["seg_prod_cam90"] = 1 + acc
        else:
            expect.update(cam_reduce_cam90=1 + acc,
                          linearize_w_only=1 + acc)
    return expect


# Status codes (the JAX package's mapping of the reference statuses)
RUNNING = 0
FIRST_ORDER = 1
SMALL_RESIDUAL = 2
SMALL_STEP = 3
SMALL_OBJ_CHANGE = 4
MAX_ITER = 5
EXCEPTION = 6
MAX_TIME = 7

STATUS_NAMES = {
    FIRST_ORDER: "first_order",
    SMALL_RESIDUAL: "small_residual",
    SMALL_STEP: "small_step",
    SMALL_OBJ_CHANGE: "small_obj_change",
    MAX_ITER: "max_iter",
    EXCEPTION: "exception",
    MAX_TIME: "max_time",
    RUNNING: "running",
}


class LMJitResult(NamedTuple):
    cams: torch.Tensor          # (ncams, 9), on the problem's device
    points: torch.Tensor        # (npnts, 3)
    objective: float
    dual_feas: float            # ||J'r||
    iterations: int
    status: int                 # see STATUS_NAMES
    # per-iteration traces, length max_iters (valid up to `iterations`)
    hist_obj: np.ndarray
    hist_gnorm: np.ndarray
    hist_lam: np.ndarray
    hist_cg: np.ndarray         # int32 CG matvecs per iteration
    naccepts: int

    def status_name(self) -> str:
        return STATUS_NAMES[int(self.status)]


def _unsupported(option: str, item: str):
    """Raise for an option of the JAX driver that the port lacks; ``item``
    is the title of its entry in ROADMAP.md's queue A."""
    raise NotImplementedError(
        f"{option} is not ported yet (ROADMAP.md, queue A: {item})")


def _ipow(x, y: int):
    """x ** y by binary exponentiation, the order XLA's integer_pow uses."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def levenberg_marquardt_jit(
    problem: BAProblem, cams=None, points=None, *,
    max_iters: int = 200,
    lam0=None, lam0_mode: str = "ref",
    atol=None, rtol=None, restol=None, satol=None, srtol=None,
    oatol=None, ortol=None,
    nu_d=3.0, nu_m=3.0, accept_ratio=1e-4, good_ratio=0.9, lam_min=1e-8,
    lam_strategy: str = "ref",
    pcg_rtol=None, pcg_max_iters: int = 100,
    use_dense: bool = False, use_cgls: bool = False,
    use_power: bool = False,
    linesearch: bool = False, ls_max: int = 4,
    facto_dtype=None, pcg_warm: bool = False,
) -> LMJitResult:
    """One-call LM solve with the JAX driver's keywords. ``None``
    tolerances resolve to the reference defaults in the working dtype.
    ``pcg_rtol=None`` uses the forcing sequence :func:`forcing_rtol`;
    ``pcg_warm`` starts each PCG from the previous camera step."""
    for option, on in (("use_dense", use_dense), ("use_cgls", use_cgls),
                       ("use_power", use_power)):
        if on:
            _unsupported(option, "CGLS, dense and power solvers")
    if facto_dtype is not None:
        _unsupported("facto_dtype", "`facto_dtype`: W stored in bf16 or f16")
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    if cams.dtype not in (torch.float32, torch.float64):
        _unsupported(f"working dtype {cams.dtype}",
                     "Precision cascade and an f64 anchor")
    # Full-precision f32 products on the card (no TF32): the counterpart of
    # the JAX package's Precision.HIGHEST pins.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    route = kernel_route(problem)
    ft = np_dtype(cams.dtype).type
    eps = np.finfo(ft).eps
    cbrt, sqrt_eps = eps ** (1.0 / 3.0), np.sqrt(eps)

    def pick(v, d):
        return ft(d if v is None else v)

    atol, rtol = pick(atol, sqrt_eps), pick(rtol, cbrt)
    restol, satol = pick(restol, cbrt), pick(satol, sqrt_eps)
    srtol, oatol = pick(srtol, sqrt_eps), pick(oatol, sqrt_eps)
    ortol = pick(ortol, cbrt)
    nu_d, nu_m, lam_min = ft(nu_d), ft(nu_m), ft(lam_min)
    accept_ratio, good_ratio = ft(accept_ratio), ft(good_ratio)
    nielsen = lam_strategy == "nielsen"

    # Initial linearization; one host read.
    blocks = assemble_blocks(problem, cams, points, route=route)
    init = [blocks.obj, gradient_norm(blocks)]
    if lam0_mode == "diag":
        init.append(torch.maximum(
            torch.max(blocks.Hcc_f.reshape(-1, 81)[:, ::10]),
            torch.max(blocks.Hpp_f.reshape(-1, 9)[:, ::4])))
    init = torch.stack(init).cpu().numpy()
    obj, gnorm = ft(init[0]), ft(init[1])
    with np.errstate(all="ignore"):
        if lam0_mode == "diag":
            lam = ft(1e-3) * ft(init[2])
        else:
            lam = np.maximum(ft(30.0),
                             ft(1e10) / np.maximum(gnorm, ft(1e-300)))
    if lam0 is not None:
        lam = ft(lam0)
    gtol = atol + rtol * gnorm
    nu = ft(2.0)

    scale_list = [1.0] + ([0.5 ** j for j in range(1, ls_max + 1)]
                          if linesearch else [])
    scales_np = np.asarray(scale_list, dtype=ft)
    scales = torch.as_tensor(scales_np, device=cams.device)
    n_halvings = ls_max if linesearch else 0

    hist_obj = np.zeros((max_iters,), ft)
    hist_gnorm = np.zeros((max_iters,), ft)
    hist_lam = np.zeros((max_iters,), ft)
    hist_cg = np.zeros((max_iters,), np.int32)
    dc_carry = torch.zeros_like(cams)
    it = naccepts = 0
    status = RUNNING

    while it < max_iters and status == RUNNING:
        with np.errstate(all="ignore"):
            rtol_cg = (forcing_rtol(gnorm) if pcg_rtol is None
                       else ft(pcg_rtol))
        sys, Sd = reduce_and_diag(problem, blocks, float(lam))
        M_inv = block_jacobi_inverse(Sd)
        res = pcg(lambda v: schur_matvec(sys, v), sys.b,
                  lambda v: block_jacobi_apply(M_inv, v),
                  rtol=float(rtol_cg), max_iters=pcg_max_iters,
                  x0=dc_carry if pcg_warm else None)
        dc, cg_iters = res.x, res.iters
        dp, Jd2 = back_substitute_quad(problem, blocks, sys, dc)

        gd = torch.sum(blocks.g_c * dc) + torch.sum(blocks.g_p * dp)
        dnorm_t = torch.sqrt(torch.sum(dc * dc) + torch.sum(dp * dp))
        xnorm = torch.sqrt(torch.sum(cams ** 2) + torch.sum(points ** 2))
        objs_t = objective_scatter(
            problem, cams[None] + scales[:, None, None] * dc[None],
            points[None] + scales[:, None, None] * dp[None])
        packed = torch.cat([objs_t, torch.stack([gd, Jd2, dnorm_t, xnorm])])
        packed = packed.cpu().numpy()
        objs = packed[:-4]
        gd, Jd2, dnorm, xnorm = (ft(v) for v in packed[-4:])

        with np.errstate(all="ignore"):
            # A NaN step (Cholesky of a near-indefinite system at small
            # lambda) is a rejection; only a NaN at lambda > 1e20 is fatal.
            nan_step = not np.isfinite(dnorm)
            fatal_nan = nan_step and lam > ft(1e20)
            small_step = (not nan_step) and dnorm < satol + srtol * xnorm

            preds = -scales_np * gd - ft(0.5) * scales_np * scales_np * Jd2
            areds = obj - objs
            ok = (preds > 0) & (areds >= accept_ratio * preds) \
                & np.isfinite(objs)
            first = int(np.argmax(ok))
            s_sel, pred, ared = scales_np[first], preds[first], areds[first]
            accept = bool(ok.any()) and not nan_step

            # lambda update: reference schedule or Nielsen's.
            rho = ared / pred if pred > 0 else ft(-np.inf)
            q = ft(2.0) * rho - ft(1.0)
            nl_acc = np.maximum(
                lam * np.maximum(ft(1.0 / 3.0), ft(1.0) - q * (q * q)),
                lam_min)
            nl_rej = lam * nu
            ref_acc = np.maximum(
                lam / nu_d / (nu_d if ared >= good_ratio * pred else ft(1.0)),
                lam_min)
            dnorm_safe = dnorm if np.isfinite(dnorm) else ft(np.inf)
            ref_rej = (np.maximum(lam, ft(1.0) / np.maximum(dnorm_safe,
                                                             ft(1e-300)))
                       * _ipow(nu_m, n_halvings + 1))
            if nielsen:
                lam_new = nl_acc if accept else nl_rej
                nu_new = ft(2.0) if accept else nu * ft(2.0)
            else:
                lam_new = ref_acc if accept else ref_rej
                nu_new = nu

        hist_obj[it], hist_gnorm[it], hist_lam[it] = obj, gnorm, lam
        hist_cg[it] = cg_iters
        if accept:
            cams = cams + float(s_sel) * dc
            points = points + float(s_sel) * dp
            blocks = assemble_blocks(problem, cams, points, route=route)
            new = torch.stack([blocks.obj, gradient_norm(blocks)]).cpu()
            obj_n, gnorm_n = (ft(v) for v in new.numpy())
            naccepts += 1
        else:
            obj_n, gnorm_n = obj, gnorm

        with np.errstate(all="ignore"):
            obj_tol = oatol + ortol * np.abs(obj)
            small_obj = accept and obj - obj_n < obj_tol
            rnorm_n = np.sqrt(ft(2.0) * obj_n)
        if fatal_nan:
            status = EXCEPTION
        elif small_step:
            status = SMALL_STEP
        elif gnorm_n < gtol:
            status = FIRST_ORDER
        elif rnorm_n < restol:
            status = SMALL_RESIDUAL
        elif small_obj:
            status = SMALL_OBJ_CHANGE
        # never carry a NaN step into the next warm start
        dc_carry = dc if math.isfinite(dnorm) else torch.zeros_like(dc)
        obj, gnorm, lam, nu = obj_n, gnorm_n, lam_new, nu_new
        it += 1

    return LMJitResult(
        cams=cams, points=points, objective=float(obj),
        dual_feas=float(gnorm), iterations=it,
        status=MAX_ITER if status == RUNNING else status,
        hist_obj=hist_obj, hist_gnorm=hist_gnorm, hist_lam=hist_lam,
        hist_cg=hist_cg, naccepts=naccepts)


def levenberg_marquardt_jit_chunked(*args, **kwargs) -> LMJitResult:
    """The chunked driver (``max_time``, checkpoints, resume) of the JAX
    package; not ported yet."""
    _unsupported("levenberg_marquardt_jit_chunked", "Drivers")
