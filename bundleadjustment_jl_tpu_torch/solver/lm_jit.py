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

``facto_dtype`` (bfloat16 or float16) stores the per-observation W blocks
in that dtype, as the JAX solver does (:func:`maybe_cast_facto`); with it
come the narrow-storage CG floor, the CG stagnation stop and the
predicted-reduction stop.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem, np_dtype
from bundleadjustment_jl_tpu_torch.ops._cuda import (
    W_DTYPES, W_READERS, W_WRITERS)
from bundleadjustment_jl_tpu_torch.ops.normal import (
    assemble_blocks, gradient_norm, kernel_route, solve_stages)
from bundleadjustment_jl_tpu_torch.ops.pcg import (
    STAGNATION_WINDOW, block_jacobi_apply, block_jacobi_inverse,
    forcing_rtol, pcg)
from bundleadjustment_jl_tpu_torch.ops.schur import (
    back_substitute_quad, reduce_and_diag, schur_matvec)

# The kernel route of a solve is one of `ops/normal.py:ROUTES`, which lists
# each route's kernels; `ops/normal.py:kernel_route` picks it once per call
# of `levenberg_marquardt_jit` from the switch and size gates beside it
# (`FORCE_ROUTE` there sets them to force a route). Beside it, once per call,
# `ops/normal.py:solve_stages` picks the stage table: the kernel wrappers, or
# their plain twins for float64 or with `normal.PALLAS_MODE` off (the JAX
# solver keeps XLA there), no kernel launched.


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


def expected_w_launches(launches: dict, facto_dtype) -> dict:
    """The W storage of a solve's launches (`ops/_cuda.py:W_LAUNCHES`),
    from its kernel launches (``_cuda.LAUNCHES``) and its ``facto_dtype``:
    the writers write W in :func:`w_assemble_dtype` (float32 when it gives
    None), the readers read it in ``facto_dtype`` (float32 when None)."""
    out = dict.fromkeys(W_DTYPES, 0)
    out[w_assemble_dtype(facto_dtype) or torch.float32] += sum(
        launches[k] for k in W_WRITERS)
    out[facto_dtype or torch.float32] += sum(launches[k] for k in W_READERS)
    return out


# CG relative-tolerance floor under narrow W storage, as a multiple of
# eps(facto_dtype) (the JAX solver's _CG_FLOOR_MULT): a bfloat16 / float16
# W bounds the matvec's accuracy, and CG below ~8 eps(facto) chases noise.
CG_FLOOR_MULT = 8.0

# Storage dtypes `facto_dtype` takes: those the W kernels take.
FACTO_DTYPES = W_DTYPES


def w_assemble_dtype(facto_dtype: torch.dtype | None):
    """The dtype the assembly may write W in directly (the JAX solver's
    `_w_assemble_dtype`): bfloat16 shares float32's exponent range; float16
    must not be written raw (max|W| ~ f^2 overflows it before the range
    scale is known), so it is written in the working dtype and cast by
    :func:`maybe_cast_facto`."""
    if facto_dtype is None or facto_dtype == torch.float16:
        return None
    return facto_dtype


def f16_scale(W_t: torch.Tensor) -> torch.Tensor:
    """The range scale of a float16 W (the JAX solver's, after the
    reference's `normalize_F16!`): the power of two that puts max|W| near
    2^14, a 0-d float32 tensor on W's device (no host read)."""
    lo, hi = torch.aminmax(W_t)
    wmax = torch.maximum(-lo, hi).float()
    safe = torch.where(torch.isfinite(wmax) & (wmax > 0), wmax,
                       torch.ones_like(wmax))
    return torch.exp2(torch.floor(torch.log2(16384.0 / safe)))


def narrow_w(W: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """W as a solve with ``facto_dtype=dtype`` stores it: rounded to
    ``dtype``, a float16 W first scaled by :func:`f16_scale` (float32 is
    kept as it is)."""
    if dtype == torch.float16:
        W = W * f16_scale(W)
    return W.to(dtype).contiguous()


def maybe_cast_facto(blocks, facto_dtype: torch.dtype | None):
    """The blocks with W stored in ``facto_dtype`` (the JAX solver's
    `_maybe_cast_facto`): float16 as ``s W`` with ``s = f16_scale(W)`` in
    ``w_scale``, ``W_cam_t`` alike; a W already written in the storage dtype
    (:func:`w_assemble_dtype`) is returned as it is. Hcc and Hpp stay in
    the working dtype."""
    if facto_dtype is None or (facto_dtype != torch.float16
                               and blocks.W_t.dtype == facto_dtype):
        return blocks
    scale = f16_scale(blocks.W_t) if facto_dtype == torch.float16 else None

    def store(W):
        if W is None:
            return None
        return (W if scale is None else W * scale).to(facto_dtype)

    return blocks._replace(
        W_t=store(blocks.W_t), W_cam_t=store(blocks.W_cam_t),
        w_scale=None if scale is None else scale.to(blocks.W_t.dtype))


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
    elapsed_time: float = math.nan  # wall seconds (chunked driver only)

    def status_name(self) -> str:
        return STATUS_NAMES[int(self.status)]

    @property
    def neval_jac(self) -> int:
        """One linearization per accepted step plus the initial one (the
        reference's `neval_jac`, `BALNLPModels.jl:162`)."""
        return int(self.naccepts) + 1

    @property
    def neval_residual(self) -> int:
        """One (batched) trial objective per iteration plus the
        linearizations' residuals."""
        return int(self.iterations) + self.neval_jac


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
    ``pcg_warm`` starts each PCG from the previous camera step.
    ``facto_dtype`` (one of :data:`FACTO_DTYPES`) stores W in that dtype
    (:func:`maybe_cast_facto`)."""
    for option, on in (("use_dense", use_dense), ("use_cgls", use_cgls),
                       ("use_power", use_power)):
        if on:
            _unsupported(option, "CGLS, dense and power solvers")
    if facto_dtype is not None and facto_dtype not in FACTO_DTYPES:
        raise TypeError(f"facto_dtype: one of {FACTO_DTYPES}, got "
                        f"{facto_dtype!r}")
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
    stages = solve_stages(cams.dtype)
    w_dtype = w_assemble_dtype(facto_dtype)
    # "Narrow" W storage (below 4 bytes; the JAX solver's `facto_narrow`,
    # whose other case, a half-precision working dtype, raises above): only
    # then the CG floor, the CG stagnation stop and the predicted-reduction
    # stop. float32 storage keeps the reference's stopping semantics.
    narrow = facto_dtype is not None and facto_dtype.itemsize < 4
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
    cg_floor = (ft(CG_FLOOR_MULT * float(torch.finfo(facto_dtype).eps))
                if narrow else None)
    stagnation = STAGNATION_WINDOW if narrow else 0

    # Initial linearization; one host read.
    blocks = assemble_blocks(problem, cams, points, route=route,
                             w_dtype=w_dtype, stages=stages)
    init = [blocks.obj, gradient_norm(blocks)]
    if lam0_mode == "diag":
        init.append(torch.maximum(
            torch.max(blocks.Hcc_f.reshape(-1, 81)[:, ::10]),
            torch.max(blocks.Hpp_f.reshape(-1, 9)[:, ::4])))
    init = torch.stack(init).cpu().numpy()
    blocks = maybe_cast_facto(blocks, facto_dtype)
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
            if cg_floor is not None:
                rtol_cg = np.maximum(rtol_cg, cg_floor)
        sys, Sd = reduce_and_diag(problem, blocks, float(lam))
        M_inv = block_jacobi_inverse(Sd)
        res = pcg(lambda v: schur_matvec(sys, v), sys.b,
                  lambda v: block_jacobi_apply(M_inv, v),
                  rtol=float(rtol_cg), max_iters=pcg_max_iters,
                  x0=dc_carry if pcg_warm else None,
                  stagnation_window=stagnation)
        dc, cg_iters = res.x, res.iters
        dp, Jd2 = back_substitute_quad(problem, blocks, sys, dc)

        gd = torch.sum(blocks.g_c * dc) + torch.sum(blocks.g_p * dp)
        dnorm_t = torch.sqrt(torch.sum(dc * dc) + torch.sum(dp * dp))
        xnorm = torch.sqrt(torch.sum(cams ** 2) + torch.sum(points ** 2))
        objs_t = stages.objective_scatter(
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
            blocks = assemble_blocks(problem, cams, points, route=route,
                                     w_dtype=w_dtype, stages=stages)
            new = torch.stack([blocks.obj, gradient_norm(blocks)]).cpu()
            blocks = maybe_cast_facto(blocks, facto_dtype)
            obj_n, gnorm_n = (ft(v) for v in new.numpy())
            naccepts += 1
        else:
            obj_n, gnorm_n = obj, gnorm

        with np.errstate(all="ignore"):
            obj_tol = oatol + ortol * np.abs(obj)
            small_obj = accept and obj - obj_n < obj_tol
            if narrow:
                # Predicted-reduction stop: even the model's full decrease
                # is below the tolerance, while the gradient is within
                # three orders of gtol (not a lambda blow-up after
                # rejections).
                small_obj = small_obj or bool(
                    pred > 0 and pred < obj_tol
                    and gnorm < ft(1e3) * gtol)
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
