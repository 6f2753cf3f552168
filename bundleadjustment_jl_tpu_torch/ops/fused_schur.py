"""Fused Schur-complement reductions over W (K2, K3) — the counterpart of
`bundleadjustment_jl_tpu/ops/pallas_schur.py` on the camera-scatter routes.

Same device rule as `ops/fused_assemble.py`: CUDA float32 tensors launch
the hand-written kernels (``csrc/cam_reduce.cu``, ``csrc/matvec.cu``), CPU
tensors take the plain PyTorch version beside each wrapper, CUDA float64
raises. ``W_t`` is the (27, nobs_pad) structure-of-arrays W of the
assembly (row ``3a+b`` = ``W[a, b]``), stored as float32, bfloat16 or
float16 (the kernel reads that type and widens at the load; the plain
versions widen it first), and ``JR_t`` the (26, nobs_pad) float32
linearization of `ops/linearize.py`, both in the point-sorted row order;
per-point operands are flat (npnts*9,) / (npnts*3,) or (npnts, 3).

K2 (`cam_scatter_reduce`) has one wrapper per product the JAX package
gives it; each sums its per-row product per camera over the point-sorted
rows (no camera-sorted copy), in point-order tiles walked by a fixed number
of blocks with camera sums of their own in shared memory, or at many
cameras through per-run sums (W op) or records (the other products) (plan
:func:`ops.plans.tile_plan`, the path :func:`cam_path`, scratch per call;
``csrc/cam_pass.cuh``):

- :func:`cam_reduce_wcw_rhs` (``_prod_wcw_rhs``): the camera-scatter
  routes' Schur diagonal and reduced right-hand side in one pass; on route
  B1 (:func:`relin_wcw_rhs`) the reference of
  :func:`cam_relin_wcw_rhs`, which sums the same products with each row's
  W re-derived in camera order, in the order of this form's records path
  and with no records;
- :func:`cam_reduce_w_op` (``_prod_w_op``): ``sum W op[pnt]`` where there
  is no camera-sorted W (route B1);
- :func:`cam_reduce_wcw` (``_prod_wcw``): ``sum W C W'``, the Schur
  diagonal of :func:`ops.schur.schur_diag_blocks` without a camera-sorted W;
- :func:`cam_reduce_cam90` (``_prod_cam90``): ``[Hcc | g_c]`` over
  ``JR_t``, no solve's: the reference of :func:`cam_relin_cam90`, which
  sums the same products for the split assembly of routes B1 and B2 with
  each row's Jc and r re-derived in camera order (``csrc/linearize.cu``),
  in the order of this form's records path and with no records.

K3 (:func:`matvec_cam_scatter`) does both of its directions over each
staged tile of the same plan, in one launch (``csrc/matvec.cu``).
"""

from __future__ import annotations

import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import _cuda, plans
from bundleadjustment_jl_tpu_torch.ops.linearize import _linearize_plain
from bundleadjustment_jl_tpu_torch.ops.seg_reduce import (
    _wtv_point_plain, jtj_cam_rows, seg_sum, w_op_rows, wcw_rows)

# K2's forms: the C entry point's form code and the sums a camera keeps
# (csrc/cam_reduce.cu; the upper triangle of a symmetric 9x9 is 45); "matvec"
# is K3 (csrc/matvec.cu).
FORMS = {"wcw_rhs": (0, 54), "w_op": (1, 9), "wcw": (2, 45), "cam90": (3, 54),
         "matvec": (None, 9)}


def cam_path(form: str, problem: BAProblem,
             x_code: int) -> tuple[str, int]:
    """``(path, blocks)`` of K2's ``form`` (or K3, "matvec") on
    ``problem`` with its rows stored as ``x_code`` (`_cuda.W_CODES`):
    :func:`ops.plans.cam_pass_path` from the camera count and the kernel's
    stage bytes (card only)."""
    code, k = FORMS[form]
    return plans.cam_pass_path(
        problem.ncams, k, _cuda.cam_pass_bytes(code, x_code, 0),
        _cuda.cam_pass_bytes(code, x_code, 1))


def _scratch(path: str, blocks: int, k: int, rec_bytes: int,
             problem: BAProblem, plan, device) -> torch.Tensor:
    """The path's scratch: (blocks, ncams, k) float32 slices, the (nruns,
    k) float32 per-run sums, or the (nobs_pad, rec_bytes) records as int32
    words."""
    if path == "records":
        return torch.empty((problem.nobs_pad, rec_bytes // 4),
                           dtype=torch.int32, device=device)
    if path == "runs":
        return torch.empty((plan.nruns, k), dtype=torch.float32,
                           device=device)
    return torch.empty((blocks, problem.ncams, k), dtype=torch.float32,
                       device=device)


def _cam_reduce(form: str, key: str, x: torch.Tensor, x_code: int,
                problem: BAProblem, d_out: int, a=None, b=None,
                w: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the K2 form ``form`` over ``x`` (W or JR, storage
    ``x_code``) with per-point operands ``a``, ``b`` -> (ncams, d_out);
    ``w``: the W it reads (:func:`_cuda.launched`)."""
    _cuda.require_problem(problem)
    plan = plans.tile_plan(problem)
    code, k = FORMS[form]
    path, blocks = cam_path(form, problem, x_code)
    scratch = _scratch(path, blocks, k, _cuda.cam_pass_bytes(code, x_code, 2),
                       problem, plan, x.device)
    out = torch.empty((problem.ncams, d_out), dtype=torch.float32,
                      device=x.device)
    rc = _cuda.lib().ba_cam_reduce(
        code, _cuda.ptr(x), x_code, _cuda.ptr(problem.pnt_idx), _cuda.ptr(a),
        _cuda.ptr(b), _cuda.tile_plan_arg(plan, problem),
        problem.ncams, problem.nobs_pad, plans.PATHS[path], blocks,
        _cuda.ptr(scratch), _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, f"ba_cam_reduce ({form}, {path})")
    _cuda.launched(key, w)
    return out


def cam_reduce_wcw_rhs(W_t: torch.Tensor, problem: BAProblem,
                       hpp_inv_f: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
    """Per-camera ``[sum_k W_k C_p W_k' (81) | sum_k W_k t_p (9)]`` ->
    (ncams, 90), with ``C = Hpp_inv`` (npnts*9,) and ``t`` (npnts, 3)."""
    if not W_t.is_cuda:
        return _cam_reduce_wcw_rhs_plain(W_t, problem, hpp_inv_f, t)
    p, npt = problem, problem.npnts
    code = _cuda.w_code(W_t, "W_t", (27, p.nobs_pad))
    _cuda.require(hpp_inv_f, "hpp_inv_f", torch.float32, (npt * 9,))
    _cuda.require(t, "t", torch.float32, (npt, 3))
    return _cam_reduce("wcw_rhs", "cam_reduce", W_t, code, p, 90,
                       hpp_inv_f, t, w=W_t)


def _cam_reduce_wcw_rhs_plain(W_t, problem, hpp_inv_f, t):
    pi = problem.pnt_idx.long()
    return seg_sum(torch.cat([wcw_rows(W_t, hpp_inv_f, pi),
                              w_op_rows(W_t, t, pi)], dim=1),
                   problem.cam_idx.long(), problem.ncams)


def cam_reduce_w_op(W_t: torch.Tensor, problem: BAProblem,
                    op: torch.Tensor) -> torch.Tensor:
    """Per-camera ``sum_k W_k op[pnt_k]`` -> (ncams, 9), ``op`` (npnts,
    3)."""
    if not W_t.is_cuda:
        return _cam_reduce_w_op_plain(W_t, problem, op)
    p = problem
    code = _cuda.w_code(W_t, "W_t", (27, p.nobs_pad))
    _cuda.require(op, "op", torch.float32, (p.npnts, 3))
    return _cam_reduce("w_op", "cam_reduce_w_op", W_t, code, p, 9, op,
                       w=W_t)


def _cam_reduce_w_op_plain(W_t, problem, op):
    return seg_sum(w_op_rows(W_t, op, problem.pnt_idx.long()),
                   problem.cam_idx.long(), problem.ncams)


def cam_reduce_wcw(W_t: torch.Tensor, problem: BAProblem,
                   hpp_inv_f: torch.Tensor) -> torch.Tensor:
    """Per-camera ``sum_k W_k C[pnt_k] W_k'`` -> (ncams, 81), ``C =
    Hpp_inv`` (npnts*9,)."""
    if not W_t.is_cuda:
        return _cam_reduce_wcw_plain(W_t, problem, hpp_inv_f)
    p = problem
    code = _cuda.w_code(W_t, "W_t", (27, p.nobs_pad))
    _cuda.require(hpp_inv_f, "hpp_inv_f", torch.float32, (p.npnts * 9,))
    return _cam_reduce("wcw", "cam_reduce_wcw81", W_t, code, p, 81,
                       hpp_inv_f, w=W_t)


def _cam_reduce_wcw_plain(W_t, problem, hpp_inv_f):
    return seg_sum(wcw_rows(W_t, hpp_inv_f, problem.pnt_idx.long()),
                   problem.cam_idx.long(), problem.ncams)


def cam_reduce_cam90(JR_t: torch.Tensor, problem: BAProblem) -> torch.Tensor:
    """Per-camera ``[Hcc (81) | g_c (9)]`` = sums of ``[Jc'Jc | Jc'r]``
    over the point-sorted ``JR_t`` (26, n) -> (ncams, 90)."""
    if not JR_t.is_cuda:
        return _cam_reduce_cam90_plain(JR_t, problem)
    p = problem
    _cuda.require(JR_t, "JR_t", torch.float32, (26, p.nobs_pad))
    return _cam_reduce("cam90", "cam_reduce_cam90", JR_t, 0, p, 90)


def _cam_reduce_cam90_plain(JR_t, problem):
    return seg_sum(jtj_cam_rows(JR_t), problem.cam_idx.long(), problem.ncams)


def cam_relin_cam90(problem: BAProblem, cams: torch.Tensor,
                    points: torch.Tensor) -> torch.Tensor:
    """Per-camera ``[Hcc (81) | g_c (9)]`` at (cams, points) -> (ncams,
    90): :func:`cam_reduce_cam90`'s sums with each row's Jc and r
    re-derived by K7's chain, a block a camera over its rows in camera
    order (:func:`ops.plans.cam_obs` and ``cam_pnt``), summed in the
    records path's order, so bit-identical to it over K7's ``JR_t``."""
    if not cams.is_cuda:
        return _cam_relin_cam90_plain(problem, cams, points)
    nc, npt = problem.ncams, problem.npnts
    _cuda.require(cams, "cams", torch.float32, (nc, 9))
    _cuda.require(points, "points", torch.float32, (npt, 3))
    _cuda.require_problem(problem)
    pt2d, w = plans.cam_obs(problem)
    out = torch.empty((nc, 90), dtype=torch.float32, device=cams.device)
    rc = _cuda.lib().ba_cam_relin_cam90(
        _cuda.ptr(cams), _cuda.ptr(points), _cuda.ptr(pt2d), _cuda.ptr(w),
        _cuda.ptr(plans.cam_pnt(problem)), _cuda.ptr(problem.cam_starts), nc,
        _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, "ba_cam_relin_cam90")
    _cuda.launched("cam_relin_cam90")
    return out


def _cam_relin_cam90_plain(problem, cams, points):
    """Plain version of :func:`cam_relin_cam90`:
    :func:`_cam_reduce_cam90_plain` over the plain K7's ``JR_t``."""
    JR_t = _linearize_plain(problem, cams, points)[0]
    return _cam_reduce_cam90_plain(JR_t, problem)


def relin_wcw_rhs(w_dtype: torch.dtype, work_dtype: torch.dtype) -> bool:
    """Whether route B1 sums W C W' | W t by :func:`cam_relin_wcw_rhs`
    rather than over ``W_t``, for W stored in ``w_dtype`` in a solve in
    ``work_dtype``: where the walk reproduces the stored W, that is W in
    float32 or bfloat16, or in float16 in a float32 solve (there the
    float16 W is K7's float32 W times its power-of-two range scale,
    rounded once, as the walk rounds it; in a 2-byte solve it is rounded
    twice). A float64 W is the plain route's, which no kernel stores."""
    return w_dtype in _cuda.W_CODES and (w_dtype != torch.float16
                                         or work_dtype == torch.float32)


def cam_relin_wcw_rhs(problem: BAProblem, cams: torch.Tensor,
                      points: torch.Tensor, hpp_inv_f: torch.Tensor,
                      t: torch.Tensor, w_dtype: torch.dtype = torch.float32,
                      w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Per-camera ``[sum W C W' (81) | sum W t (9)]`` at (cams, points) ->
    (ncams, 90): :func:`cam_reduce_wcw_rhs`'s sums with each row's W
    re-derived by K7's chain, a block a camera over its rows in camera
    order (:func:`ops.plans.cam_obs` and ``cam_pnt``), rounded to
    ``w_dtype`` as K7 stores it (a float16 W as ``w_scale`` times it, as
    ``solver/lm_jit.py:maybe_cast_facto`` stores it) and summed in the
    records path's order, so bit-identical to it over that ``W_t``."""
    if not cams.is_cuda:
        return _cam_relin_wcw_rhs_plain(problem, cams, points, hpp_inv_f, t,
                                        w_dtype, w_scale)
    nc, npt = problem.ncams, problem.npnts
    _cuda.require(cams, "cams", torch.float32, (nc, 9))
    _cuda.require(points, "points", torch.float32, (npt, 3))
    _cuda.require(hpp_inv_f, "hpp_inv_f", torch.float32, (npt * 9,))
    _cuda.require(t, "t", torch.float32, (npt, 3))
    if w_scale is not None:
        _cuda.require(w_scale, "w_scale", torch.float32, ())
    _cuda.require_problem(problem)
    code = _cuda.W_CODES[w_dtype]
    pt2d, w = plans.cam_obs(problem)
    # [X | Hpp_inv | t | 0] a point, packed by the launch, so that a row
    # gathers its point's operands as two 32 B sectors.
    pnt_ops = torch.empty((npt, 16), dtype=torch.float32, device=cams.device)
    out = torch.empty((nc, 90), dtype=torch.float32, device=cams.device)
    rc = _cuda.lib().ba_cam_relin_wcw_rhs(
        _cuda.ptr(cams), _cuda.ptr(points), _cuda.ptr(hpp_inv_f),
        _cuda.ptr(t), _cuda.ptr(pt2d), _cuda.ptr(w),
        _cuda.ptr(plans.cam_pnt(problem)), _cuda.ptr(problem.cam_starts),
        _cuda.ptr(w_scale if w_dtype == torch.float16 else None), code, npt,
        nc, _cuda.ptr(pnt_ops), _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, "ba_cam_relin_wcw_rhs")
    _cuda.launched("cam_relin_wcw_rhs", w_dtype)
    return out


def _cam_relin_wcw_rhs_plain(problem, cams, points, hpp_inv_f, t,
                             w_dtype=torch.float32, w_scale=None):
    """Plain version of :func:`cam_relin_wcw_rhs`:
    :func:`_cam_reduce_wcw_rhs_plain` over the plain K7's W, stored as
    the solve stores it."""
    W_t = _linearize_plain(problem, cams, points)[1]
    if w_scale is not None and w_dtype == torch.float16:
        W_t = W_t * w_scale
    return _cam_reduce_wcw_rhs_plain(W_t.to(w_dtype), problem, hpp_inv_f, t)


def matvec_cam_scatter(W_t: torch.Tensor, v: torch.Tensor,
                       problem: BAProblem, hpp_inv_f: torch.Tensor,
                       gp_f: torch.Tensor | None = None, sign: float = 1.0,
                       with_dp: bool = False):
    """``out = segsum_cam(W_k t[pnt_k])`` (ncams, 9) with
    ``t = sign * Hpp_inv (segsum_pnt(W_k' v[cam_k]) + g_p)`` (npnts, 3).

    ``gp_f=None, sign=1``: the W Hpp_inv W' v term of the Schur matvec.
    ``gp_f=g_p, sign=-1, with_dp=True``: ``t`` is the back-substituted
    point step dp, returned with ``out``, the |J d|^2 cross term's camera
    sums."""
    if not W_t.is_cuda:
        return _matvec_cam_scatter_plain(W_t, v, problem, hpp_inv_f, gp_f,
                                         sign, with_dp)
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    code = _cuda.w_code(W_t, "W_t", (27, n))
    _cuda.require(v, "v", torch.float32, (nc, 9))
    _cuda.require(hpp_inv_f, "hpp_inv_f", torch.float32, (npt * 9,))
    if gp_f is not None:
        _cuda.require(gp_f, "gp_f", torch.float32, (npt * 3,))
    _cuda.require_problem(problem)
    plan = plans.tile_plan(problem)
    path, blocks = cam_path("matvec", problem, code)
    t = torch.empty((npt, 3), dtype=torch.float32, device=W_t.device)
    scratch = _scratch(path, blocks, 9, 0, problem, plan, W_t.device)
    out = torch.empty((nc, 9), dtype=torch.float32, device=W_t.device)
    p = problem
    rc = _cuda.lib().ba_matvec(
        _cuda.ptr(W_t), code, _cuda.ptr(v), _cuda.ptr(p.cam_idx),
        _cuda.ptr(p.pnt_idx), _cuda.ptr(p.pnt_starts),
        _cuda.tile_plan_arg(plan, p), _cuda.ptr(hpp_inv_f), _cuda.ptr(gp_f),
        float(sign), nc, n, plans.PATHS[path], blocks, _cuda.ptr(t),
        _cuda.ptr(scratch), _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, f"ba_matvec ({path})")
    _cuda.launched("matvec", W_t)
    return (out, t) if with_dp else out


def _matvec_plain(W_t, v, problem, hpp_inv_f, gp_f, sign):
    t = _wtv_point_plain(W_t, v, problem, hpp_inv_f, gp_f, sign)
    return _cam_reduce_w_op_plain(W_t, problem, t), t


def _matvec_cam_scatter_plain(W_t, v, problem, hpp_inv_f, gp_f=None,
                              sign=1.0, with_dp=False):
    """Plain version of :func:`matvec_cam_scatter`, same signature."""
    out, t = _matvec_plain(W_t, v, problem, hpp_inv_f, gp_f, sign)
    return (out, t) if with_dp else out
