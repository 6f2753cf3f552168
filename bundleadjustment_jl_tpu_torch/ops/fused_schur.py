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
rows (no camera-sorted copy), in point-order tiles with per-run partial
sums (plan :func:`ops.plans.tile_plan`, a (nruns, K) scratch buffer per
call; ``csrc/cam_prod.cuh``):

- :func:`cam_reduce_wcw_rhs` (``_prod_wcw_rhs``): the fused routes' Schur
  diagonal and reduced right-hand side in one pass;
- :func:`cam_reduce_w_op` (``_prod_w_op``): ``sum W op[pnt]`` where there
  is no camera-sorted W (route B1);
- :func:`cam_reduce_wcw` (``_prod_wcw``): ``sum W C W'``, the Schur
  diagonal of :func:`ops.schur.schur_diag_blocks` without a camera-sorted W;
- :func:`cam_reduce_cam90` (``_prod_cam90``): ``[Hcc | g_c]`` over
  ``JR_t`` on the split assembly of routes B1 and B2.

K3 (:func:`matvec_cam_scatter`) is K5's point pass then K2's W op product,
launched back to back (two plans; one launch counted).
"""

from __future__ import annotations

import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import _cuda, plans
from bundleadjustment_jl_tpu_torch.ops.seg_reduce import (
    _wtv_point_plain, jtj_cam_rows, seg_sum, w_op_rows, wcw_rows)

# Partial sums a run of each K2 form keeps (csrc/cam_prod.cuh, Prod*::K):
# the upper triangle of a symmetric 9x9 is 45.
PARTIAL_K = {"ba_cam_reduce_wcw_rhs": 54, "ba_cam_reduce_w_op": 9,
             "ba_cam_reduce_wcw": 45, "ba_cam_reduce_cam90": 54}


def _cam_reduce(fn: str, key: str, x: torch.Tensor, problem: BAProblem,
                d_out: int, *args, w: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Launch the K2 form ``fn`` -> (ncams, d_out); ``args`` go between
    the row-order arrays and the plan, as in its C signature; ``w``: the
    W it reads (:func:`_cuda.launched`)."""
    _cuda.require_problem(problem)
    plan = plans.tile_plan(problem)
    partial = torch.empty((plan.nruns, PARTIAL_K[fn]), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((problem.ncams, d_out), dtype=torch.float32,
                      device=x.device)
    rc = getattr(_cuda.lib(), fn)(
        *args, _cuda.tile_plan_arg(plan), problem.ncams, problem.nobs_pad,
        _cuda.ptr(partial), _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, fn)
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
    return _cam_reduce(
        "ba_cam_reduce_wcw_rhs", "cam_reduce", W_t, p, 90, _cuda.ptr(W_t),
        code, _cuda.ptr(p.pnt_idx), _cuda.ptr(hpp_inv_f), _cuda.ptr(t),
        w=W_t)


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
    return _cam_reduce(
        "ba_cam_reduce_w_op", "cam_reduce_w_op", W_t, p, 9, _cuda.ptr(W_t),
        code, _cuda.ptr(p.pnt_idx), _cuda.ptr(op), w=W_t)


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
    return _cam_reduce(
        "ba_cam_reduce_wcw", "cam_reduce_wcw81", W_t, p, 81, _cuda.ptr(W_t),
        code, _cuda.ptr(p.pnt_idx), _cuda.ptr(hpp_inv_f), w=W_t)


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
    return _cam_reduce(
        "ba_cam_reduce_cam90", "cam_reduce_cam90", JR_t, p, 90,
        _cuda.ptr(JR_t))


def _cam_reduce_cam90_plain(JR_t, problem):
    return seg_sum(jtj_cam_rows(JR_t), problem.cam_idx.long(), problem.ncams)


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
    plan, blocks = plans.tile_plan(problem), plans.point_blocks(problem)
    t = torch.empty((npt, 3), dtype=torch.float32, device=W_t.device)
    partial = torch.empty((plan.nruns, 9), dtype=torch.float32,
                          device=W_t.device)
    out = torch.empty((nc, 9), dtype=torch.float32, device=W_t.device)
    p = problem
    rc = _cuda.lib().ba_matvec(
        _cuda.ptr(W_t), code, _cuda.ptr(v), _cuda.ptr(p.cam_idx),
        _cuda.ptr(p.pnt_idx), _cuda.ptr(p.pnt_starts), _cuda.ptr(blocks),
        blocks.shape[0] - 1, _cuda.tile_plan_arg(plan), _cuda.ptr(hpp_inv_f),
        _cuda.ptr(gp_f), float(sign), nc, n, _cuda.ptr(t),
        _cuda.ptr(partial), _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, "ba_matvec")
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
