"""Segment reductions of the camera-sorted route (K6, K5) — the
counterpart of `bundleadjustment_jl_tpu/ops/pallas_schur.py`'s
`seg_prod_reduce` and `_seg_block_reduce`.

Same device rule as `ops/fused_assemble.py`: CUDA float32 tensors launch
the hand-written kernels (``csrc/seg_prod_reduce.cu``,
``csrc/seg_block_reduce.cu``), CPU tensors take the plain PyTorch version
beside each wrapper (same signature), CUDA float64 raises.

Point segments run over the point-sorted rows (``pnt_starts``; K6's point
product and K5's point direction in blocks of point ranges,
:func:`ops.plans.point_blocks`); camera
segments over the camera-sorted copies ``JR_cam_t = JR_t[:, cam_perm]`` /
``W_cam_t = W_t[:, cam_perm]`` (``cam_starts``), whose column ``j`` is the
row ``cam_perm[j]`` (K5's camera direction and K6's W C W' in column
ranges with per-run partial sums, :func:`ops.plans.cam_col_plan` and
:func:`ops.plans.wcw_col_plan`, a (nruns, 9) or (nruns, 45) scratch buffer
per call). ``JR_t`` is the (26, n) layout of `ops/linearize.py`,
``W_t`` the (27, n) one of `ops/fused_schur.py`, stored as float32,
bfloat16 or float16 (the kernels read that type and widen at the load; the
plain versions widen it to the other operand's dtype first); per-point
operands are flat (npnts*9,) / (npnts*3,) or (npnts, 3).
"""

from __future__ import annotations

import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import _cuda, plans
from bundleadjustment_jl_tpu_torch.ops.linearize import JP0, R0


def w_rows(W_t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(27, n) structure-of-arrays -> (n, 9, 3) blocks in ``dtype`` (a
    bfloat16 / float16 W widened, as the kernels widen it at the load)."""
    return W_t.to(dtype).reshape(9, 3, -1).permute(2, 0, 1)


def _cam_sorted_ids(problem: BAProblem):
    """(camera id, point id) of each camera-sorted column."""
    perm = problem.cam_perm.long()
    return problem.cam_idx.long()[perm], problem.pnt_idx.long()[perm]


def _out(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=x.device)


# The plain versions' per-row products and their segment sum (shared with
# K2's plain versions, `ops/fused_schur.py`).
def jtj_cam_rows(JR_t: torch.Tensor) -> torch.Tensor:
    """Per-row ``[Jc'Jc (81) | Jc'r (9)]`` of a (26, n) JR -> (n, 90)."""
    Jc = JR_t[:18].T.reshape(-1, 2, 9)
    r = JR_t[R0:R0 + 2].T
    return torch.cat([torch.einsum("nia,nid->nad", Jc, Jc).reshape(-1, 81),
                      torch.einsum("nia,ni->na", Jc, r)], dim=1)


def wcw_rows(W_t: torch.Tensor, hpp_inv_f: torch.Tensor,
             pnt: torch.Tensor) -> torch.Tensor:
    """Per-row ``W_k C[pnt_k] W_k'`` -> (n, 81); ``pnt`` the point id of
    each column of ``W_t``."""
    W = w_rows(W_t, hpp_inv_f.dtype)
    C = hpp_inv_f.reshape(-1, 3, 3)[pnt]
    return torch.einsum("nab,nbc,ndc->nad", W, C, W).reshape(-1, 81)


def w_op_rows(W_t: torch.Tensor, op: torch.Tensor,
              pnt: torch.Tensor) -> torch.Tensor:
    """Per-row ``W_k op[pnt_k]`` -> (n, 9); ``op`` (npnts, 3)."""
    return torch.einsum("nab,nb->na", w_rows(W_t, op.dtype), op[pnt])


def seg_sum(rows: torch.Tensor, ids: torch.Tensor, nseg: int) -> torch.Tensor:
    """Sums of ``rows`` by segment id -> (nseg, d), the plain versions'
    reduction (the JAX package's XLA ``segment_sum``)."""
    out = torch.zeros((nseg, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, ids, rows)


# ---------------------------------------------------------------- K6
def jtj_pnt_reduce(JR_t: torch.Tensor, problem: BAProblem) -> torch.Tensor:
    """Per-point ``[Hpp (9) | g_p (3)]`` = sums of ``[Jp'Jp | Jp'r]`` over
    the point-sorted rows -> (npnts, 12), in K5's point ranges
    (:func:`ops.plans.point_blocks`)."""
    if not JR_t.is_cuda:
        return _jtj_pnt_plain(JR_t, problem)
    n, npt = problem.nobs_pad, problem.npnts
    _cuda.require(JR_t, "JR_t", torch.float32, (26, n))
    _cuda.require_problem(problem)
    out = _out(JR_t, (npt, 12))
    p, blocks = problem, plans.point_blocks(problem)
    rc = _cuda.lib().ba_jtj_pnt_reduce(
        _cuda.ptr(JR_t), _cuda.ptr(p.pnt_idx), _cuda.ptr(p.pnt_starts),
        _cuda.ptr(blocks), blocks.shape[0] - 1, n, _cuda.ptr(out),
        _cuda.stream())
    _cuda.check(rc, "ba_jtj_pnt_reduce")
    _cuda.launched("seg_prod_pnt12")
    return out


def _jtj_pnt_plain(JR_t, problem):
    Jp = JR_t[JP0:JP0 + 6].T.reshape(-1, 2, 3)
    r = JR_t[R0:R0 + 2].T
    rows = torch.cat([torch.einsum("nib,nie->nbe", Jp, Jp).reshape(-1, 9),
                      torch.einsum("nib,ni->nb", Jp, r)], dim=1)
    out = torch.zeros((problem.npnts, 12), dtype=JR_t.dtype,
                      device=JR_t.device)
    return out.index_add_(0, problem.pnt_idx.long(), rows)


def jtj_cam_reduce(JR_cam_t: torch.Tensor,
                   problem: BAProblem) -> torch.Tensor:
    """Per-camera ``[Hcc (81) | g_c (9)]`` = sums of ``[Jc'Jc | Jc'r]``
    over the camera-sorted rows -> (ncams, 90)."""
    if not JR_cam_t.is_cuda:
        return _jtj_cam_plain(JR_cam_t, problem)
    n, nc = problem.nobs_pad, problem.ncams
    _cuda.require(JR_cam_t, "JR_cam_t", torch.float32, (26, n))
    _cuda.require_problem(problem)
    out = _out(JR_cam_t, (nc, 90))
    rc = _cuda.lib().ba_jtj_cam_reduce(
        _cuda.ptr(JR_cam_t), _cuda.ptr(problem.cam_starts), nc, n,
        _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, "ba_jtj_cam_reduce")
    _cuda.launched("seg_prod_cam90")
    return out


def _jtj_cam_plain(JR_cam_t, problem):
    return seg_sum(jtj_cam_rows(JR_cam_t), _cam_sorted_ids(problem)[0],
                   problem.ncams)


def wcw_cam_reduce(W_cam_t: torch.Tensor, problem: BAProblem,
                   hpp_inv_f: torch.Tensor) -> torch.Tensor:
    """Per-camera ``sum_k W_k C_k W_k'`` over the camera-sorted rows, with
    ``C_k = Hpp_inv[pnt_k]`` (npnts*9,) -> (ncams, 81): what the Schur
    diagonal blocks subtract from ``Hcc_l``."""
    if not W_cam_t.is_cuda:
        return _wcw_cam_plain(W_cam_t, problem, hpp_inv_f)
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    code = _cuda.w_code(W_cam_t, "W_cam_t", (27, n))
    _cuda.require(hpp_inv_f, "hpp_inv_f", torch.float32, (npt * 9,))
    _cuda.require_problem(problem)
    plan = plans.wcw_col_plan(problem)
    partial = _out(W_cam_t, (plan.nruns, 45))
    out = _out(W_cam_t, (nc, 81))
    rc = _cuda.lib().ba_wcw_cam_reduce(
        _cuda.ptr(W_cam_t), code, _cuda.ptr(hpp_inv_f),
        _cuda.cam_col_plan_arg(plan), nc, n, _cuda.ptr(partial),
        _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, "ba_wcw_cam_reduce")
    _cuda.launched("seg_prod_wcw81", W_cam_t)
    return out


def _wcw_cam_plain(W_cam_t, problem, hpp_inv_f):
    ci, pi = _cam_sorted_ids(problem)
    return seg_sum(wcw_rows(W_cam_t, hpp_inv_f, pi), ci, problem.ncams)


# ---------------------------------------------------------------- K5
def wtv_point_reduce(W_t: torch.Tensor, v: torch.Tensor, problem: BAProblem,
                     hpp_inv_f: torch.Tensor | None = None,
                     add_f: torch.Tensor | None = None,
                     sign: float = 1.0) -> torch.Tensor:
    """Per point ``sign * Hpp_inv (sum_k W_k' v[cam_k] + add)`` -> (npnts,
    3), over the point-sorted rows; ``v`` (ncams, 9). Without
    ``hpp_inv_f`` (npnts*9,) there is no fold, without ``add_f``
    (npnts*3,) no add."""
    if not W_t.is_cuda:
        return _wtv_point_plain(W_t, v, problem, hpp_inv_f, add_f, sign)
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    code = _cuda.w_code(W_t, "W_t", (27, n))
    _cuda.require(v, "v", torch.float32, (nc, 9))
    if hpp_inv_f is not None:
        _cuda.require(hpp_inv_f, "hpp_inv_f", torch.float32, (npt * 9,))
    if add_f is not None:
        _cuda.require(add_f, "add_f", torch.float32, (npt * 3,))
    _cuda.require_problem(problem)
    out = _out(W_t, (npt, 3))
    p, blocks = problem, plans.point_blocks(problem)
    rc = _cuda.lib().ba_wtv_point_reduce(
        _cuda.ptr(W_t), code, _cuda.ptr(v), _cuda.ptr(p.cam_idx),
        _cuda.ptr(p.pnt_idx), _cuda.ptr(p.pnt_starts), _cuda.ptr(blocks),
        blocks.shape[0] - 1, _cuda.ptr(hpp_inv_f), _cuda.ptr(add_f),
        float(sign), n, _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, "ba_wtv_point_reduce")
    _cuda.launched("seg_block_point", W_t)
    return out


def wtv_point_sum(W_t, v, problem) -> torch.Tensor:
    """Per point ``sum_k W_k' v[cam_k]`` -> (npnts, 3), by ``index_add_``
    (rows in any order)."""
    s = torch.zeros((problem.npnts, 3), dtype=v.dtype, device=v.device)
    return s.index_add_(0, problem.pnt_idx.long(),
                        torch.einsum("nab,na->nb", w_rows(W_t, v.dtype),
                                     v[problem.cam_idx.long()]))


def fold_point(s, hpp_inv_f=None, add_f=None, sign=1.0) -> torch.Tensor:
    """``sign * Hpp_inv (s + add)`` per point, as :func:`wtv_point_reduce`
    folds its sums ``s`` (npnts, 3)."""
    if add_f is not None:
        s = s + add_f.reshape(-1, 3)
    if hpp_inv_f is not None:
        s = torch.einsum("pab,pb->pa", hpp_inv_f.reshape(-1, 3, 3), s)
    return sign * s


def _wtv_point_plain(W_t, v, problem, hpp_inv_f=None, add_f=None,
                     sign=1.0):
    return fold_point(wtv_point_sum(W_t, v, problem), hpp_inv_f, add_f,
                      sign)


def wt_cam_reduce(W_cam_t: torch.Tensor, t: torch.Tensor,
                  problem: BAProblem) -> torch.Tensor:
    """Per camera ``sum_k W_k t[pnt_k]`` over the camera-sorted rows ->
    (ncams, 9); ``t`` (npnts, 3)."""
    if not W_cam_t.is_cuda:
        return _wt_cam_plain(W_cam_t, t, problem)
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    code = _cuda.w_code(W_cam_t, "W_cam_t", (27, n))
    _cuda.require(t, "t", torch.float32, (npt, 3))
    _cuda.require_problem(problem)
    plan = plans.cam_col_plan(problem)
    partial = _out(W_cam_t, (plan.nruns, 9))
    out = _out(W_cam_t, (nc, 9))
    rc = _cuda.lib().ba_wt_cam_reduce(
        _cuda.ptr(W_cam_t), code, _cuda.ptr(t), _cuda.cam_col_plan_arg(plan),
        nc, n, _cuda.ptr(partial), _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, "ba_wt_cam_reduce")
    _cuda.launched("seg_block_camera", W_cam_t)
    return out


def _wt_cam_plain(W_cam_t, t, problem):
    ci, pi = _cam_sorted_ids(problem)
    return seg_sum(w_op_rows(W_cam_t, t, pi), ci, problem.ncams)
