"""Fused Schur-complement reductions over W (K2, K3) — the counterpart of
`bundleadjustment_jl_tpu/ops/pallas_schur.py` on the camera-scatter route.

Same device rule as `ops/fused_assemble.py`: CUDA float32 tensors launch
the hand-written kernels (``csrc/cam_reduce.cu``, ``csrc/matvec.cu``), CPU
tensors take the plain PyTorch version beside each wrapper, CUDA float64
raises. ``W_t`` is the (27, nobs_pad) structure-of-arrays W of the
assembly (row ``3a+b`` = ``W[a, b]``); per-point operands are flat
(npnts*9,) / (npnts*3,) or (npnts, 3).
"""

from __future__ import annotations

import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import _cuda


def _rows(W_t: torch.Tensor) -> torch.Tensor:
    """(27, n) structure-of-arrays -> (n, 9, 3) blocks."""
    return W_t.reshape(9, 3, -1).permute(2, 0, 1)


def cam_reduce_wcw_rhs(W_t: torch.Tensor, problem: BAProblem,
                       hpp_inv_f: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
    """Per-camera ``[sum_k W_k C_p W_k' (81) | sum_k W_k t_p (9)]`` ->
    (ncams, 90), with ``C = Hpp_inv`` (npnts*9,) and ``t`` (npnts, 3)."""
    if not W_t.is_cuda:
        return _cam_reduce_wcw_rhs_plain(W_t, problem, hpp_inv_f, t)
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    _cuda.require(W_t, "W_t", torch.float32, (27, n))
    _cuda.require(hpp_inv_f, "hpp_inv_f", torch.float32, (npt * 9,))
    _cuda.require(t, "t", torch.float32, (npt, 3))
    _cuda.require_problem(problem)
    out = torch.empty((nc, 90), dtype=torch.float32, device=W_t.device)
    rc = _cuda.lib().ba_cam_reduce_wcw_rhs(
        _cuda.ptr(W_t), _cuda.ptr(problem.pnt_idx),
        _cuda.ptr(problem.cam_perm), _cuda.ptr(problem.cam_starts),
        _cuda.ptr(hpp_inv_f), _cuda.ptr(t), nc, n, _cuda.ptr(out),
        _cuda.stream())
    _cuda.check(rc, "ba_cam_reduce_wcw_rhs")
    _cuda.LAUNCHES["cam_reduce"] += 1
    return out


def _cam_reduce_wcw_rhs_plain(W_t, problem, hpp_inv_f, t):
    pi = problem.pnt_idx.long()
    W = _rows(W_t)
    C = hpp_inv_f.reshape(-1, 3, 3)[pi]
    wcw = torch.einsum("nab,nbc,ndc->nad", W, C, W).reshape(-1, 81)
    wt = torch.einsum("nab,nb->na", W, t[pi])
    out = torch.zeros((problem.ncams, 90), dtype=W_t.dtype,
                      device=W_t.device)
    return out.index_add_(0, problem.cam_idx.long(),
                          torch.cat([wcw, wt], dim=1))


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
        out, t = _matvec_plain(W_t, v, problem, hpp_inv_f, gp_f, sign)
        return (out, t) if with_dp else out
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    _cuda.require(W_t, "W_t", torch.float32, (27, n))
    _cuda.require(v, "v", torch.float32, (nc, 9))
    _cuda.require(hpp_inv_f, "hpp_inv_f", torch.float32, (npt * 9,))
    if gp_f is not None:
        _cuda.require(gp_f, "gp_f", torch.float32, (npt * 3,))
    _cuda.require_problem(problem)
    t = torch.empty((npt, 3), dtype=torch.float32, device=W_t.device)
    out = torch.empty((nc, 9), dtype=torch.float32, device=W_t.device)
    p = problem
    rc = _cuda.lib().ba_matvec(
        _cuda.ptr(W_t), _cuda.ptr(v), _cuda.ptr(p.cam_idx),
        _cuda.ptr(p.pnt_idx), _cuda.ptr(p.pnt_starts), _cuda.ptr(p.cam_perm),
        _cuda.ptr(p.cam_starts), _cuda.ptr(hpp_inv_f), _cuda.ptr(gp_f),
        float(sign), nc, npt, n, _cuda.ptr(t), _cuda.ptr(out),
        _cuda.stream())
    _cuda.check(rc, "ba_matvec")
    _cuda.LAUNCHES["matvec"] += 1
    return (out, t) if with_dp else out


def _matvec_plain(W_t, v, problem, hpp_inv_f, gp_f, sign):
    ci = problem.cam_idx.long()
    pi = problem.pnt_idx.long()
    W = _rows(W_t)
    s = torch.zeros((problem.npnts, 3), dtype=W_t.dtype, device=W_t.device)
    s.index_add_(0, pi, torch.einsum("nab,na->nb", W, v[ci]))
    if gp_f is not None:
        s = s + gp_f.reshape(-1, 3)
    t = sign * torch.einsum("pab,pb->pa", hpp_inv_f.reshape(-1, 3, 3), s)
    out = torch.zeros((problem.ncams, 9), dtype=W_t.dtype, device=W_t.device)
    out.index_add_(0, ci, torch.einsum("nab,nb->na", W, t[pi]))
    return out, t
