"""Schur-complement elimination of the points (PyTorch port of
`bundleadjustment_jl_tpu/ops/schur.py`) on the two kernel routes.

Eliminating the 3x3 point blocks of the damped normal equations gives the
reduced camera system

    S dc = b,  S = Hcc_l - W Hpp_l^{-1} W',  b = -g_c + W Hpp_l^{-1} g_p
    dp = -Hpp_l^{-1} (g_p + W' dc)

``S`` is never formed. Each entry point dispatches, as the JAX package
does, on whether the blocks carry the camera-sorted ``W_cam_t``:

- fused route (``W_cam_t`` None): :func:`reduce_and_diag` gets ``b`` and
  the exact diagonal blocks of ``S`` from one K2 launch,
  :func:`schur_matvec` applies ``S`` through one K3 launch, and
  :func:`back_substitute_quad` gets ``dp`` and the ``||J d||^2`` cross
  term from one more K3 launch;
- camera-sorted route: :func:`reduce_system` (K5 camera direction) and
  :func:`schur_diag_blocks` (K6 ``W C W'``), the two-pass matvec (K5 point
  direction with the fold, then K5 camera direction),
  :func:`back_substitute` (K5 point direction) and :func:`quad_form` (K5
  camera direction).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops.fused_schur import (
    cam_reduce_wcw_rhs, matvec_cam_scatter)
from bundleadjustment_jl_tpu_torch.ops.normal import (
    GNBlocks, damp, inv3x3_damped_flat)
from bundleadjustment_jl_tpu_torch.ops.seg_reduce import (
    wcw_cam_reduce, wt_cam_reduce, wtv_point_reduce)


class SchurSystem(NamedTuple):
    """The damped, point-eliminated camera system at one lambda."""
    Hcc_l_f: torch.Tensor    # (ncams*81,) damped camera blocks
    Hpp_inv_f: torch.Tensor  # (npnts*9,) inverse damped point blocks
    b_f: torch.Tensor        # (ncams*9,) reduced right-hand side
    g_p_f: torch.Tensor      # (npnts*3,) point gradient
    W_t: torch.Tensor        # (27, nobs_pad)
    problem: BAProblem
    W_cam_t: torch.Tensor | None = None  # camera-sorted route only

    @property
    def Hcc_l(self):
        return self.Hcc_l_f.reshape(-1, 9, 9)

    @property
    def b(self):
        return self.b_f.reshape(-1, 9)


def _hpp_dot(Hpp_f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-point 3x3 block times (npnts, 3)."""
    return torch.einsum("pab,pb->pa", Hpp_f.reshape(-1, 3, 3), x)


def reduce_system(problem: BAProblem, blocks: GNBlocks, lam) -> SchurSystem:
    """Damp with ``lam`` and form ``b = -g_c + segsum_cam(W_k (Hpp_inv
    g_p)[pnt_k])`` on the camera-sorted route (K5 camera direction)."""
    Hcc_l = damp(blocks.Hcc, lam)
    Hpp_inv_f = inv3x3_damped_flat(blocks.Hpp_f, lam)
    corr = wt_cam_reduce(blocks.W_cam_t, _hpp_dot(Hpp_inv_f, blocks.g_p),
                         problem)
    return SchurSystem(Hcc_l_f=Hcc_l.reshape(-1), Hpp_inv_f=Hpp_inv_f,
                       b_f=(-blocks.g_c + corr).reshape(-1),
                       g_p_f=blocks.g_p_f, W_t=blocks.W_t, problem=problem,
                       W_cam_t=blocks.W_cam_t)


def schur_diag_blocks(sys: SchurSystem) -> torch.Tensor:
    """Exact diagonal 9x9 blocks of S, ``Hcc_l - sum W Hpp_inv W'``, on the
    camera-sorted route (K6)."""
    wcw = wcw_cam_reduce(sys.W_cam_t, sys.problem, sys.Hpp_inv_f)
    return sys.Hcc_l - wcw.reshape(-1, 9, 9)


def reduce_and_diag(problem: BAProblem, blocks: GNBlocks, lam):
    """(SchurSystem, exact diagonal 9x9 blocks of S) at ``lam``. On the
    fused route the reduced RHS correction and ``sum W Hpp_inv W'`` come
    from one K2 launch; on the camera-sorted route this is
    :func:`reduce_system` and :func:`schur_diag_blocks`."""
    if blocks.W_cam_t is not None:
        sys = reduce_system(problem, blocks, lam)
        return sys, schur_diag_blocks(sys)
    Hcc_l = damp(blocks.Hcc, lam)
    Hpp_inv_f = inv3x3_damped_flat(blocks.Hpp_f, lam)
    out = cam_reduce_wcw_rhs(blocks.W_t, problem, Hpp_inv_f,
                             _hpp_dot(Hpp_inv_f, blocks.g_p))
    sys = SchurSystem(Hcc_l_f=Hcc_l.reshape(-1), Hpp_inv_f=Hpp_inv_f,
                      b_f=(-blocks.g_c + out[:, 81:90]).reshape(-1),
                      g_p_f=blocks.g_p_f, W_t=blocks.W_t, problem=problem)
    return sys, Hcc_l - out[:, :81].reshape(-1, 9, 9)


def schur_matvec(sys: SchurSystem, v: torch.Tensor) -> torch.Tensor:
    """Matrix-free ``S @ v`` for ``v`` (ncams, 9)."""
    u = torch.einsum("cab,cb->ca", sys.Hcc_l, v)
    if sys.W_cam_t is None:
        return u - matvec_cam_scatter(sys.W_t, v, sys.problem,
                                      sys.Hpp_inv_f)
    t = wtv_point_reduce(sys.W_t, v, sys.problem, hpp_inv_f=sys.Hpp_inv_f)
    return u - wt_cam_reduce(sys.W_cam_t, t, sys.problem)


def back_substitute(sys: SchurSystem, dc: torch.Tensor) -> torch.Tensor:
    """The point step ``dp = -Hpp_inv (g_p + W' dc)`` (npnts, 3), on the
    camera-sorted route (K5 point direction with the fold and add)."""
    return wtv_point_reduce(sys.W_t, dc, sys.problem,
                            hpp_inv_f=sys.Hpp_inv_f, add_f=sys.g_p_f,
                            sign=-1.0)


def _quad(blocks: GNBlocks, dc, dp, cross_cam) -> torch.Tensor:
    """``||J d||^2 = dc' Hcc dc + 2 dc . cross_cam + dp' Hpp dp`` with
    ``cross_cam = segsum_cam(W_k dp[pnt_k])`` (ncams, 9)."""
    t_c = torch.sum(dc * torch.einsum("cab,cb->ca", blocks.Hcc, dc))
    t_p = torch.sum(dp * _hpp_dot(blocks.Hpp_f, dp))
    return t_c + 2.0 * torch.sum(cross_cam * dc) + t_p


def quad_form(problem: BAProblem, blocks: GNBlocks, dc: torch.Tensor,
              dp: torch.Tensor) -> torch.Tensor:
    """``||J d||^2`` from the assembled blocks, its cross term on the
    camera-sorted route (K5 camera direction)."""
    return _quad(blocks, dc, dp, wt_cam_reduce(blocks.W_cam_t, dp, problem))


def back_substitute_quad(problem: BAProblem, blocks: GNBlocks,
                         sys: SchurSystem, dc: torch.Tensor):
    """``(dp (npnts, 3), ||J d||^2)``. On the fused route K3 with ``g_p``
    folded and ``sign = -1`` yields ``dp`` and the cross term's camera
    sums together; on the camera-sorted route this is
    :func:`back_substitute` and :func:`quad_form`."""
    if sys.W_cam_t is not None:
        dp = back_substitute(sys, dc)
        return dp, quad_form(problem, blocks, dc, dp)
    cross_cam, dp = matvec_cam_scatter(
        sys.W_t, dc, problem, sys.Hpp_inv_f, gp_f=sys.g_p_f, sign=-1.0,
        with_dp=True)
    return dp, _quad(blocks, dc, dp, cross_cam)
