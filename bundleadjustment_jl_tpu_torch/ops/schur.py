"""Schur-complement elimination of the points on the fused route (PyTorch
port of `bundleadjustment_jl_tpu/ops/schur.py:214-320`).

Eliminating the 3x3 point blocks of the damped normal equations gives the
reduced camera system

    S dc = b,  S = Hcc_l - W Hpp_l^{-1} W',  b = -g_c + W Hpp_l^{-1} g_p
    dp = -Hpp_l^{-1} (g_p + W' dc)

``S`` is never formed: :func:`schur_matvec` applies it through one K3
launch, :func:`reduce_and_diag` gets ``b`` and the exact diagonal blocks
of ``S`` from one K2 launch, and :func:`back_substitute_quad` gets ``dp``
and the ``||J d||^2`` cross term from one more K3 launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops.fused_schur import (
    cam_reduce_wcw_rhs, matvec_cam_scatter)
from bundleadjustment_jl_tpu_torch.ops.normal import (
    GNBlocks, damp, inv3x3_damped_flat)


class SchurSystem(NamedTuple):
    """The damped, point-eliminated camera system at one lambda."""
    Hcc_l_f: torch.Tensor    # (ncams*81,) damped camera blocks
    Hpp_inv_f: torch.Tensor  # (npnts*9,) inverse damped point blocks
    b_f: torch.Tensor        # (ncams*9,) reduced right-hand side
    g_p_f: torch.Tensor      # (npnts*3,) point gradient
    W_t: torch.Tensor        # (27, nobs_pad)
    problem: BAProblem

    @property
    def Hcc_l(self):
        return self.Hcc_l_f.reshape(-1, 9, 9)

    @property
    def b(self):
        return self.b_f.reshape(-1, 9)


def reduce_and_diag(problem: BAProblem, blocks: GNBlocks, lam):
    """(SchurSystem, exact diagonal 9x9 blocks of S) at ``lam``: the
    reduced RHS correction and ``sum W Hpp_inv W'`` from one K2 launch."""
    Hcc_l = damp(blocks.Hcc, lam)
    Hpp_inv_f = inv3x3_damped_flat(blocks.Hpp_f, lam)
    tmp = torch.einsum("pab,pb->pa", Hpp_inv_f.reshape(-1, 3, 3),
                       blocks.g_p)
    out = cam_reduce_wcw_rhs(blocks.W_t, problem, Hpp_inv_f, tmp)
    sys = SchurSystem(Hcc_l_f=Hcc_l.reshape(-1), Hpp_inv_f=Hpp_inv_f,
                      b_f=(-blocks.g_c + out[:, 81:90]).reshape(-1),
                      g_p_f=blocks.g_p_f, W_t=blocks.W_t, problem=problem)
    return sys, Hcc_l - out[:, :81].reshape(-1, 9, 9)


def schur_matvec(sys: SchurSystem, v: torch.Tensor) -> torch.Tensor:
    """Matrix-free ``S @ v`` for ``v`` (ncams, 9)."""
    u = torch.einsum("cab,cb->ca", sys.Hcc_l, v)
    return u - matvec_cam_scatter(sys.W_t, v, sys.problem, sys.Hpp_inv_f)


def back_substitute_quad(problem: BAProblem, blocks: GNBlocks,
                         sys: SchurSystem, dc: torch.Tensor):
    """``(dp (npnts, 3), ||J d||^2)``: K3 with ``g_p`` folded and
    ``sign = -1`` yields ``dp`` and ``segsum_cam(W dp)`` together;
    ``||J d||^2 = dc' Hcc dc + 2 dc . segsum_cam(W dp) + dp' Hpp dp``."""
    cross_cam, dp = matvec_cam_scatter(
        sys.W_t, dc, problem, sys.Hpp_inv_f, gp_f=sys.g_p_f, sign=-1.0,
        with_dp=True)
    t_c = torch.sum(dc * torch.einsum("cab,cb->ca", blocks.Hcc, dc))
    t_p = torch.sum(dp * torch.einsum(
        "pab,pb->pa", blocks.Hpp_f.reshape(-1, 3, 3), dp))
    cross = torch.sum(cross_cam * dc)
    return dp, t_c + 2.0 * cross + t_p
