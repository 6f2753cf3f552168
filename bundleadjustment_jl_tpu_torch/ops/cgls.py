"""Damped CGLS on the full (camera + point) variable space (PyTorch port
of `bundleadjustment_jl_tpu/ops/cgls.py`).

Solves ``min ||J d + r||^2 + lambda ||d||^2`` directly on J, never
forming J'J: no Schur elimination, the step lives in the full (dc, dp)
space, preconditioned by the damped block diagonal of J'J (9x9 camera
blocks through a Cholesky factor, 3x3 point blocks in closed form).

J comes from the blocks' ``JR_t`` (26, nobs_pad), the split routes' K7
output (`ops/linearize.py`): rows 0-17 Jc (row ``9 i + a``), 18-23 Jp
(``18 + 3 i + b``), 24-25 the residual. The products with J and J' are
torch ops (gathers, per-row products, ``index_add_`` segment sums), as the
JAX package computes them with XLA; on CUDA ``index_add_`` sums with
atomics, so a repeat solve on the card may differ in the last bits.

On a point-aligned mesh shard (`ops/spmdctx.py`) the rows and points are
rank-local and the cameras replicated: the camera part of ``J' s`` is a
per-rank partial and is all-reduced, with the point part of ``gamma`` in
the same all-reduce; the row and point parts of each step's ``denom`` are
all-reduced together. On camera groups every point is on every rank and a
point's rows span ranks: ``J' s`` is all-reduced whole, before the damping
term and the preconditioner, and only the row part of ``denom``. Two
all-reduces a step, and every rank holds the same camera iterate and
scalars (on camera groups, the same point iterate too).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import spmdctx
from bundleadjustment_jl_tpu_torch.ops.linearize import JP0, R0
from bundleadjustment_jl_tpu_torch.ops.normal import (
    GNBlocks, damp, inv3x3_damped_flat)
from bundleadjustment_jl_tpu_torch.ops.pcg import (
    block_jacobi_apply, block_jacobi_inverse)
from bundleadjustment_jl_tpu_torch.utils.profiling import host_read


class CGLSResult(NamedTuple):
    dc: torch.Tensor        # (ncams, 9)
    dp: torch.Tensor        # (npnts, 3)
    iters: int
    rel_grad: torch.Tensor  # () final sqrt(gamma / gamma0)


def _jd(problem: BAProblem, JR_t: torch.Tensor, dc, dp) -> torch.Tensor:
    """``J d`` per row, (2, nobs_pad)."""
    n = JR_t.shape[1]
    Jc = JR_t[:JP0].reshape(2, 9, n)
    Jp = JR_t[JP0:R0].reshape(2, 3, n)
    return (torch.sum(Jc * dc[problem.cam_idx.long()].T, dim=1)
            + torch.sum(Jp * dp[problem.pnt_idx.long()].T, dim=1))


def _jts(problem: BAProblem, JR_t: torch.Tensor, s: torch.Tensor):
    """``J' s`` for ``s`` (2, nobs_pad) -> ((ncams, 9), (npnts, 3))."""
    n = JR_t.shape[1]
    Jc = JR_t[:JP0].reshape(2, 9, n)
    Jp = JR_t[JP0:R0].reshape(2, 3, n)
    vc = torch.zeros((9, problem.ncams), dtype=s.dtype, device=s.device)
    vp = torch.zeros((3, problem.npnts), dtype=s.dtype, device=s.device)
    vc.index_add_(1, problem.cam_idx.long(), torch.sum(Jc * s[:, None], 0))
    vp.index_add_(1, problem.pnt_idx.long(), torch.sum(Jp * s[:, None], 0))
    return vc.T.contiguous(), vp.T.contiguous()


def j_matvec(problem: BAProblem, blocks: GNBlocks, dc: torch.Tensor,
             dp: torch.Tensor) -> torch.Tensor:
    """``J @ d`` per observation: (nobs_pad, 2)."""
    return _jd(problem, blocks.JR_t, dc, dp).T


def jt_matvec(problem: BAProblem, blocks: GNBlocks, s: torch.Tensor):
    """``J' @ s`` for ``s`` (nobs_pad, 2) -> ((ncams, 9), (npnts, 3))."""
    return _jts(problem, blocks.JR_t, s.T)


def cgls_solve(problem: BAProblem, blocks: GNBlocks, lam, rtol,
               max_iters: int = 200) -> CGLSResult:
    """The damped LM step by preconditioned CGLS, to relative
    preconditioned-gradient tolerance ``rtol`` (``gamma <= rtol^2
    gamma0``) or ``max_iters`` steps; ``lam`` and ``rtol`` are rounded to
    the working dtype, as the JAX solver holds them. One host read a step:
    the continue flag."""
    JR_t = blocks.JR_t
    dt, dev = JR_t.dtype, JR_t.device
    lam = float(lam)
    sqlam = torch.sqrt(torch.tensor(lam, dtype=dt, device=dev))
    rtol_t = torch.tensor(float(rtol), dtype=dt, device=dev)
    Mc_inv = block_jacobi_inverse(damp(blocks.Hcc, lam))
    Pp = inv3x3_damped_flat(blocks.Hpp_f, lam).reshape(-1, 3, 3)

    def gradient(s1, s2c=None, s2p=None):
        """``v = J' s1 + sqrt(lam) s2``, ``z = M^{-1} v`` and ``gamma = v'
        z``: the camera partial of ``J' s1`` and the point part of
        ``gamma`` summed over the ranks in one all-reduce (on camera
        groups, ``J' s1`` whole)."""
        vc, vp = _jts(problem, JR_t, s1)
        if spmdctx.CAMERA_GROUPS:
            red = spmdctx.psum(torch.cat([vc.reshape(-1), vp.reshape(-1)]))
            vc, vp = (red[:vc.numel()].reshape(vc.shape),
                      red[vc.numel():].reshape(vp.shape))
        if s2p is not None:
            vp = vp + sqlam * s2p
        zp = torch.einsum("pab,pb->pa", Pp, vp)
        red = torch.cat([vc.reshape(-1), torch.sum(vp * zp)[None]])
        if not spmdctx.CAMERA_GROUPS:
            red = spmdctx.psum(red)
        vc = red[:-1].reshape(vc.shape)
        if s2c is not None:
            vc = vc + sqlam * s2c
        zc = block_jacobi_apply(Mc_inv, vc)
        return zc, zp, torch.sum(vc * zc) + red[-1]

    # x0 = 0; s1 = -r; s2 = -sqrt(lam) x = 0
    s1 = -JR_t[R0:R0 + 2]
    zc, zp, gamma = gradient(s1)
    gamma0_safe = torch.where(gamma <= 0.0, torch.ones_like(gamma), gamma)
    tol = rtol_t * rtol_t * gamma0_safe
    zero = torch.zeros_like(gamma)
    xc, xp = torch.zeros_like(zc), torch.zeros_like(zp)
    s2c, s2p = torch.zeros_like(zc), torch.zeros_like(zp)
    pc, pp = zc, zp
    it = 0
    while it < max_iters and bool(host_read(gamma > tol)):
        q1 = _jd(problem, JR_t, pc, pp)
        # the row and point parts, summed over the ranks together (the
        # point part only over the ranks' points)
        rows_pnts = torch.stack([torch.sum(q1 * q1), torch.sum(pp ** 2)])
        rows_pnts = (torch.stack([spmdctx.psum(rows_pnts[0]), rows_pnts[1]])
                     if spmdctx.CAMERA_GROUPS else spmdctx.psum(rows_pnts))
        denom = rows_pnts[0] + lam * (torch.sum(pc ** 2) + rows_pnts[1])
        pos = denom > 0.0
        alpha = torch.where(pos, gamma / torch.where(pos, denom,
                                                     torch.ones_like(denom)),
                            zero)
        xc = xc + alpha * pc
        xp = xp + alpha * pp
        s1 = s1 - alpha * q1
        s2c = s2c - alpha * sqlam * pc
        s2p = s2p - alpha * sqlam * pp
        zc, zp, gamma_new = gradient(s1, s2c, s2p)
        beta = torch.where(gamma > 0.0, gamma_new / gamma, zero)
        pc = zc + beta * pc
        pp = zp + beta * pp
        gamma = gamma_new
        it += 1
    rel = torch.sqrt(torch.clamp(gamma, min=0.0) / gamma0_safe)
    return CGLSResult(dc=xc, dp=xp, iters=it, rel_grad=rel)
