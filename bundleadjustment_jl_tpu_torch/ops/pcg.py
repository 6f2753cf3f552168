"""Block-Jacobi preconditioned conjugate gradient and the power-series
solve on the reduced camera system (PyTorch port of
`bundleadjustment_jl_tpu/ops/pcg.py`).

PyTorch runs eagerly, so the CG loop is a Python loop over device
tensors. Each step makes exactly one host read: the continue flag
(``||r|| > tol`` and no breakdown), which stays on the device until then;
each is counted (`utils/profiling.py:host_read`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from bundleadjustment_jl_tpu_torch.models.problem import HALF_DTYPES
from bundleadjustment_jl_tpu_torch.utils.profiling import host_read

# Consecutive CG steps without a 4% best-residual improvement after which
# `pcg` stops when `stagnation_window > 0` (the JAX package's default).
STAGNATION_WINDOW = 8


class PCGResult(NamedTuple):
    x: torch.Tensor        # (ncams, 9) solution
    iters: int             # matvecs used (besides the one for r0)
    rel_res: torch.Tensor  # () final ||S x - b|| / ||b||


def block_cholesky(blocks: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factors of SPD blocks (ncams, 9, 9). A block
    that is not numerically SPD gives NaN in its lower triangle, as JAX's
    Cholesky does. A 2-byte dtype is factored in float32 and the factors
    stay float32, as in the JAX package."""
    if blocks.dtype in HALF_DTYPES:
        blocks = blocks.float()
    L, info = torch.linalg.cholesky_ex(blocks)
    return torch.where((info == 0)[:, None, None], L,
                       torch.full_like(L, float("nan")).tril())


def block_cho_solve(L: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M^{-1} v`` for ``v`` (ncams, 9) by the factors of
    :func:`block_cholesky` (two triangular solves, in ``L``'s dtype),
    rounded to ``v``'s dtype."""
    y = torch.linalg.solve_triangular(L, v.to(L.dtype)[..., None],
                                      upper=False)
    z = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return z[..., 0].to(v.dtype)


def block_jacobi_inverse(blocks: torch.Tensor) -> torch.Tensor:
    """Explicit batched inverse of the SPD preconditioner blocks
    (ncams, 9, 9), through :func:`block_cholesky`: a block that is not
    numerically SPD yields NaN, and the NaN step is then rejected by the
    LM driver instead of stopping the solve. The inverse of a 2-byte
    dtype's blocks is float32."""
    L = block_cholesky(blocks)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    y = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.einsum("cka,ckb->cab", y, y)


def block_jacobi_apply(Minv: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M^{-1} v`` for ``v`` (ncams, 9), in ``Minv``'s dtype and rounded
    to ``v``'s."""
    return torch.einsum("cab,cb->ca", Minv, v.to(Minv.dtype)).to(v.dtype)


def _dot(u, v):
    return torch.sum(u * v)


def pcg(matvec: Callable, b: torch.Tensor, precond: Callable, rtol,
        max_iters: int = 100, x0=None,
        stagnation_window: int = 0) -> PCGResult:
    """Preconditioned CG for ``S x = b`` with S SPD, matrix-free.

    Stops when ``||r|| <= rtol ||b||``, after ``max_iters`` matvecs, on
    breakdown (``p' S p <= 0``: the current iterate is returned), or —
    with ``stagnation_window > 0`` — after that many steps without a 4%
    best-residual improvement. The initial residual costs one matvec even
    when ``x0`` is zero, as in the JAX package."""
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = torch.sqrt(_dot(b, b))
    bnorm_safe = torch.where(bnorm == 0.0, torch.ones_like(bnorm), bnorm)
    tol = rtol * bnorm_safe

    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = _dot(r, z)
    down = torch.zeros((), dtype=torch.bool, device=b.device)
    best_r2 = _dot(r, r)
    stag = torch.zeros((), dtype=torch.int32, device=b.device)
    zero = torch.zeros_like(rz)
    it = 0
    while it < max_iters:
        live = torch.logical_not(down) & (torch.sqrt(_dot(r, r)) > tol)
        if stagnation_window > 0:
            live = live & (stag < stagnation_window)
        if not bool(host_read(live)):
            break
        Sp = matvec(p)
        pSp = _dot(p, Sp)
        down = pSp <= 0.0
        alpha = torch.where(down, zero,
                            rz / torch.where(down, torch.ones_like(pSp), pSp))
        x = x + alpha * p
        r = r - alpha * Sp
        z = precond(r)
        rz_new = _dot(r, z)
        beta = torch.where(rz > 0.0, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
        r2 = _dot(r, r)
        stag = torch.where(r2 < 0.96 * best_r2, torch.zeros_like(stag),
                           stag + 1)
        best_r2 = torch.minimum(best_r2, r2)
        it += 1
    return PCGResult(x=x, iters=it,
                     rel_res=torch.sqrt(_dot(r, r)) / bnorm_safe)


def power_series(matvec: Callable, b: torch.Tensor, m_apply: Callable,
                 m_solve: Callable, rtol, max_terms: int = 50) -> PCGResult:
    """Power-series (preconditioned Richardson) solve of ``S x = b``, the
    JAX package's ``power_series`` ("Power Bundle Adjustment",
    arXiv:2204.12834): with ``S = M - N`` (M the damped block-diagonal
    camera part), iterate ``x <- M^{-1} (b + M x - S x)`` from ``x =
    M^{-1} b``, one ``matvec`` a term, until ``||b - S x|| <= rtol
    ||b||`` (the residual of the iterate before the term's update) or
    ``max_terms`` terms. ``m_apply(x) = M x``, ``m_solve(y) = M^{-1} y``.
    One host read a term (the continue flag), as ``pcg`` makes."""
    bnorm = torch.sqrt(_dot(b, b))
    bnorm_safe = torch.where(bnorm == 0.0, torch.ones_like(bnorm), bnorm)
    tol = rtol * bnorm_safe
    x = m_solve(b)
    res = torch.full_like(bnorm, float("inf"))
    it = 0
    while it < max_terms and bool(host_read(res > tol)):
        Sx = matvec(x)
        res = torch.sqrt(torch.sum((b - Sx) ** 2))
        x = m_solve(b + m_apply(x) - Sx)
        it += 1
    return PCGResult(x=x, iters=it, rel_res=res / bnorm_safe)


def forcing_rtol(grad_norm, floor=1e-10, cap=1e-2):
    """Eisenstat-Walker-style forcing term ``clip(sqrt(||g||), floor,
    cap)`` on a host scalar (numpy, in its dtype) — loose early,
    near-direct accuracy at convergence."""
    return np.clip(np.sqrt(grad_norm), floor, cap)
