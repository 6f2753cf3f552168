"""Batched residuals and Jacobian blocks, and their forward-mode AD
cross-check (PyTorch port of `bundleadjustment_jl_tpu/ops/jacobian.py`).

The analytic blocks are the port's chain (`ops/chain.py:linearize`, the
plain version of K1 / K7 / K8's chain, which returns ``(r, Jc, Jp)`` of
the gathered rows): :func:`residuals_and_jacobian` on a problem,
:func:`rj_raw` on raw observation arrays and :func:`rj_gathered` on
gathered rows are thin entry points to it, with the JAX package's names.
:func:`jacobian_blocks_ad` gives the same blocks by ``torch.func.jacfwd``
of the projection (`models/camera.py:project`, 12 forward tangents an
observation), weighted by ``w``, to check them against.
"""

from __future__ import annotations

from torch.func import jacfwd, vmap

from bundleadjustment_jl_tpu_torch.models.camera import project
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops.chain import linearize


def rj_gathered(c, X, pt2d, w):
    """``(r (N, 2), Jc (N, 2, 9), Jp (N, 2, 3))`` of gathered rows ``c``
    (N, 9) and ``X`` (N, 3), weighted by ``w`` and zero where the point
    lies on the camera plane."""
    return linearize(c, X, pt2d, w)


def rj_raw(cams, points, cam_idx, pnt_idx, pt2d, w):
    """:func:`rj_gathered` of the rows ``cams[cam_idx]``,
    ``points[pnt_idx]``."""
    return rj_gathered(cams[cam_idx.long()], points[pnt_idx.long()], pt2d, w)


def residuals_and_jacobian(problem: BAProblem, cams=None, points=None):
    """``(r, Jc, Jp)`` of every row of ``problem`` at (cams, points),
    shapes (nobs_pad, 2), (nobs_pad, 2, 9), (nobs_pad, 2, 3); padding rows
    (w = 0) are exact zeros."""
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    return rj_raw(cams, points, problem.cam_idx, problem.pnt_idx,
                  problem.pt2d, problem.w)


_jac_batch = vmap(jacfwd(project, argnums=(0, 1)))


def jacobian_blocks_ad(problem: BAProblem, cams=None, points=None):
    """``(Jc (n, 2, 9), Jp (n, 2, 3))`` of every row by forward-mode AD of
    the projection, weighted by ``w``."""
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    Jc, Jp = _jac_batch(cams[problem.cam_idx.long()],
                        points[problem.pnt_idx.long()])
    w = problem.w[:, None, None]
    return Jc * w, Jp * w
