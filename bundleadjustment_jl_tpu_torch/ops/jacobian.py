"""The forward-mode AD cross-check of the analytic Jacobian blocks (PyTorch
port of `bundleadjustment_jl_tpu/ops/jacobian.py:jacobian_blocks_ad`).

The analytic blocks are the port's chain (`ops/chain.py:linearize`, the
plain version of K1 / K7 / K8's chain, which returns ``(r, Jc, Jp)`` of
the gathered rows); :func:`jacobian_blocks_ad` gives the same blocks by
``torch.func.jacfwd`` of the projection (`models/camera.py:project`, 12
forward tangents an observation), weighted by ``w``, to check them
against.
"""

from __future__ import annotations

from torch.func import jacfwd, vmap

from bundleadjustment_jl_tpu_torch.models.camera import project
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem

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
