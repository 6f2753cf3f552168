"""Batched reprojection residuals (PyTorch port of
`bundleadjustment_jl_tpu/ops/residuals.py`).

``res_k = proj(C_cam(k), X_pnt(k)) - pt2d_k``, weighted by ``w_k`` (0 for
padded rows). A z == 0 observation is zeroed entirely, residual and all.
"""

from __future__ import annotations

import torch

from bundleadjustment_jl_tpu_torch.models.camera import project_valid
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem


def residuals(problem: BAProblem, cams=None, points=None) -> torch.Tensor:
    """Weighted residuals (nobs_pad, 2); padded rows are exactly 0."""
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    c = cams[problem.cam_idx.long()]
    X = points[problem.pnt_idx.long()]
    proj, valid = project_valid(c, X)
    w = problem.w * valid.to(problem.w.dtype)
    return (proj - problem.pt2d) * w[:, None]


def objective(problem: BAProblem, cams=None, points=None) -> torch.Tensor:
    """0.5 * ||r||^2."""
    r = residuals(problem, cams, points)
    return 0.5 * torch.sum(r * r)
