"""Snavely/BAL camera model on batched rows (PyTorch port of
`bundleadjustment_jl_tpu/models/camera.py`).

    P1 = R(r) @ X + t            (Rodrigues rotation by axis-angle r)
    P2 = -P1[:2] / P1[2]         (perspective divide, BAL negation)
    rho = 1 + k1*|P2|^2 + k2*|P2|^4
    proj = f * rho * P2

Camera layout (9,): ``(rx, ry, rz, tx, ty, tz, k1, k2, f)``. Every
function takes tensors with the vector in the last dimension and any
leading batch shape.
"""

from __future__ import annotations

import torch

# Below this squared angle the rotation switches to its 2nd-order Taylor
# form (exact to ~eps at that scale), as in the JAX package.
SMALL_THETA_SQ = 1e-24


def _vdot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def rodrigues_rotate(r: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Rotate ``X`` (..., 3) by the axis-angle vectors ``r`` (..., 3)."""
    theta_sq = _vdot3(r, r)
    safe = theta_sq > SMALL_THETA_SQ
    theta = torch.sqrt(torch.where(safe, theta_sq,
                                   torch.ones_like(theta_sq)))[..., None]
    k = r / theta
    c = torch.cos(theta)
    s = torch.sin(theta)
    rotated = (c * X + s * _cross(k, X)
               + (1.0 - c) * _vdot3(k, X)[..., None] * k)
    rxX = _cross(r, X)
    small = X + rxX + 0.5 * _cross(r, rxX)
    return torch.where(safe[..., None], rotated, small)


def distortion_factor(p, k1, k2):
    """rho(p) = 1 + k1 |p|^2 + k2 |p|^4."""
    n2 = _vdot3(p, p)
    return 1.0 + k1 * n2 + k2 * n2 * n2


def project_valid(cam: torch.Tensor, X: torch.Tensor):
    """Projection of ``X`` (..., 3) by ``cam`` (..., 9) -> ``(proj (..., 2),
    valid (...,))``; a point on the camera plane (z == 0) projects to 0
    and is flagged invalid."""
    p1 = rodrigues_rotate(cam[..., 0:3], X) + cam[..., 3:6]
    z = p1[..., 2]
    valid = z != 0.0
    z_safe = torch.where(valid, z, torch.ones_like(z))
    p2 = -p1[..., 0:2] / z_safe[..., None]
    k1, k2, f = cam[..., 6], cam[..., 7], cam[..., 8]
    proj = (f * distortion_factor(p2, k1, k2))[..., None] * p2
    return torch.where(valid[..., None], proj, torch.zeros_like(proj)), valid


def project(cam: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Full BAL projection (..., 2); zero where z == 0."""
    return project_valid(cam, X)[0]
