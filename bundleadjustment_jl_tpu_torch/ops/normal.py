"""Block form of the damped Gauss-Newton system (PyTorch port of the
parts of `bundleadjustment_jl_tpu/ops/normal.py` the fused solve uses).

    H = [[Hcc, Hcp], [Hcp', Hpp]],  Hcc: 9x9 camera blocks,
    Hpp: 3x3 point blocks, Hcp: one 9x3 block W_k per observation.

Damping is Levenberg's ``lambda I``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops.fused_assemble import assemble_scatter


class GNBlocks(NamedTuple):
    """The linearization's reduced blocks (flat storage, as in JAX)."""
    g_c_f: torch.Tensor   # (ncams*9,)   J_c' r
    g_p_f: torch.Tensor   # (npnts*3,)   J_p' r
    Hcc_f: torch.Tensor   # (ncams*81,)  camera diagonal blocks
    Hpp_f: torch.Tensor   # (npnts*9,)   point diagonal blocks
    obj: torch.Tensor     # ()           0.5 ||r||^2
    W_t: torch.Tensor     # (27, nobs_pad) per-observation W blocks

    @property
    def g_c(self):
        return self.g_c_f.reshape(-1, 9)

    @property
    def g_p(self):
        return self.g_p_f.reshape(-1, 3)

    @property
    def Hcc(self):
        return self.Hcc_f.reshape(-1, 9, 9)


def assemble_blocks(problem: BAProblem, cams=None, points=None) -> GNBlocks:
    """Linearize at (cams, points) with the fused assembly (K1)."""
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    W_t, hp12, hc90, obj = assemble_scatter(problem, cams, points)
    return GNBlocks(g_c_f=hc90[:, 81:90].reshape(-1),
                    g_p_f=hp12[:, 9:12].reshape(-1),
                    Hcc_f=hc90[:, :81].reshape(-1),
                    Hpp_f=hp12[:, :9].reshape(-1),
                    obj=obj, W_t=W_t)


def gradient_norm(blocks: GNBlocks) -> torch.Tensor:
    """||J'r|| over the full variable vector."""
    return torch.sqrt(torch.sum(blocks.g_c_f ** 2)
                      + torch.sum(blocks.g_p_f ** 2))


def inv3x3_damped_flat(Hpp_f: torch.Tensor, lam) -> torch.Tensor:
    """Adjugate inverse of ``Hpp + lam I`` on flat (P*9,) blocks
    (row-major ``3a+b``). Where ``det`` is not finite or not above
    ``8 tiny`` the block falls back to the inverse of its clamped
    diagonal, so the step stays finite and LM's reject logic takes over."""
    M = Hpp_f.reshape(-1, 9)
    tiny8 = torch.finfo(Hpp_f.dtype).tiny * 8.0
    a, b, c = M[:, 0] + lam, M[:, 1], M[:, 2]
    d, e, f = M[:, 3], M[:, 4] + lam, M[:, 5]
    g, h, i = M[:, 6], M[:, 7], M[:, 8] + lam
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = a * A + b * D + c * G
    ok = torch.isfinite(det) & (det > tiny8)
    one = torch.ones_like(det)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, one),
                          torch.zeros_like(det))
    z = torch.zeros_like(a)

    def dinv(x):
        return 1.0 / torch.clamp(torch.where(torch.isfinite(x), x, z),
                                 min=tiny8)

    da, de, di = dinv(a), dinv(e), dinv(i)
    cols = [torch.where(ok, adj * inv_det, fb) for adj, fb in
            zip((A, B, C, D, E, F, G, H, I),
                (da, z, z, z, de, z, z, z, di))]
    return torch.stack(cols, dim=-1).reshape(-1)


def damp(H: torch.Tensor, lam) -> torch.Tensor:
    """Add ``lam I`` to a batch of square blocks."""
    n = H.shape[-1]
    return H + lam * torch.eye(n, dtype=H.dtype, device=H.device)
