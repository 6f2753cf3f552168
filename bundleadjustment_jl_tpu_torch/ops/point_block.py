"""The Schur elimination's per-point 3x3 block work: the damped inverse
with ``Hpp_inv g_p`` (stage 2) and the point term ``dp' Hpp dp`` of
``||J d||^2`` (stage 5), over the flat point blocks ``Hpp_f`` (npnts*9,
row-major ``3a+b``).

The JAX package leaves this work to XLA (`ops/normal.py:inv3x3_damped_flat`
and the einsums of `ops/schur.py`); the port runs it in one hand-written
source, ``csrc/point_block.cu``. Same device rule as
`ops/fused_assemble.py`: CUDA float32 tensors launch the kernels, CPU
tensors take the plain PyTorch version beside each wrapper (the code the
port ran before the kernels, unchanged), CUDA float64 raises.

In a 2-byte working dtype the solve's stage table (`normal.stages_for`)
hands ``Hpp_f`` over in that dtype and the vectors widened to float32;
the wrapper widens ``Hpp_f`` too and the kernel rounds where the plain
version computes in the working dtype (the inverse, the hat, the
product's factors), so both take the product from the inverse rounded to
that dtype.
"""

from __future__ import annotations

import torch

from bundleadjustment_jl_tpu_torch.models.problem import HALF_DTYPES
from bundleadjustment_jl_tpu_torch.ops import _cuda


def inv3x3_damped_flat(Hpp_f: torch.Tensor, lam) -> torch.Tensor:
    """Adjugate inverse of ``Hpp + lam I`` on flat (P*9,) blocks
    (row-major ``3a+b``). Where ``det`` is not finite or not above
    ``8 tiny`` the block falls back to the inverse of its clamped
    diagonal, so the step stays finite and LM's reject logic takes over.
    A 2-byte dtype computes in float32 and rounds the inverse back, as in
    the JAX package (its determinant products underflow there)."""
    if Hpp_f.dtype in HALF_DTYPES:
        return inv3x3_damped_flat(Hpp_f.float(), lam).to(Hpp_f.dtype)
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


def hpp_dot(Hpp_f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-point 3x3 block times (npnts, 3)."""
    return torch.einsum("pab,pb->pa", Hpp_f.reshape(-1, 3, 3), x)


def _operand(Hpp_f: torch.Tensor) -> tuple[int, torch.Tensor]:
    """(the working dtype's code, ``Hpp_f`` as the kernels read it): a
    2-byte ``Hpp_f`` widened to float32 under its `_cuda.W_CODES` code, any
    other as it is under 0."""
    if Hpp_f.dtype in HALF_DTYPES:
        return _cuda.W_CODES[Hpp_f.dtype], Hpp_f.float()
    return 0, Hpp_f


def _aligned(*ts: torch.Tensor) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


def point_inv_rhs(Hpp_f: torch.Tensor, g_p_f: torch.Tensor, lam,
                  w_scale: torch.Tensor | None = None):
    """``(Hpp_inv_f (npnts*9,), Hpp_inv g (npnts, 3))``: the damped inverse
    of :func:`inv3x3_damped_flat` at ``lam`` and its product with ``g =
    g_p_f``; with a float16 W's range scale ``w_scale`` (a 0-d tensor on
    the device, `GNBlocks.w_scale`) both hatted, ``Hpp_inv / s^2`` and
    ``g s``."""
    if not Hpp_f.is_cuda:
        return _point_inv_rhs_plain(Hpp_f, g_p_f, lam, w_scale)
    rnd, Hpp_f = _operand(Hpp_f)
    npt = Hpp_f.shape[0] // 9
    _cuda.require(Hpp_f, "Hpp_f", torch.float32, (npt * 9,))
    _cuda.require(g_p_f, "g_p_f", torch.float32, (npt * 3,))
    scale_code = 0
    if w_scale is not None:
        scale_code = _cuda.w_code(w_scale, "w_scale", ())
    hinv = torch.empty_like(Hpp_f)
    prod = torch.empty((npt, 3), dtype=torch.float32, device=Hpp_f.device)
    rc = _cuda.lib().ba_point_inv(
        _cuda.ptr(Hpp_f), _cuda.ptr(g_p_f), float(lam), _cuda.ptr(w_scale),
        scale_code, rnd, npt, _aligned(Hpp_f, g_p_f, hinv, prod),
        _cuda.ptr(hinv), _cuda.ptr(prod), _cuda.stream())
    _cuda.check(rc, "ba_point_inv")
    _cuda.launched("point_inv")
    return hinv, prod


def _point_inv_rhs_plain(Hpp_f, g_p_f, lam, w_scale=None):
    """Plain version of :func:`point_inv_rhs`: ``g`` in the inverse's
    dtype, as the solve held it before its stage table widened it."""
    inv, g = inv3x3_damped_flat(Hpp_f, lam), g_p_f
    if w_scale is not None:
        inv, g = inv / torch.square(w_scale), g * w_scale
    return inv, hpp_dot(inv, g.to(inv.dtype).reshape(-1, 3))


def point_quad(Hpp_f: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """``sum_p dp_p . (Hpp_p dp_p)`` (0-d), ``dp`` (npnts, 3): a
    fixed-order sum on the card (the same bits on every call)."""
    if not Hpp_f.is_cuda:
        return _point_quad_plain(Hpp_f, dp)
    rnd, Hpp_f = _operand(Hpp_f)
    npt = Hpp_f.shape[0] // 9
    _cuda.require(Hpp_f, "Hpp_f", torch.float32, (npt * 9,))
    _cuda.require(dp, "dp", torch.float32, (npt, 3))
    so = _cuda.lib()
    part = torch.empty((so.ba_point_blocks(npt),), dtype=torch.float32,
                       device=Hpp_f.device)
    out = torch.empty((1,), dtype=torch.float32, device=Hpp_f.device)
    rc = so.ba_point_quad(_cuda.ptr(Hpp_f), _cuda.ptr(dp), rnd, npt,
                          _aligned(Hpp_f, dp), _cuda.ptr(part),
                          _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, "ba_point_quad")
    _cuda.launched("point_quad")
    return out[0]


def _point_quad_plain(Hpp_f, dp):
    """Plain version of :func:`point_quad`: ``dp`` in ``Hpp_f``'s dtype,
    as the solve held it before its stage table widened it."""
    dp = dp.to(Hpp_f.dtype)
    return torch.sum(dp * hpp_dot(Hpp_f, dp))
