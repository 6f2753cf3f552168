"""The linearization on the camera-sorted route (K7) — the counterpart of
`bundleadjustment_jl_tpu/ops/pallas_linearize.py:linearize_w_kminor`.

Same device rule as `ops/fused_assemble.py`: CUDA float32 tensors launch
the hand-written kernel (``csrc/linearize.cu``), CPU tensors take the
plain PyTorch version beside it, CUDA float64 raises.

Outputs are structure-of-arrays in the point-sorted row order, the JAX
package's ``JR_t[:26]`` and ``W_t[:27]``:

- ``JR_t`` (26, nobs_pad): rows 0-17 Jc (row ``9i+a``), 18-23 Jp
  (``18+3i+b``), 24-25 the weighted residual;
- ``W_t`` (27, nobs_pad): row ``3a+b`` holds ``W[a, b]`` of
  ``W_k = Jc_k' Jp_k``.
"""

from __future__ import annotations

import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import _cuda
from bundleadjustment_jl_tpu_torch.ops.chain import linearize

# Row offsets of Jp and the residual in JR_t (Jc starts at row 0).
JP0, R0 = 18, 24


def linearize_w_kminor(problem: BAProblem, cams: torch.Tensor,
                       points: torch.Tensor):
    """Linearize every observation row at (cams, points) -> ``(JR_t
    (26, n), W_t (27, n))``."""
    if not cams.is_cuda:
        return _linearize_plain(problem, cams, points)
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    _cuda.require(cams, "cams", torch.float32, (nc, 9))
    _cuda.require(points, "points", torch.float32, (npt, 3))
    _cuda.require_problem(problem)
    JR_t = torch.empty((26, n), dtype=torch.float32, device=cams.device)
    W_t = torch.empty((27, n), dtype=torch.float32, device=cams.device)
    p = problem
    rc = _cuda.lib().ba_linearize_rows(
        _cuda.ptr(cams), _cuda.ptr(points), _cuda.ptr(p.pt2d), _cuda.ptr(p.w),
        _cuda.ptr(p.cam_idx), _cuda.ptr(p.pnt_idx), n, _cuda.ptr(JR_t),
        _cuda.ptr(W_t), _cuda.stream())
    _cuda.check(rc, "ba_linearize_rows")
    _cuda.LAUNCHES["linearize"] += 1
    return JR_t, W_t


def _linearize_plain(problem: BAProblem, cams, points):
    """Plain version of :func:`linearize_w_kminor`: the batched chain on
    gathered rows (the JAX package's XLA linearization)."""
    r, Jc, Jp = linearize(cams[problem.cam_idx.long()],
                          points[problem.pnt_idx.long()], problem.pt2d,
                          problem.w)
    JR_t = torch.cat([Jc.reshape(-1, 18), Jp.reshape(-1, 6), r], dim=1).T
    W_t = torch.einsum("nia,nib->abn", Jc, Jp).reshape(27, -1)
    return JR_t.contiguous(), W_t.contiguous()
