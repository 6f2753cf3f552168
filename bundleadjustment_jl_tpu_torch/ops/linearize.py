"""The linearization of the split routes (K7) and its W-only form over
the camera order (K8) — the counterparts of
`bundleadjustment_jl_tpu/ops/pallas_linearize.py:linearize_w_kminor` and
`linearize_w_only`.

Same device rule as `ops/fused_assemble.py`: CUDA float32 tensors launch
the hand-written kernel (``csrc/linearize.cu``), CPU tensors take the
plain PyTorch version beside it, CUDA float64 raises.

Outputs are structure-of-arrays in the point-sorted row order, the JAX
package's ``JR_t[:26]`` and ``W_t[:27]``:

- ``JR_t`` (26, nobs_pad): rows 0-17 Jc (row ``9i+a``), 18-23 Jp
  (``18+3i+b``), 24-25 the weighted residual;
- ``W_t`` (27, nobs_pad): row ``3a+b`` holds ``W[a, b]`` of
  ``W_k = Jc_k' Jp_k``, stored in ``w_dtype`` (default: that of ``cams``;
  bfloat16 or float16 with ``facto_dtype``), computed in float32 and
  rounded once at the store.

:func:`linearize_w_only` gives ``W_cam_t`` = ``W_t[:, cam_perm]`` by
re-running the chain on the rows in camera order, as the JAX package does
for the huge-n route with camera scatter off (``normal.py:385-442``); its
kernel reads the row data from their camera-order copies
(:func:`ops.plans.cam_row_plan`, built once per problem).
"""

from __future__ import annotations

import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import _cuda, plans
from bundleadjustment_jl_tpu_torch.ops.chain import linearize

# Row offsets of Jp and the residual in JR_t (Jc starts at row 0).
JP0, R0 = 18, 24


def linearize_w_kminor(problem: BAProblem, cams: torch.Tensor,
                       points: torch.Tensor,
                       w_dtype: torch.dtype | None = None):
    """Linearize every observation row at (cams, points) -> ``(JR_t
    (26, n), W_t (27, n) in w_dtype)``."""
    if not cams.is_cuda:
        return _linearize_plain(problem, cams, points, w_dtype)
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    _cuda.require(cams, "cams", torch.float32, (nc, 9))
    _cuda.require(points, "points", torch.float32, (npt, 3))
    _cuda.require_problem(problem)
    JR_t = torch.empty((26, n), dtype=torch.float32, device=cams.device)
    W_t = torch.empty((27, n), dtype=w_dtype or torch.float32,
                      device=cams.device)
    code = _cuda.w_code(W_t, "W_t", (27, n))
    p = problem
    rc = _cuda.lib().ba_linearize_rows(
        _cuda.ptr(cams), _cuda.ptr(points), _cuda.ptr(p.pt2d), _cuda.ptr(p.w),
        _cuda.ptr(p.cam_idx), _cuda.ptr(p.pnt_idx), n, _cuda.ptr(JR_t),
        _cuda.ptr(W_t), code, _cuda.stream())
    _cuda.check(rc, "ba_linearize_rows")
    _cuda.launched("linearize", W_t)
    return JR_t, W_t


def _linearize_plain(problem: BAProblem, cams, points, w_dtype=None):
    """Plain version of :func:`linearize_w_kminor`: the batched chain on
    gathered rows (the JAX package's XLA linearization), W rounded to
    ``w_dtype`` at the end."""
    r, Jc, Jp = linearize(cams[problem.cam_idx.long()],
                          points[problem.pnt_idx.long()], problem.pt2d,
                          problem.w)
    JR_t = torch.cat([Jc.reshape(-1, 18), Jp.reshape(-1, 6), r], dim=1).T
    W_t = torch.einsum("nia,nib->abn", Jc, Jp).reshape(27, -1)
    return JR_t.contiguous(), W_t.to(w_dtype or W_t.dtype).contiguous()


def linearize_w_only(problem: BAProblem, cams: torch.Tensor,
                     points: torch.Tensor,
                     w_dtype: torch.dtype | None = None) -> torch.Tensor:
    """W of every row at (cams, points), in the camera order -> ``W_cam_t``
    (27, n) in ``w_dtype``, column ``j`` the W of row ``cam_perm[j]``."""
    if not cams.is_cuda:
        return _linearize_w_only_plain(problem, cams, points, w_dtype)
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    _cuda.require(cams, "cams", torch.float32, (nc, 9))
    _cuda.require(points, "points", torch.float32, (npt, 3))
    _cuda.require_problem(problem)
    W_cam_t = torch.empty((27, n), dtype=w_dtype or torch.float32,
                          device=cams.device)
    code = _cuda.w_code(W_cam_t, "W_cam_t", (27, n))
    rows = plans.cam_row_plan(problem)
    rc = _cuda.lib().ba_linearize_w_only(
        _cuda.ptr(cams), _cuda.ptr(points), _cuda.ptr(rows.pt2d),
        _cuda.ptr(rows.w), _cuda.ptr(rows.cam), _cuda.ptr(rows.pnt), n,
        _cuda.ptr(W_cam_t), code, _cuda.stream())
    _cuda.check(rc, "ba_linearize_w_only")
    _cuda.launched("linearize_w_only", W_cam_t)
    return W_cam_t


def _linearize_w_only_plain(problem: BAProblem, cams, points, w_dtype=None):
    """Plain version of :func:`linearize_w_only`: the batched chain on the
    rows gathered in camera order, W rounded to ``w_dtype`` at the end."""
    perm = problem.cam_perm.long()
    _, Jc, Jp = linearize(cams[problem.cam_idx.long()[perm]],
                          points[problem.pnt_idx.long()[perm]],
                          problem.pt2d[perm], problem.w[perm])
    W = torch.einsum("nia,nib->abn", Jc, Jp).reshape(27, -1)
    return W.to(w_dtype or W.dtype).contiguous()
