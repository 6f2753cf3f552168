"""Fused assembly (K1) and trial objectives (K4) — the counterpart of
`bundleadjustment_jl_tpu/ops/pallas_assemble.py`.

Each wrapper takes the route its tensors' device gives: CUDA float32
tensors go through the hand-written kernel (``csrc/assemble.cu``,
``csrc/objective.cu``), CPU tensors through the plain PyTorch version
beside it (any dtype). CUDA float64 raises, as the JAX package's kernels
refuse f64. The plain versions are also what ``chip_smoke.py`` checks the
kernels against on the card.

K1 runs two passes (``csrc/assemble.cu``): the point pass in K5's point
ranges (:func:`ops.plans.point_blocks`), the camera pass a block per camera
over ``cam_perm``. K4 runs a block per row block and trial state, then
a block per state for its sums.

W travels as structure-of-arrays ``W_t`` (27, nobs_pad), row ``3a+b``
holding ``W[a, b]`` of ``W_k = Jc_k' Jp_k`` — the JAX package's
``W_t[:27]`` — stored in ``w_dtype``: float32 or, with ``facto_dtype``,
bfloat16 or float16 (computed in float32, rounded once at the store).
"""

from __future__ import annotations

import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import _cuda, plans
from bundleadjustment_jl_tpu_torch.ops.chain import linearize, project_residual


def assemble_scatter(problem: BAProblem, cams: torch.Tensor,
                     points: torch.Tensor, w_dtype: torch.dtype | None = None):
    """Linearize at (cams, points) and assemble -> ``(W_t (27, n) in
    ``w_dtype`` (default: that of ``cams``), hp12 (npnts, 12) = [Hpp |
    g_p], hc90 (ncams, 90) = [Hcc | g_c], obj ())``."""
    if not cams.is_cuda:
        return _assemble_plain(problem, cams, points, w_dtype)
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    _cuda.require(cams, "cams", torch.float32, (nc, 9))
    _cuda.require(points, "points", torch.float32, (npt, 3))
    _cuda.require_problem(problem)
    dev = cams.device
    blocks = plans.point_blocks(problem)
    W_t = torch.empty((27, n), dtype=w_dtype or torch.float32, device=dev)
    code = _cuda.w_code(W_t, "W_t", (27, n))
    hp12 = torch.empty((npt, 12), dtype=torch.float32, device=dev)
    hc90 = torch.empty((nc, 90), dtype=torch.float32, device=dev)
    obj_part = torch.empty((nc,), dtype=torch.float32, device=dev)
    obj = torch.empty((1,), dtype=torch.float32, device=dev)
    p = problem
    rc = _cuda.lib().ba_assemble(
        _cuda.ptr(cams), _cuda.ptr(points), _cuda.ptr(p.pt2d), _cuda.ptr(p.w),
        _cuda.ptr(p.cam_idx), _cuda.ptr(p.pnt_idx), _cuda.ptr(p.pnt_starts),
        _cuda.ptr(blocks), blocks.shape[0] - 1, _cuda.ptr(p.cam_perm),
        _cuda.ptr(p.cam_starts), nc, n, _cuda.ptr(W_t), code,
        _cuda.ptr(hp12), _cuda.ptr(hc90), _cuda.ptr(obj_part), _cuda.ptr(obj),
        _cuda.stream())
    _cuda.check(rc, "ba_assemble")
    _cuda.launched("assemble", W_t)
    return W_t, hp12, hc90, obj[0]


def _assemble_plain(problem: BAProblem, cams, points, w_dtype=None):
    """Plain version of :func:`assemble_scatter`: batched einsums and
    ``index_add_`` segment sums (the JAX package's XLA assembly); W
    rounded to ``w_dtype`` at the end."""
    ci = problem.cam_idx.long()
    pi = problem.pnt_idx.long()
    r, Jc, Jp = linearize(cams[ci], points[pi], problem.pt2d, problem.w)
    W_t = torch.einsum("nia,nib->abn", Jc, Jp).reshape(27, -1)
    hp = torch.cat([torch.einsum("nib,nie->nbe", Jp, Jp).reshape(-1, 9),
                    torch.einsum("nib,ni->nb", Jp, r)], dim=1)
    hc = torch.cat([torch.einsum("nia,nid->nad", Jc, Jc).reshape(-1, 81),
                    torch.einsum("nia,ni->na", Jc, r)], dim=1)
    hp12 = torch.zeros((problem.npnts, 12), dtype=hp.dtype,
                       device=hp.device).index_add_(0, pi, hp)
    hc90 = torch.zeros((problem.ncams, 90), dtype=hc.dtype,
                       device=hc.device).index_add_(0, ci, hc)
    return (W_t.to(w_dtype or W_t.dtype).contiguous(), hp12, hc90,
            0.5 * torch.sum(r * r))


def objective_scatter(problem: BAProblem, cams_all: torch.Tensor,
                      pts_all: torch.Tensor) -> torch.Tensor:
    """Trial objectives ``(S,)``: 0.5 ||r||^2 at ``cams_all[s]``
    (S, ncams, 9) and ``pts_all[s]`` (S, npnts, 3), all S in one call
    (``csrc/objective.cu``: each row's residual from its camera's nine
    parameters, block sums a scale, then each scale's sums)."""
    if not cams_all.is_cuda:
        return _objective_plain(problem, cams_all, pts_all)
    S = cams_all.shape[0]
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    _cuda.require(cams_all, "cams_all", torch.float32, (S, nc, 9))
    _cuda.require(pts_all, "pts_all", torch.float32, (S, npt, 3))
    _cuda.require_problem(problem)
    if problem.pt2d.data_ptr() % 8:
        raise ValueError("pt2d: the kernel reads each row as one float2 "
                         "and needs it 8-byte aligned")
    so = _cuda.lib()
    dev = cams_all.device
    partials = torch.empty((S, so.ba_objective_blocks(n)),
                           dtype=torch.float32, device=dev)
    out = torch.empty((S,), dtype=torch.float32, device=dev)
    p = problem
    rc = so.ba_objective(
        _cuda.ptr(cams_all), _cuda.ptr(pts_all), _cuda.ptr(p.pt2d),
        _cuda.ptr(p.w), _cuda.ptr(p.cam_idx), _cuda.ptr(p.pnt_idx), S, nc,
        npt, n, _cuda.ptr(partials), _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, "ba_objective")
    _cuda.launched("objective")
    return out


def _objective_plain(problem: BAProblem, cams_all, pts_all):
    """Plain version of :func:`objective_scatter`: one gather + forward
    chain per scale."""
    ci = problem.cam_idx.long()
    pi = problem.pnt_idx.long()
    out = []
    for cams, points in zip(cams_all, pts_all):
        r = project_residual(cams[ci], points[pi], problem.pt2d, problem.w)
        out.append(0.5 * torch.sum(r * r))
    return torch.stack(out)
