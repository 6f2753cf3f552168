"""Schur-complement elimination of the points (PyTorch port of
`bundleadjustment_jl_tpu/ops/schur.py`) on the four kernel routes.

Eliminating the 3x3 point blocks of the damped normal equations gives the
reduced camera system

    S dc = b,  S = Hcc_l - W Hpp_l^{-1} W',  b = -g_c + W Hpp_l^{-1} g_p
    dp = -Hpp_l^{-1} (g_p + W' dc)

``S`` is never formed. Each entry point dispatches as the JAX package
does, on the route that assembled the blocks (``GNBlocks.route``, carried
into ``SchurSystem.route``) and on whether they carry the camera-sorted
``W_cam_t``:

- route A (``"fused"``): :func:`reduce_and_diag` gets ``b`` and the exact
  diagonal blocks of ``S`` from one K2 launch, :func:`schur_matvec`
  applies ``S`` through one K3 launch, and :func:`back_substitute_quad`
  gets ``dp`` and the ``||J d||^2`` cross term from one more K3 launch;
- route B1 (``"scatter_split"``): :func:`reduce_and_diag` as on route A;
  the two-pass matvec (K5 point direction with the fold, then K2's
  ``W op`` product over the point-sorted W), :func:`back_substitute` (K5
  point direction) and :func:`quad_form` (K2 ``W op``);
- routes C (``"sorted"``) and B2 (``"sorted_relin"``):
  :func:`reduce_system` (K5 camera direction) and
  :func:`schur_diag_blocks` (K6 ``W C W'``), the two-pass matvec (K5 point
  direction with the fold, then K5 camera direction),
  :func:`back_substitute` and :func:`quad_form` (K5 camera direction).

Every camera-direction sum without ``W_cam_t`` takes K2 over the
point-sorted W, with it the camera-sorted pass (the JAX package's
``cam_reduce_scatter_ok``).

W may be stored in bfloat16 or float16 (``facto_dtype``). A float16 W holds
``s W`` (``GNBlocks.w_scale``, a power of two), and the point space is
hatted as in the JAX package: ``Hpp_inv / s^2`` and ``s g_p`` in the
SchurSystem, so ``S`` and ``b`` are exact, the point step comes out as
``dp / s`` and is unscaled at the back-substitution, and ``quad_form``'s
cross term takes ``dp / s``. Where the JAX package rounds a per-row operand
to bfloat16 beside a bfloat16 W, so does the port, in the same places
(:func:`_cam_dir_reduce`, :func:`_point_dir_operand`), so both make the
same decisions.

In a 2-byte working dtype (`ops/normal.py`) the vectors here carry that
dtype; the solve's stage table (`normal.stages_for`) widens them to
float32 for each stage and rounds its result back to the working dtype, as
the JAX package casts around its kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import normal
from bundleadjustment_jl_tpu_torch.ops.normal import (
    KERNELS, GNBlocks, Stages, damp, inv3x3_damped_flat)

# Routes whose camera sums run the camera scatter (K2 over the point-sorted
# W): the JAX package's `pallas_schur.cam_scatter_ok`.
_CAM_SCATTER_ROUTES = ("fused", "scatter_split")


class SchurSystem(NamedTuple):
    """The damped, point-eliminated camera system at one lambda."""
    Hcc_l_f: torch.Tensor    # (ncams*81,) damped camera blocks
    Hpp_inv_f: torch.Tensor  # (npnts*9,) inverse damped point blocks (/s^2)
    b_f: torch.Tensor        # (ncams*9,) reduced right-hand side
    g_p_f: torch.Tensor      # (npnts*3,) point gradient (* s)
    W_t: torch.Tensor        # (27, nobs_pad)
    problem: BAProblem
    W_cam_t: torch.Tensor | None = None  # routes C and B2 only
    route: str = "fused"                 # as GNBlocks.route
    w_scale: torch.Tensor | None = None  # as GNBlocks.w_scale
    stages: Stages = KERNELS             # as GNBlocks.stages

    @property
    def Hcc_l(self):
        return self.Hcc_l_f.reshape(-1, 9, 9)

    @property
    def b(self):
        return self.b_f.reshape(-1, 9)


def _hpp_dot(Hpp_f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-point 3x3 block times (npnts, 3)."""
    return torch.einsum("pab,pb->pa", Hpp_f.reshape(-1, 3, 3), x)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _cam_dir_reduce(problem: BAProblem, W_t: torch.Tensor,
                    W_cam_t: torch.Tensor | None, op: torch.Tensor,
                    st: Stages) -> torch.Tensor:
    """``segsum_cam(W_k op[pnt_k])`` (ncams, 9), ``op`` (npnts, 3): K2's
    ``W op`` product over the point-sorted W when there is no camera-sorted
    copy, else K5's camera direction over ``W_cam_t`` — with ``op`` rounded
    to bfloat16 beside a bfloat16 ``W_cam_t``, as the JAX package's
    camera-sorted pass gathers it (`ops/schur.py:_cam_dir_reduce`); each
    through the stage table ``st``."""
    if W_cam_t is None:
        return st.cam_reduce_w_op(W_t, problem, op)
    if W_cam_t.dtype == torch.bfloat16:
        op = _bf16_round(op)
    return st.wt_cam_reduce(W_cam_t, op, problem)


def _point_dir_operand(W_t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The camera vector of K5's point direction: rounded to bfloat16 beside
    a bfloat16 W when there are more cameras than
    ``normal.GATHER_TABLE_MAX_CAMS``, where the JAX package pre-gathers it
    per row in W's storage dtype (`pallas_schur.wtv_point_reduce`)."""
    if (W_t.dtype == torch.bfloat16
            and v.shape[0] > normal.GATHER_TABLE_MAX_CAMS):
        return _bf16_round(v)
    return v


def _hat(blocks: GNBlocks, Hpp_inv_f: torch.Tensor):
    """``(Hpp_inv / s^2, s g_p)``: the hatted point space of a W stored as
    ``s W``; ``(Hpp_inv, g_p)`` without a scale."""
    if blocks.w_scale is None:
        return Hpp_inv_f, blocks.g_p_f
    return (Hpp_inv_f / torch.square(blocks.w_scale),
            blocks.g_p_f * blocks.w_scale)


def _unhat(sys: SchurSystem, dp: torch.Tensor) -> torch.Tensor:
    """The point step from the hatted one, ``dp = s dp_hat``."""
    return dp if sys.w_scale is None else dp * sys.w_scale


def _system(problem: BAProblem, blocks: GNBlocks, Hcc_l, Hpp_inv_f, g_p_f,
            corr) -> SchurSystem:
    return SchurSystem(Hcc_l_f=Hcc_l.reshape(-1), Hpp_inv_f=Hpp_inv_f,
                       b_f=(-blocks.g_c + corr).reshape(-1), g_p_f=g_p_f,
                       W_t=blocks.W_t, problem=problem,
                       W_cam_t=blocks.W_cam_t, route=blocks.route,
                       w_scale=blocks.w_scale, stages=blocks.stages)


def reduce_system(problem: BAProblem, blocks: GNBlocks, lam) -> SchurSystem:
    """Damp with ``lam`` and form ``b = -g_c + segsum_cam(W_k (Hpp_inv
    g_p)[pnt_k])``."""
    Hcc_l = damp(blocks.Hcc, lam)
    Hpp_inv_f, g_p_f = _hat(blocks, inv3x3_damped_flat(blocks.Hpp_f, lam))
    corr = _cam_dir_reduce(problem, blocks.W_t, blocks.W_cam_t,
                           _hpp_dot(Hpp_inv_f, g_p_f.reshape(-1, 3)),
                           blocks.stages)
    return _system(problem, blocks, Hcc_l, Hpp_inv_f, g_p_f, corr)


def schur_diag_blocks(sys: SchurSystem) -> torch.Tensor:
    """Exact diagonal 9x9 blocks of S, ``Hcc_l - sum W Hpp_inv W'``: K2's
    ``W C W'`` over the point-sorted W when there is no camera-sorted copy,
    else K6's over ``W_cam_t``."""
    if sys.W_cam_t is None:
        wcw = sys.stages.cam_reduce_wcw(sys.W_t, sys.problem, sys.Hpp_inv_f)
    else:
        wcw = sys.stages.wcw_cam_reduce(sys.W_cam_t, sys.problem,
                                        sys.Hpp_inv_f)
    return sys.Hcc_l - wcw.reshape(-1, 9, 9)


def reduce_and_diag(problem: BAProblem, blocks: GNBlocks, lam):
    """(SchurSystem, exact diagonal 9x9 blocks of S) at ``lam``. On the
    camera-scatter routes (A, B1) the reduced RHS correction and ``sum W
    Hpp_inv W'`` come from one K2 launch; elsewhere this is
    :func:`reduce_system` and :func:`schur_diag_blocks`."""
    if blocks.route not in _CAM_SCATTER_ROUTES:
        sys = reduce_system(problem, blocks, lam)
        return sys, schur_diag_blocks(sys)
    Hcc_l = damp(blocks.Hcc, lam)
    Hpp_inv_f, g_p_f = _hat(blocks, inv3x3_damped_flat(blocks.Hpp_f, lam))
    out = blocks.stages.cam_reduce_wcw_rhs(
        blocks.W_t, problem, Hpp_inv_f,
        _hpp_dot(Hpp_inv_f, g_p_f.reshape(-1, 3)))
    sys = _system(problem, blocks, Hcc_l, Hpp_inv_f, g_p_f, out[:, 81:90])
    return sys, Hcc_l - out[:, :81].reshape(-1, 9, 9)


def schur_matvec(sys: SchurSystem, v: torch.Tensor) -> torch.Tensor:
    """Matrix-free ``S @ v`` for ``v`` (ncams, 9): one K3 launch on route
    A, else two passes (K5's point direction with the fold, then the
    camera direction)."""
    u = torch.einsum("cab,cb->ca", sys.Hcc_l, v)
    if sys.route == "fused":
        return u - sys.stages.matvec_cam_scatter(sys.W_t, v, sys.problem,
                                                 sys.Hpp_inv_f)
    t = sys.stages.wtv_point_reduce(
        sys.W_t, _point_dir_operand(sys.W_t, v), sys.problem,
        hpp_inv_f=sys.Hpp_inv_f)
    return u - _cam_dir_reduce(sys.problem, sys.W_t, sys.W_cam_t, t,
                               sys.stages)


def back_substitute(sys: SchurSystem, dc: torch.Tensor) -> torch.Tensor:
    """The point step ``dp = -Hpp_inv (g_p + W' dc)`` (npnts, 3), K5's
    point direction with the fold and add (unscaled by ``w_scale``)."""
    return _unhat(sys, sys.stages.wtv_point_reduce(
        sys.W_t, _point_dir_operand(sys.W_t, dc), sys.problem,
        hpp_inv_f=sys.Hpp_inv_f, add_f=sys.g_p_f, sign=-1.0))


def _quad(blocks: GNBlocks, dc, dp, cross_cam) -> torch.Tensor:
    """``||J d||^2 = dc' Hcc dc + 2 dc . cross_cam + dp' Hpp dp`` with
    ``cross_cam = segsum_cam(W_k dp[pnt_k])`` (ncams, 9)."""
    t_c = torch.sum(dc * torch.einsum("cab,cb->ca", blocks.Hcc, dc))
    t_p = torch.sum(dp * _hpp_dot(blocks.Hpp_f, dp))
    return t_c + 2.0 * torch.sum(cross_cam * dc) + t_p


def quad_form(problem: BAProblem, blocks: GNBlocks, dc: torch.Tensor,
              dp: torch.Tensor) -> torch.Tensor:
    """``||J d||^2`` from the assembled blocks, its cross term a
    camera-direction sum (over ``dp / s`` for a W stored as ``s W``)."""
    dp_h = dp if blocks.w_scale is None else dp / blocks.w_scale
    return _quad(blocks, dc, dp,
                 _cam_dir_reduce(problem, blocks.W_t, blocks.W_cam_t, dp_h,
                                 blocks.stages))


def back_substitute_quad(problem: BAProblem, blocks: GNBlocks,
                         sys: SchurSystem, dc: torch.Tensor):
    """``(dp (npnts, 3), ||J d||^2)``. On route A K3 with ``g_p`` folded
    and ``sign = -1`` yields ``dp`` and the cross term's camera sums
    together; elsewhere this is :func:`back_substitute` and
    :func:`quad_form`. With a float16 W, K3's ``dp`` is hatted and its
    camera sums ``segsum_cam(s W dp / s)`` already exact."""
    if sys.route != "fused":
        dp = back_substitute(sys, dc)
        return dp, quad_form(problem, blocks, dc, dp)
    cross_cam, dp = sys.stages.matvec_cam_scatter(
        sys.W_t, dc, problem, sys.Hpp_inv_f, gp_f=sys.g_p_f, sign=-1.0,
        with_dp=True)
    dp = _unhat(sys, dp)
    return dp, _quad(blocks, dc, dp, cross_cam)


# ---------------------------------------------------------------- dense
# Cap on the dense path's device bytes (:func:`dense_schur_bytes`). The
# JAX package's 6 GiB was set for a TPU's HBM; the H100 holds 80 GB. The
# two (3 npnts, 9 ncams) targets are the dense path's only large
# allocations; beside them a solve keeps the problem, its W and its plans
# (under 1 GB at Dubrovnik-356) and the caching allocator's free blocks.
# Half the card leaves that room: 40 GiB admits Dubrovnik-356 (~18.7 GB
# by the estimate) and refuses the BAL problems above it (Trafalgar-257:
# ~0.3 TB), before any allocation.
DENSE_MAX_BYTES = 40 << 30


def dense_schur_bytes(ncams: int, npnts: int, nobs: int,
                      itemsize: int = 4) -> int:
    """Estimated peak device bytes of :func:`solve_dense`: the two
    targets, S and its factor, and the scatter operands (the flat int64
    index, ``index_put_``'s sorted copy and permutation of it, the W and
    Y values of every row), at ``itemsize`` bytes a value."""
    mats = 2 * (3 * npnts) * (9 * ncams) * itemsize
    s = 2 * (9 * ncams) ** 2 * itemsize
    upd = 27 * nobs * (3 * 8 + 2 * itemsize)
    return mats + s + upd


def check_dense_feasible(ncams: int, npnts: int, nobs: int,
                         itemsize: int = 4) -> None:
    """Raise ``MemoryError`` when :func:`dense_schur_bytes` exceeds
    :data:`DENSE_MAX_BYTES`."""
    b = dense_schur_bytes(ncams, npnts, nobs, itemsize)
    if b > DENSE_MAX_BYTES:
        raise MemoryError(
            f"dense Schur refused: ~{b / 2**30:.1f} GiB at ncams={ncams} "
            f"npnts={npnts} nobs={nobs} exceeds DENSE_MAX_BYTES="
            f"{DENSE_MAX_BYTES / 2**30:.1f} GiB")


def _dense_dtype(W_t: torch.Tensor) -> torch.dtype:
    """The dense path's compute dtype: float32 for a 2-byte W."""
    return torch.float32 if W_t.element_size() < 4 else W_t.dtype


def assemble_dense_schur(sys: SchurSystem) -> torch.Tensor:
    """S as a dense (9 ncams, 9 ncams) matrix, ``blockdiag(Hcc_l) - Y' U``
    with ``U[3 p + b, 9 c + a] = W_k[a, b]`` and ``Y`` alike over ``Y_k =
    W_k Hpp_inv[p]``, for the row ``k`` of point ``p`` and camera ``c``.
    Each row's 27 entries go to their places in one ``index_put_``
    (accumulate) a target (a point and camera pair has one row, the
    padding rows add zeros), then one matmul contracts the two. A 2-byte
    W is widened to float32 (a float16 W holds ``s W`` and the system's
    ``Hpp_inv`` is hatted by ``1 / s^2``, so ``Y' U`` is exact), and S
    comes back rounded to W's storage dtype, as in the JAX package."""
    problem = sys.problem
    nc, npt = problem.ncams, problem.npnts
    cdt = _dense_dtype(sys.W_t)
    dev = sys.W_t.device
    W = sys.W_t.to(cdt).T.reshape(-1, 9, 3)
    pnt, cam = problem.pnt_idx.long(), problem.cam_idx.long()
    Y = torch.einsum("kab,kbc->kac", W,
                     sys.Hpp_inv_f.to(cdt).reshape(-1, 3, 3)[pnt])
    a = torch.arange(9, device=dev)[None, :, None]
    b = torch.arange(3, device=dev)[None, None, :]
    flat = ((3 * pnt[:, None, None] + b) * (9 * nc)
            + 9 * cam[:, None, None] + a).reshape(-1)

    def target(vals):
        out = torch.zeros(3 * npt * 9 * nc, dtype=cdt, device=dev)
        out.index_put_((flat,), vals.reshape(-1), accumulate=True)
        return out.reshape(3 * npt, 9 * nc)

    S = -(target(Y).T @ target(W))
    ar = torch.arange(nc, device=dev)
    S.view(nc, 9, nc, 9)[ar, :, ar, :] += sys.Hcc_l.to(cdt)
    return S.to(sys.W_t.dtype)


def solve_dense(sys: SchurSystem) -> torch.Tensor:
    """Direct Cholesky solve of the dense reduced system -> ``dc`` (ncams,
    9) in the working dtype. A 2-byte S is factored in float32 and ``dc``
    rounded to its dtype, as in the JAX package. An S that is not
    positive definite gives a NaN ``dc`` (no exception, no host read; the
    JAX package's ``cho_factor`` gives NaN there), which the LM drivers
    reject. Refuses, before any allocation, a system above
    :data:`DENSE_MAX_BYTES`."""
    problem = sys.problem
    cdt = _dense_dtype(sys.W_t)
    check_dense_feasible(problem.ncams, problem.npnts, problem.nobs_pad,
                         torch.finfo(cdt).bits // 8)
    S = assemble_dense_schur(sys)
    L, info = torch.linalg.cholesky_ex(S.to(cdt))
    dc = torch.cholesky_solve(sys.b_f.to(cdt)[:, None], L).reshape(-1, 9)
    dc = torch.where(info == 0, dc, torch.full_like(dc, float("nan")))
    return dc.to(S.dtype).to(sys.b_f.dtype)
