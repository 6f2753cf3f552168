"""The dense Schur step's reduced camera system as a dense matrix,

    S = blockdiag(Hcc_l) - sum_p sum_{k,l in p} W_k Hpp_inv[p] W_l',

the stage ``dense_schur`` of the solve's stage table (`ops/normal.py`):

- :func:`dense_schur`, the kernel route: one hand-written source,
  ``csrc/dense_pairs.cu``, sums each 9x9 block of S over its camera pairs
  (`ops/plans.py:PairPlan`) straight into S. CUDA float32 operands (W in
  its storage dtype) launch it; CPU tensors take its plain twin
  :func:`_dense_pairs_plain`, which sums the same pair blocks; CUDA
  float64 raises;
- :func:`_dense_schur_plain`, the plain route (float64, a camera-partitioned
  problem, ``PALLAS_MODE`` off): the JAX package's formulation, two dense
  (3 npnts, 9 ncams) targets and one matmul.

Each takes ``(W_t, problem, Hpp_inv_f, hcc_l_f=None)`` and returns S in the
compute dtype (float32 for a 2-byte W, else W's), both triangles written,
with ``Hcc_l`` added on the diagonal blocks (none when ``hcc_l_f`` is
None: a point-aligned mesh shard sums its ranks' parts first,
`ops/schur.py:assemble_dense_schur`). A float16 W holds ``s W`` and the
system's ``Hpp_inv`` is hatted by ``1 / s^2``, so the sum is S's.
"""

from __future__ import annotations

import torch

from bundleadjustment_jl_tpu_torch.ops import _cuda, plans, spmdctx

# Pairs a batch of the plain twin's sum.
_TWIN_PAIRS = 1 << 20


def _dense_dtype(W_t: torch.Tensor) -> torch.dtype:
    """The dense path's compute dtype: float32 for a 2-byte W."""
    return torch.float32 if W_t.element_size() < 4 else W_t.dtype


def _add_diag(S: torch.Tensor, hcc_l_f: torch.Tensor | None) -> None:
    """``S``'s diagonal 9x9 blocks += Hcc_l, in place."""
    if hcc_l_f is not None:
        nc = S.shape[0] // 9
        ar = torch.arange(nc, device=S.device)
        S.view(nc, 9, nc, 9)[ar, :, ar, :] += hcc_l_f.reshape(nc, 9, 9).to(
            S.dtype)


def dense_schur(W_t: torch.Tensor, problem, Hpp_inv_f: torch.Tensor,
                hcc_l_f: torch.Tensor | None = None) -> torch.Tensor:
    """S (9 ncams, 9 ncams) float32 by the pair kernel: every entry
    written once, in a fixed order (no atomics; repeats are
    bit-identical)."""
    if not W_t.is_cuda:
        return _dense_pairs_plain(W_t, problem, Hpp_inv_f, hcc_l_f)
    nc, npt, n = problem.ncams, problem.npnts, problem.nobs_pad
    code = _cuda.w_code(W_t, "W_t", (27, n))
    _cuda.require(Hpp_inv_f, "Hpp_inv_f", torch.float32, (npt * 9,))
    _cuda.require(problem.pnt_idx, "pnt_idx", torch.int32, (n,))
    if hcc_l_f is not None:
        _cuda.require(hcc_l_f, "hcc_l_f", torch.float32, (nc * 81,))
    plan = plans.pair_plan(problem)
    dev = W_t.device
    rows = torch.empty((2, problem.nobs, 28), dtype=torch.float32,
                       device=dev)
    part = torch.empty((plan.nslots, 81), dtype=torch.float32, device=dev)
    S = torch.empty((9 * nc, 9 * nc), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    rc = _cuda.lib().ba_dense_pairs(
        p(W_t), code, n, problem.nobs, p(Hpp_inv_f), p(problem.pnt_idx),
        p(hcc_l_f), p(plan.pair_i), p(plan.pair_j), p(plan.chunk_starts),
        p(plan.chunk_block), p(plan.chunk_slot), plan.nchunks,
        p(plan.multi_block), p(plan.multi_slots), plan.nmulti, nc, p(rows),
        p(part), p(S), _cuda.stream())
    _cuda.check(rc, "ba_dense_pairs")
    _cuda.launched("dense_pairs", W_t)
    return S


def _pair_blocks(W_t: torch.Tensor, problem, Hpp_inv_f: torch.Tensor,
                plan: plans.PairPlan) -> torch.Tensor:
    """(ncams (ncams + 1) / 2, 9, 9) the sums of the pair terms of each
    block of S's lower triangle (block ``ci (ci + 1) / 2 + cj``), in the
    compute dtype: ``W_i Hpp_inv[p] W_j'`` for each planned pair, and
    ``W_j Hpp_inv[p] W_i'`` beside it for two rows of one camera, added in
    the plan's order (``index_add_``, in order on the CPU)."""
    cdt = _dense_dtype(W_t)
    nc = problem.ncams
    W = W_t.to(cdt).T.reshape(-1, 9, 3)
    H = Hpp_inv_f.to(cdt).reshape(-1, 3, 3)
    pnt, cam = problem.pnt_idx.long(), problem.cam_idx.long()
    acc = torch.zeros((nc * (nc + 1) // 2, 9, 9), dtype=cdt,
                      device=W_t.device)
    for lo in range(0, plan.npairs, _TWIN_PAIRS):
        i = plan.pair_i[lo:lo + _TWIN_PAIRS].long()
        j = plan.pair_j[lo:lo + _TWIN_PAIRS].long()
        Hp = H[pnt[i]]
        B = (W[i] @ Hp) @ W[j].transpose(1, 2)
        both = ((cam[i] == cam[j]) & (i != j))[:, None, None]
        B = torch.where(both, B + (W[j] @ Hp) @ W[i].transpose(1, 2), B)
        ci, cj = cam[i], cam[j]
        acc.index_add_(0, ci * (ci + 1) // 2 + cj, B)
    return acc


def _dense_pairs_plain(W_t, problem, Hpp_inv_f, hcc_l_f=None):
    """Plain version of :func:`dense_schur`: the same pair blocks
    (:func:`_pair_blocks`), placed below the diagonal and transposed above
    it, the diagonal blocks ``Hcc_l - sum`` (``-sum`` with no ``Hcc_l``)."""
    acc = _pair_blocks(W_t, problem, Hpp_inv_f, plans.pair_plan(problem))
    nc = problem.ncams
    ci, cj = torch.tril_indices(nc, nc, device=acc.device)
    S = torch.empty((nc, 9, nc, 9), dtype=acc.dtype, device=acc.device)
    S[cj, :, ci, :] = -acc.transpose(1, 2)
    S[ci, :, cj, :] = -acc
    if hcc_l_f is not None:
        diag = ci == cj
        S[ci[diag], :, ci[diag], :] = (
            hcc_l_f.reshape(nc, 9, 9).to(acc.dtype) - acc[diag])
    return S.reshape(9 * nc, 9 * nc)


def _dense_schur_plain(W_t, problem, Hpp_inv_f, hcc_l_f=None):
    """The plain route's S, as the JAX package builds it: ``-Y' U`` with
    ``U[3 p + b, 9 c + a] = W_k[a, b]`` and ``Y`` alike over ``Y_k = W_k
    Hpp_inv[p]``, for the row ``k`` of point ``p`` and camera ``c``. Each
    row's 27 entries go to their places in one ``index_put_`` (accumulate)
    a target (a point and camera pair has one row, the padding rows add
    zeros), then one matmul contracts the two. On camera groups a point's
    rows span ranks, whose cross terms no rank's product holds, so the two
    targets are all-reduced before the product (2 * 3 npnts * 9 ncams
    values a step; `ops/spmdctx.py`)."""
    nc, npt = problem.ncams, problem.npnts
    cdt = _dense_dtype(W_t)
    dev = W_t.device
    W = W_t.to(cdt).T.reshape(-1, 9, 3)
    pnt, cam = problem.pnt_idx.long(), problem.cam_idx.long()
    Y = torch.einsum("kab,kbc->kac", W,
                     Hpp_inv_f.to(cdt).reshape(-1, 3, 3)[pnt])
    a = torch.arange(9, device=dev)[None, :, None]
    b = torch.arange(3, device=dev)[None, None, :]
    flat = ((3 * pnt[:, None, None] + b) * (9 * nc)
            + 9 * cam[:, None, None] + a).reshape(-1)

    def target(vals):
        out = torch.zeros(3 * npt * 9 * nc, dtype=cdt, device=dev)
        out.index_put_((flat,), vals.reshape(-1), accumulate=True)
        return out.reshape(3 * npt, 9 * nc)

    if spmdctx.CAMERA_GROUPS:
        S = -(spmdctx.psum(target(Y)).T @ spmdctx.psum(target(W)))
    else:
        S = -(target(Y).T @ target(W))
    _add_diag(S, hcc_l_f)
    return S
