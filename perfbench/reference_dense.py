"""The plain reference of a BAL solve with the exact step: Levenberg-Marquardt
over the Schur complement, each step a Cholesky solve of the dense reduced
camera system, in plain PyTorch.

It takes `perfbench/reference.py`'s linearization (the Jacobian by
automatic differentiation of the BAL camera model, W rounded to its storage
type) and its LM loop (the solver's documented lambda schedule and stops),
and replaces the step: S is formed as a dense (9 ncams, 9 ncams) matrix,

    S = blockdiag(Hcc + lam I) - sum_p sum_{k,l in p} W_k Hpp_inv[p] W_l',

over every ordered pair of each point's rows, in batches of pairs, and
solved by a Cholesky factorization (``cholesky_ex``, then two triangular
solves). An S that is not positive definite gives a NaN step, which the LM
loop rejects, as the solver's dense step does. It imports torch and
`perfbench/reference.py` only: nothing of the system under test. Matrix
products run at full precision (TF32 off) in the compute type, float64 as
the rule.
"""

from __future__ import annotations

import torch

from perfbench import reference
from perfbench.reference import STATUS, Blocks, Solve  # noqa: F401

# Ordered pairs of rows a batch of S's sum.
PAIRS = 1 << 21


class Reference(reference.Reference):
    """`perfbench/reference.py`'s problem and LM loop with the dense
    Cholesky step."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # Every ordered pair (k, l) of rows of one point: row k repeated
        # over its point's rows, the point's rows in order beside it.
        order = torch.argsort(self.pnt, stable=True)
        counts = torch.bincount(self.pnt, minlength=self.npnts)
        starts = torch.cumsum(counts, 0) - counts
        per = counts[self.pnt[order]]
        total = int(per.sum())
        k = torch.repeat_interleave(order, per, output_size=total)
        first = torch.cumsum(per, 0) - per
        pos = torch.arange(total, device=self.dev) - torch.repeat_interleave(
            first, per, output_size=total)
        self.pair_k = k
        self.pair_l = order[starts[self.pnt[k]] + pos]

    def schur(self, blk: Blocks, lam: float,
              Hpp_inv: torch.Tensor) -> torch.Tensor:
        """S (9 ncams, 9 ncams) at ``lam``, ``Hpp_inv`` (npnts, 3, 3) the
        inverse damped point blocks."""
        nc, dt = self.ncams, self.dtype
        S = torch.zeros(nc * nc, 9, 9, dtype=dt, device=self.dev)
        for lo in range(0, self.pair_k.shape[0], PAIRS):
            k = self.pair_k[lo:lo + PAIRS]
            l = self.pair_l[lo:lo + PAIRS]  # noqa: E741
            B = blk.W[k] @ Hpp_inv[self.pnt[k]] @ blk.W[l].transpose(1, 2)
            S.index_add_(0, self.cam[k] * nc + self.cam[l], B)
        S = -S.reshape(nc, nc, 9, 9).transpose(1, 2).reshape(9 * nc, 9 * nc)
        ar = torch.arange(nc, device=self.dev)
        S.view(nc, 9, nc, 9)[ar, :, ar, :] += blk.Hcc + lam * torch.eye(
            9, dtype=dt, device=self.dev)
        return S

    def step(self, blk: Blocks, lam: float, rtol: float, max_iters: int,
             stagnation: int):
        """``(dc, dp, ||J d||^2, 0)``: the exact Schur-complement step at
        ``lam``; ``rtol``, ``max_iters`` and ``stagnation`` (the iterative
        step's) are not read."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return self._step(blk, lam)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _step(self, blk: Blocks, lam: float):
        dt = self.dtype
        Hpp_inv = torch.linalg.inv(
            blk.Hpp + lam * torch.eye(3, dtype=dt, device=self.dev))
        v = torch.einsum("pab,pb->pa", Hpp_inv, blk.g_p)
        b = -blk.g_c + self._cam_sum(blk.W, v)
        L, info = torch.linalg.cholesky_ex(self.schur(blk, lam, Hpp_inv))
        dc = torch.cholesky_solve(b.reshape(-1, 1), L).reshape(-1, 9)
        dc = torch.where(info == 0, dc, torch.full_like(dc, float("nan")))
        dp = -torch.einsum("pab,pb->pa", Hpp_inv,
                           blk.g_p + self._pnt_sum(blk.W, dc))
        cross = self._cam_sum(blk.W, dp)
        Jd2 = (torch.sum(dc * torch.einsum("cab,cb->ca", blk.Hcc, dc))
               + 2.0 * torch.sum(cross * dc)
               + torch.sum(dp * torch.einsum("pab,pb->pa", blk.Hpp, dp)))
        return dc, dp, float(Jd2), 0
