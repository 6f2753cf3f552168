"""The reduction context of a multi-process solve (PyTorch port of
`bundleadjustment_jl_tpu/ops/spmdctx.py`).

In a solve over ranks (a mesh shard, `parallel/mesh.py`, through any
driver of `solver/lm_jit.py` or `solver/lm.py`; the spmd driver of
`solver/lm_spmd.py`) every rank runs the whole LM loop on a contiguous,
point-aligned shard of the rows (`parallel/spmd.py`); the cameras are
replicated. A sum over rows is then a per-rank partial, and the
camera-space sums all-reduce over the ranks' process group:

- the camera-space stage outputs ([Hcc | g_c], the reduced right-hand
  side's correction, the Schur matvec's camera pass, the W C W' diagonal)
  and the row sums (the objective, the trial objectives) are all-reduced
  by the solve's stage table (`ops/normal.py:stages_for`), on each stage's
  float32 output before a 2-byte working dtype rounds it;
- point-space values (Hpp, g_p, dp, W, the rows) stay local;
- a scalar that mixes both (||J'r||, g'd, ||d||, ||x||, the quadratic
  form, the CGLS step's gamma and denominator) sums only its point and
  row parts here; the camera part is computed alike on every rank;
- the dense step's ``Y' U`` and CGLS's ``J' s`` camera part are per-rank
  partials, summed here.

:data:`GROUP` is that process group, set by the drivers for the length of
a solve on a mesh shard (:func:`using`). None (every other path) means one
device: each hook returns its input.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from bundleadjustment_jl_tpu_torch.models.problem import HALF_DTYPES

# The spmd solve's process group; None: one device, every hook a no-op.
GROUP: Optional[dist.ProcessGroup] = None


def _reduce(x: torch.Tensor, op) -> torch.Tensor:
    if GROUP is None:
        return x
    # A copy, reduced in place and returned: the caller's tensor stays as
    # it is. A 2-byte dtype is reduced in float32 and rounded back (exact
    # at one rank), so no backend sees a 2-byte reduction.
    y = x.detach().to(torch.float32 if x.dtype in HALF_DTYPES else x.dtype,
                      memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y.reshape(-1), op=op, group=GROUP)
    return y.to(x.dtype)


def psum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of :data:`GROUP` (``x`` itself when it
    is None)."""
    return _reduce(x, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """The largest ``x`` over the ranks of :data:`GROUP`, elementwise."""
    return _reduce(x, dist.ReduceOp.MAX)


@contextlib.contextmanager
def using(group: dist.ProcessGroup) -> Iterator[None]:
    """Set :data:`GROUP` to ``group`` for the body; restore it after."""
    global GROUP
    prev, GROUP = GROUP, group
    try:
        yield
    finally:
        GROUP = prev
