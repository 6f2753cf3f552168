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
- the dense step's pair sums (S without ``Hcc_l``) and CGLS's ``J' s``
  camera part are per-rank partials, summed here.

On camera-group shards of a partitioned problem (:data:`CAMERA_GROUPS`,
`parallel/spmd.py:GroupProblem`) every rank holds every camera and point
and a chunk of the rows, so a point's rows span ranks, as on the JAX
package's GSPMD mesh:

- the point-space stage outputs (Hpp | g_p, the per-point ``sum W' v`` of
  the Schur matvec, the reduced right-hand side and the
  back-substitution) are per-rank partials too, all-reduced by the stage
  table before any per-point fold;
- so every point-space value is replicated, and the point parts of the
  mixed scalars are not summed again (:func:`psum_points`,
  :func:`pmax_points` return their input);
- the dense step sums its two point-indexed targets before their product
  (a point's rows on two ranks make cross terms), and CGLS sums ``J' s``
  whole.

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
# Whether the solve's shards are camera groups (every point on every rank,
# its rows over ranks) rather than point-aligned ranges.
CAMERA_GROUPS = False


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


def psum_points(x: torch.Tensor) -> torch.Tensor:
    """The point part of a scalar, summed over the ranks' points: an
    all-reduce on point-aligned shards (each rank holds its own points),
    ``x`` itself on camera groups (each holds them all)."""
    return x if CAMERA_GROUPS else psum(x)


def pmax_points(x: torch.Tensor) -> torch.Tensor:
    """The largest of a point-space value over the ranks' points, as
    :func:`psum_points` sums it."""
    return x if CAMERA_GROUPS else pmax(x)


@contextlib.contextmanager
def using(group: dist.ProcessGroup,
          camera_groups: bool = False) -> Iterator[None]:
    """Set :data:`GROUP` to ``group`` and :data:`CAMERA_GROUPS` to
    ``camera_groups`` for the body; restore them after."""
    global GROUP, CAMERA_GROUPS
    prev = GROUP, CAMERA_GROUPS
    GROUP, CAMERA_GROUPS = group, camera_groups
    try:
        yield
    finally:
        GROUP, CAMERA_GROUPS = prev
