"""Levenberg-Marquardt over ranks of a process group, a shard each
(PyTorch port of `bundleadjustment_jl_tpu/solver/lm_spmd.py`):
:func:`levenberg_marquardt_spmd` and its chunked form
:func:`levenberg_marquardt_spmd_chunked`.

Each rank is a process with its own device: ``cuda:LOCAL_RANK`` over NCCL
when the problem lived on a card, the CPU over gloo otherwise. Every rank
runs the one-shot or chunked driver of `solver/lm_jit.py` on its
point-aligned shard (`parallel/spmd.py:SpmdProblem.rank_shard`, the mesh
shard of `parallel/mesh.py`):

- the rows, points, Hpp, g_p, dp and W are rank-local;
- the cameras, Hcc, g_c, the reduced system, the PCG state and the
  scalars of the lambda schedule and stopping tests are replicated:
  `ops/spmdctx.py` all-reduces each camera-space sum and the point part
  of each mixed scalar, and every rank gets the same bits from a
  collective, so the ranks read the same host scalars (the PCG flag each
  CG step, the accept decision, the stop tests) and stay in lockstep.

All-reduces per LM iteration on route A: one (ncams, 90) at each
assembly (K1's camera outputs and the objective), one (ncams, 90) for the
reduced right-hand side with the Schur diagonal (K2), one (ncams, 9) per
CG matvec (K3), and a few O(1) sums; the other routes the same sums from
their own stages.

PCG steps only, as in the JAX package; the mesh path of `lm_jit.py` and
`lm.py` takes every step solver. A float64 problem runs the plain stages
(`ops/normal.py:solve_stages`) under the same all-reduces, where the JAX
driver refuses float64 with its Pallas kernels on. The route is picked
once from the global problem (`ops/normal.py:kernel_route` of the
:class:`SpmdProblem`) and checked to be the same on every rank before the
first collective of the solve (`lm_jit._check_lockstep`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch.distributed as dist

from bundleadjustment_jl_tpu_torch.parallel.spmd import SpmdProblem
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    _OPTIONS, LMJitResult, levenberg_marquardt_jit,
    levenberg_marquardt_jit_chunked)

# The step solvers other than PCG, which the spmd drivers refuse.
_OTHER_SOLVERS = ("use_dense", "use_cgls", "use_power")


def _options(sp, options: dict) -> dict:
    """``options`` over the one-shot driver's defaults; unknown keywords
    raise ``TypeError``, a step solver other than PCG ``ValueError``, as
    does ``sp`` other than point-aligned shards (:class:`SpmdProblem`)."""
    if not isinstance(sp, SpmdProblem):
        raise ValueError(f"the spmd drivers take point-aligned shards "
                         f"(shard_problem_kminor), not {type(sp).__name__}: "
                         f"solve camera groups through parallel.mesh")
    unknown = sorted(set(options) - set(_OPTIONS))
    if unknown:
        raise TypeError(f"unknown options: {unknown}")
    other = [k for k in _OTHER_SOLVERS if options.get(k)]
    if other:
        raise ValueError(f"the spmd drivers take PCG steps only, got "
                         f"{other[0]}=True")
    return {**_OPTIONS, **options}


def levenberg_marquardt_spmd(
    sp: SpmdProblem, group: Optional[dist.ProcessGroup] = None, *,
    max_iters: int = 200, **options,
) -> LMJitResult:
    """The one-shot LM solve of `solver/lm_jit.py:levenberg_marquardt_jit`
    (whose keywords ``options`` takes, PCG only) on this rank's shard of
    ``sp`` (:meth:`SpmdProblem.rank_shard`), the camera-space sums
    all-reduced over ``group`` (default: the world group), which must have
    ``sp.ndev`` ranks. Every rank of the group calls it and gets the same
    result; ``points`` is the global (npnts, 3) array."""
    opts = _options(sp, options)
    return levenberg_marquardt_jit(sp.rank_shard(group),
                                   max_iters=max_iters, **opts)


def levenberg_marquardt_spmd_chunked(
    sp: SpmdProblem, group: Optional[dist.ProcessGroup] = None, *,
    max_iters: int = 200, chunk_iters: int = 25,
    max_time: Optional[float] = None,
    checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
    resume: bool = False, callback: Optional[Callable] = None,
    **options,
) -> LMJitResult:
    """:func:`levenberg_marquardt_spmd` in chunks of ``chunk_iters``
    iterations with the chunked driver's host control between them
    (`solver/lm_jit.py:levenberg_marquardt_jit_chunked`):

    - ``max_time``: a wall-clock bound checked before each chunk; a rank
      past it stops every rank (the flag is all-reduced);
    - ``checkpoint_dir``: after every ``checkpoint_every`` chunks the ranks
      gather the global points and rank 0 writes the JAX package's
      ``step-<n>.npz`` (the cameras, the global points, lambda, the
      iteration, the objective and ``gtol``), which either package
      resumes;
    - ``resume=True``: every rank reads the latest checkpoint and takes
      its own shard of its points (:meth:`SpmdProblem.split_points`);
    - ``callback(dict)`` after each chunk on every rank (the values are
      replicated).

    Without these the chunks make the one-shot solve's decisions."""
    opts = _options(sp, options)
    return levenberg_marquardt_jit_chunked(
        sp.rank_shard(group), max_iters=max_iters, chunk_iters=chunk_iters,
        max_time=max_time, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, resume=resume, callback=callback,
        **opts)
