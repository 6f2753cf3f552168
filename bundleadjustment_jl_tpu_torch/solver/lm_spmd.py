"""Levenberg-Marquardt over ranks of a process group, a shard each
(PyTorch port of `bundleadjustment_jl_tpu/solver/lm_spmd.py`):
:func:`levenberg_marquardt_spmd` and its chunked form
:func:`levenberg_marquardt_spmd_chunked`.

Each rank is a process with its own device: ``cuda:LOCAL_RANK`` over NCCL
when the problem lived on a card, the CPU over gloo otherwise. Every rank
runs the whole LM loop of `solver/lm_jit.py` (its ``_setup``, ``_lm_init``
and ``_lm_run``) on its point-aligned shard (`parallel/spmd.py`):

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

PCG steps only, as in the JAX package. A float64 problem runs the plain
stages (`ops/normal.py:solve_stages`) under the same all-reduces, where the
JAX driver refuses float64 with its Pallas kernels on. The route is picked
once from the global problem (`ops/normal.py:kernel_route` of the
:class:`SpmdProblem`) and checked to be the same on every rank before the
first collective of the solve.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from bundleadjustment_jl_tpu_torch.models.problem import DTYPES
from bundleadjustment_jl_tpu_torch.ops import normal, spmdctx
from bundleadjustment_jl_tpu_torch.ops.normal import ROUTES, kernel_route
from bundleadjustment_jl_tpu_torch.parallel.spmd import SpmdProblem
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    _OPTIONS, MAX_TIME, RUNNING, STATUS_NAMES, LMJitResult, _finalize,
    _lm_init, _lm_run, _setup)
from bundleadjustment_jl_tpu_torch.utils.checkpoint import CheckpointManager

# The step solvers other than PCG, which the spmd drivers refuse.
_OTHER_SOLVERS = ("use_dense", "use_cgls", "use_power")


def _options(options: dict) -> dict:
    """``options`` over the one-shot driver's defaults; unknown keywords
    raise ``TypeError``, a step solver other than PCG ``ValueError``."""
    unknown = sorted(set(options) - set(_OPTIONS))
    if unknown:
        raise TypeError(f"unknown options: {unknown}")
    other = [k for k in _OTHER_SOLVERS if options.get(k)]
    if other:
        raise ValueError(f"the spmd drivers take PCG steps only, got "
                         f"{other[0]}=True")
    return {**_OPTIONS, **options}


def _rank_problem(sp: SpmdProblem, group):
    """``(group, rank, the rank's shard)`` after checking the group: it is
    initialized, has ``sp.ndev`` ranks, and its backend serves the shard's
    device (NCCL for a card, gloo for the CPU)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("the spmd drivers need a torch.distributed "
                           "process group (init_process_group)")
    group = dist.group.WORLD if group is None else group
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if world != sp.ndev:
        raise ValueError(f"SpmdProblem has {sp.ndev} shards but the group "
                         f"has {world} ranks: rebuild it with "
                         f"shard_problem_kminor(problem, {world})")
    lp = sp.local(rank)
    backend = str(dist.get_backend(group))
    need = "nccl" if lp.cams.is_cuda else "gloo"
    if need not in backend:
        raise ValueError(f"a shard on {lp.cams.device} needs a {need} "
                         f"group, this one is {backend}")
    return group, rank, lp


def _check_lockstep(cfg, lp) -> None:
    """Raise on every rank unless every rank took the same route, the same
    stage table (kernels or plain twins), working dtype and camera count:
    a rank that differed would make other collectives than the rest and
    hang them."""
    dt = lp.cams.dtype
    code = torch.tensor(
        [ROUTES.index(cfg.route), normal.PALLAS_MODE and dt != torch.float64,
         list(DTYPES.values()).index(dt), lp.ncams],
        dtype=torch.float64, device=lp.cams.device)
    hi, lo = spmdctx.pmax(code), -spmdctx.pmax(-code)
    if not torch.equal(hi, lo):
        raise RuntimeError(
            f"the ranks' solves differ (route, kernels, dtype, cameras): "
            f"between {lo.tolist()} and {hi.tolist()}")


def levenberg_marquardt_spmd(
    sp: SpmdProblem, group: Optional[dist.ProcessGroup] = None, *,
    max_iters: int = 200, **options,
) -> LMJitResult:
    """The one-shot LM solve of `solver/lm_jit.py:levenberg_marquardt_jit`
    (whose keywords ``options`` takes, PCG only) on this rank's shard of
    ``sp`` (:meth:`SpmdProblem.local`), the
    camera-space sums all-reduced over ``group`` (default: the world
    group), which must have ``sp.ndev`` ranks. Every rank of the group
    calls it and gets the same result; ``points`` is the global (npnts, 3)
    array."""
    opts = _options(options)
    group, rank, lp = _rank_problem(sp, group)
    with spmdctx.using(group):
        cfg = _setup(lp, lp.cams, lp.points, max_iters=max_iters,
                     route=kernel_route(sp), **opts)
        _check_lockstep(cfg, lp)
        st = _lm_init(cfg, lp.cams, lp.points)
        _lm_run(cfg, st, max_iters)
        res = _finalize(st)
        return res._replace(points=sp.global_points(res.points, group))


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
    opts = _options(options)
    group, rank, lp = _rank_problem(sp, group)
    cams, points = lp.cams, lp.points
    ckpt, restored = None, None
    if checkpoint_dir is not None:
        ckpt = CheckpointManager(checkpoint_dir, every=1)
        if resume:
            restored = ckpt.restore_latest()
            if restored is not None:
                cams = torch.as_tensor(restored["cams"], dtype=cams.dtype,
                                       device=cams.device)
                points = sp.split_points(torch.as_tensor(
                    restored["points"], dtype=points.dtype,
                    device=points.device), rank)

    with spmdctx.using(group):
        cfg = _setup(lp, cams, points, max_iters=max_iters,
                     route=kernel_route(sp), **opts)
        _check_lockstep(cfg, lp)
        t0 = time.perf_counter()
        st = _lm_init(cfg, cams, points)
        if restored is not None:
            st.lam, st.it = cfg.rnd(restored["lam"]), int(
                restored["iteration"])
            gtol = restored["meta"].get("gtol")
            if gtol is not None:
                st.gtol = cfg.rnd(gtol)

        final_status = None
        nchunk = 0
        while st.status == RUNNING and st.it < max_iters:
            if max_time is not None:
                late = torch.tensor(
                    float(time.perf_counter() - t0 > max_time),
                    device=cams.device)
                if bool(spmdctx.pmax(late)):
                    final_status = MAX_TIME
                    break
            _lm_run(cfg, st, min(st.it + chunk_iters, max_iters))
            nchunk += 1
            if ckpt is not None and nchunk % max(1, checkpoint_every) == 0:
                pts = sp.global_points(st.points, group)
                if rank == 0:
                    ckpt.maybe_save(st.it, st.cams, pts, lam=float(st.lam),
                                    meta={"objective": float(st.obj),
                                          "gtol": float(st.gtol),
                                          "problem": sp.name})
            if callback is not None:
                callback({"iter": st.it, "obj": float(st.obj),
                          "gnorm": float(st.gnorm), "lam": float(st.lam),
                          "status": STATUS_NAMES[st.status],
                          "elapsed": time.perf_counter() - t0})
        res = _finalize(st, final_status, elapsed=time.perf_counter() - t0)
        return res._replace(points=sp.global_points(res.points, group))
