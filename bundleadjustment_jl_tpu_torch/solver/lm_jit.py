"""Levenberg-Marquardt over the Schur-reduced camera system on the kernel
routes (PyTorch port of `bundleadjustment_jl_tpu/solver/lm_jit.py`):
:func:`levenberg_marquardt_jit` and its chunked form
:func:`levenberg_marquardt_jit_chunked`.

Same algorithm, options and decisions as the JAX drivers: the reference's
lambda schedule (or Nielsen's), gain-ratio acceptance with optional
batched linesearch scales, NaN-step rejection, the stopping tests in the
same order, and fixed-length history buffers. The step comes from
block-Jacobi PCG (default), the power series (``use_power``), a dense
Cholesky of S (``use_dense``) or CGLS on J (``use_cgls``).

PyTorch runs eagerly, so the loop is Python. The solver state (cameras,
points, the linearized blocks, W) stays on the device; the scalar
decisions run on the host in the working dtype (numpy float32/float64
scalars, so the rounding matches the JAX driver's device arithmetic). A
2-byte working dtype (bfloat16 or float16, the low stages of
`benchmark/precision.py`) has no numpy scalar on every machine (numpy has
no bfloat16): its host scalars are float32, and each value the solve
carries from one step to the next (lambda, nu, the tolerances, the CG
tolerance, gtol) is rounded to the working dtype where it is made, as the
JAX driver's carry rounds it; the values read from the device are in the
working dtype already. In between, the host computes in float32, as XLA
computes a fused chain of bfloat16 operations.
Host reads per LM iteration: one flag per CG step (`ops/pcg.py`; a power
term and a CGLS step alike), one packed block (trial objectives, g'd,
||J d||^2, ||d||, ||x||) at the accept decision, and — after an accepted
step — the new objective and gradient norm that the stopping tests need.
Each is counted in `utils/profiling.py:COUNTERS` (``host_reads``), and the
stages of a solve are spans there (:func:`solve_step`, :func:`_linearize`,
:func:`_lm_run`'s ``ba.trial``, ``ba.solve`` around a driver's call).

As in the JAX package, the solve is an init (:func:`_lm_init`: the first
linearization and the state) and a run until a status or an iteration
bound (:func:`_lm_run`); the one-shot driver runs to ``max_iters``, the
chunked one in chunks with host checks between them, which read nothing
from the device (the scalars are on the host already).

Both drivers take a mesh shard (`parallel/mesh.py:shard_problem`, a
:class:`MeshShard`) as they take a problem: every rank of its group runs
the same init and run on its shard under `ops/spmdctx.py`'s hooks. The
stage table all-reduces every camera-space sum; every point-space value
the loop reads (the point parts of g'd, ||d||, ||x||, ||J'r|| and
||J d||^2, max Hpp for lambda_0, max|W| for a float16 W, the CGLS and
dense steps' row and point sums) goes through the hooks too, so every
rank reads the same scalars and makes the same decisions. On a
point-aligned shard the points are the rank's own; on the camera groups
of a partitioned problem (``layout = "cameras"``) every rank holds them
all, the table all-reduces the point sums as well, and the point parts of
the scalars are already whole. The route
is picked from the global problem and checked across the ranks before the
first collective (:func:`_check_lockstep`); the result holds the global
points on every rank; rank 0 writes the checkpoints, of the global
points, and every rank resumes from them.

``facto_dtype`` (bfloat16 or float16) stores the per-observation W blocks
in that dtype, as the JAX solver does (:func:`maybe_cast_facto`); a 2-byte
working dtype stores W in itself. With either come the narrow CG floor, the
CG stagnation stop and the predicted-reduction stop.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bundleadjustment_jl_tpu_torch.models.problem import (
    DTYPES, HALF_DTYPES, BAProblem, host_dtype, torch_dtype)
from bundleadjustment_jl_tpu_torch.ops import normal, spmdctx
from bundleadjustment_jl_tpu_torch.ops._cuda import (
    W_DTYPES, W_READERS, W_WRITERS)
from bundleadjustment_jl_tpu_torch.ops.cgls import cgls_solve, j_matvec
from bundleadjustment_jl_tpu_torch.ops.fused_schur import relin_wcw_rhs
from bundleadjustment_jl_tpu_torch.ops.normal import (
    ROUTES, GNBlocks, assemble_blocks, gradient_norm, kernel_route,
    solve_stages)
from bundleadjustment_jl_tpu_torch.ops.pcg import (
    STAGNATION_WINDOW, block_jacobi_apply, block_jacobi_inverse,
    forcing_rtol, pcg, power_series)
from bundleadjustment_jl_tpu_torch.ops.schur import (
    back_substitute_quad, check_dense_feasible, dense_pair_count,
    reduce_and_diag, reduce_system, schur_matvec, solve_dense)
from bundleadjustment_jl_tpu_torch.parallel.spmd import MeshShard
from bundleadjustment_jl_tpu_torch.utils.checkpoint import CheckpointManager
from bundleadjustment_jl_tpu_torch.utils.profiling import host_read, span

# The kernel route of a solve is one of `ops/normal.py:ROUTES`, which lists
# each route's kernels; `ops/normal.py:kernel_route` picks it once per call
# of a driver from the switch and size gates beside it (`FORCE_ROUTE`
# there sets them to force a route). Beside it, once per call,
# `ops/normal.py:solve_stages` picks the stage table: the kernel wrappers, or
# their plain twins for float64, a partitioned problem (`pnt_perm`) or with
# `normal.PALLAS_MODE` off (the JAX solver keeps XLA there), no kernel
# launched.

# The step solvers (``solver`` of the host driver; ``use_<name>`` of the
# jit drivers, "pcg" when none is set).
SOLVERS = ("pcg", "dense", "cgls", "power")

# Each route's assembly launches (at init and per accept).
_ASSEMBLY = {
    "fused": ("assemble",),
    "sorted": ("linearize", "seg_prod_cam90", "seg_prod_pnt12"),
    "scatter_split": ("linearize", "cam_relin_cam90", "seg_prod_pnt12"),
    "sorted_relin": ("linearize", "cam_relin_cam90", "linearize_w_only",
                     "seg_prod_pnt12"),
}


def expected_launches(route: str, iterations: int, naccepts: int, cg: int,
                      solver: str = "pcg", facto_dtype=None,
                      work_dtype: torch.dtype = torch.float32) -> dict:
    """The kernel launches (`ops/_cuda.py:LAUNCHES` keys) a solve on
    ``route`` with step ``solver`` makes, from its iterations (step
    solves), accepts and CG steps (Σ ``hist_cg``: power terms for
    ``power``, CGLS steps for ``cgls``, 0 for ``dense``); every key not
    named launches 0 times.

    Every solver: K4 once per iteration; the route's assembly (:data:`_ASSEMBLY`)
    at init and per accept — K1 on A; K7 with K6 pnt12 and K6 cam90 (C)
    or K2 cam90 re-derived in camera order (B1, B2, and K8 on B2)
    elsewhere. ``cgls`` launches nothing else (its J products are torch
    ops) and assembles A as B1 (K1 writes no JR).

    ``pcg``: fused (A): K2 W C W' | W t once per iteration, K3 once per CG
    step plus the initial residual and the back-substitution.
    Camera-sorted (C, B2): K6's W C W' once per iteration, K5's point
    direction once per CG step plus two, its camera direction once more
    per iteration (the reduced right-hand side and the |J d|^2 cross term,
    less the back-substitution). B1: K2 W C W' | W t once per iteration
    (re-derived in camera order, ``cam_relin_wcw_rhs``, where
    `ops/fused_schur.py:relin_wcw_rhs` says so for W stored in
    ``facto_dtype``, None: the working dtype ``work_dtype``), K5's point
    direction and K2's W op each once per CG step plus two.

    ``power`` and ``dense`` (``reduce_system``, no diagonal blocks, no
    initial residual): the right-hand side's camera sum once per
    iteration (K2 W op on A and B1, K5's camera direction on C and B2),
    one Schur matvec per power term, then the back-substitution and
    |J d|^2 (K3 on A; K5's point direction and the camera sum elsewhere).
    ``dense`` also assembles S by the pair kernel (``dense_pairs``) once
    per iteration.

    ``pcg``, ``power`` and ``dense`` on every route: the point blocks'
    damped inverse with ``Hpp_inv g_p`` (``point_inv``) and ``dp' Hpp dp``
    (``point_quad``) once per iteration."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; one of {SOLVERS}")
    it, acc = iterations, naccepts
    expect = {"objective": it}
    asm = "scatter_split" if solver == "cgls" and route == "fused" else route
    expect.update(dict.fromkeys(_ASSEMBLY[asm], 1 + acc))
    if solver == "cgls":
        return expect
    expect.update(point_inv=it, point_quad=it)
    if solver == "dense":
        expect.update(dense_pairs=it)
    split = route in ("sorted", "sorted_relin")
    if solver == "pcg":
        if route == "fused":
            expect.update(cam_reduce=it, matvec=cg + 2 * it)
        elif route == "scatter_split":
            walk = relin_wcw_rhs(facto_dtype or work_dtype, work_dtype)
            expect.update({("cam_relin_wcw_rhs" if walk
                            else "cam_reduce"): it},
                          seg_block_point=cg + 2 * it,
                          cam_reduce_w_op=cg + 2 * it)
        else:
            expect.update(seg_prod_wcw81=it, seg_block_point=cg + 2 * it,
                          seg_block_camera=cg + 3 * it)
    elif route == "fused":
        expect.update(cam_reduce_w_op=it, matvec=cg + it)
    else:
        expect.update({"seg_block_point": cg + it,
                       ("seg_block_camera" if split else "cam_reduce_w_op"):
                       cg + 2 * it})
    return expect


def expected_host_reads(iterations: int, naccepts: int, hist_cg,
                        max_steps: int, solver: str = "pcg") -> int:
    """The host reads (`utils/profiling.py:COUNTERS`) a jit solve with the
    ``pcg``, ``power`` or ``dense`` step makes, from its decisions, less
    those of its launch plans (the dense step's pair count and pair plan
    among them): the initial read; per iteration the step's flags (one a
    CG step or power term, and one more where the step stopped before
    ``max_steps``; none for ``dense``, whose Cholesky step reads nothing)
    and the packed read; per accept the new objective's read."""
    flags = 0 if solver == "dense" else sum(
        int(c) + (int(c) < max_steps) for c in hist_cg[:iterations])
    return 1 + flags + iterations + naccepts


def expected_w_launches(launches: dict, facto_dtype,
                        work_dtype: torch.dtype = torch.float32) -> dict:
    """The W storage of a solve's launches (`ops/_cuda.py:W_LAUNCHES`),
    from its kernel launches (``_cuda.LAUNCHES``), its ``facto_dtype`` and
    its working dtype: the writers write W in :func:`w_assemble_dtype`, the
    readers read it in ``facto_dtype``; where that is None, in a 2-byte
    working dtype, else in float32."""
    plain = work_dtype if work_dtype in HALF_DTYPES else torch.float32
    out = dict.fromkeys(W_DTYPES, 0)
    out[w_assemble_dtype(facto_dtype) or plain] += sum(
        launches[k] for k in W_WRITERS)
    out[facto_dtype or plain] += sum(launches[k] for k in W_READERS)
    return out


# CG relative-tolerance floor under narrow W storage, as a multiple of
# eps(facto_dtype) (the JAX solver's _CG_FLOOR_MULT): a bfloat16 / float16
# W bounds the matvec's accuracy, and CG below ~8 eps(facto) chases noise.
CG_FLOOR_MULT = 8.0

# Storage dtypes `facto_dtype` takes: those the W kernels take.
FACTO_DTYPES = W_DTYPES


def w_assemble_dtype(facto_dtype: torch.dtype | None):
    """The dtype the assembly may write W in directly (the JAX solver's
    `_w_assemble_dtype`): bfloat16 shares float32's exponent range; float16
    must not be written raw (max|W| ~ f^2 overflows it before the range
    scale is known), so it is written in the working dtype and cast by
    :func:`maybe_cast_facto`."""
    if facto_dtype is None or facto_dtype == torch.float16:
        return None
    return facto_dtype


def f16_scale(W_t: torch.Tensor) -> torch.Tensor:
    """The range scale of a float16 W (the JAX solver's, after the
    reference's `normalize_F16!`): the power of two that puts max|W| near
    2^14, a 0-d float32 tensor on W's device (no host read); in a
    multi-process solve max|W| over every rank's rows."""
    lo, hi = torch.aminmax(W_t)
    wmax = spmdctx.pmax(torch.maximum(-lo, hi).float())
    safe = torch.where(torch.isfinite(wmax) & (wmax > 0), wmax,
                       torch.ones_like(wmax))
    return torch.exp2(torch.floor(torch.log2(16384.0 / safe)))


def narrow_w(W: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """W as a solve with ``facto_dtype=dtype`` stores it: rounded to
    ``dtype``, a float16 W first scaled by :func:`f16_scale` (float32 is
    kept as it is)."""
    if dtype == torch.float16:
        W = W * f16_scale(W)
    return W.to(dtype).contiguous()


def maybe_cast_facto(blocks, facto_dtype: torch.dtype | None):
    """The blocks with W stored in ``facto_dtype`` (the JAX solver's
    `_maybe_cast_facto`): float16 as ``s W`` with ``s = f16_scale(W)`` in
    ``w_scale``, ``W_cam_t`` alike; a W already written in the storage dtype
    (:func:`w_assemble_dtype`) is returned as it is. Hcc and Hpp stay in
    the working dtype."""
    if facto_dtype is None or (facto_dtype != torch.float16
                               and blocks.W_t.dtype == facto_dtype):
        return blocks
    scale = f16_scale(blocks.W_t) if facto_dtype == torch.float16 else None

    def store(W):
        if W is None:
            return None
        return (W if scale is None else W * scale).to(facto_dtype)

    return blocks._replace(
        W_t=store(blocks.W_t), W_cam_t=store(blocks.W_cam_t),
        w_scale=None if scale is None else scale.to(blocks.W_t.dtype))


# Status codes (the JAX package's mapping of the reference statuses)
RUNNING = 0
FIRST_ORDER = 1
SMALL_RESIDUAL = 2
SMALL_STEP = 3
SMALL_OBJ_CHANGE = 4
MAX_ITER = 5
EXCEPTION = 6
MAX_TIME = 7

STATUS_NAMES = {
    FIRST_ORDER: "first_order",
    SMALL_RESIDUAL: "small_residual",
    SMALL_STEP: "small_step",
    SMALL_OBJ_CHANGE: "small_obj_change",
    MAX_ITER: "max_iter",
    EXCEPTION: "exception",
    MAX_TIME: "max_time",
    RUNNING: "running",
}


class LMJitResult(NamedTuple):
    cams: torch.Tensor          # (ncams, 9), on the problem's device
    points: torch.Tensor        # (npnts, 3)
    objective: float
    dual_feas: float            # ||J'r||
    iterations: int
    status: int                 # see STATUS_NAMES
    # per-iteration traces, length max_iters (valid up to `iterations`)
    hist_obj: np.ndarray
    hist_gnorm: np.ndarray
    hist_lam: np.ndarray
    hist_cg: np.ndarray         # int32 CG matvecs per iteration
    naccepts: int
    elapsed_time: float = math.nan  # wall seconds (chunked driver only)

    def status_name(self) -> str:
        return STATUS_NAMES[int(self.status)]

    @property
    def neval_jac(self) -> int:
        """One linearization per accepted step plus the initial one (the
        reference's `neval_jac`, `BALNLPModels.jl:162`)."""
        return int(self.naccepts) + 1

    @property
    def neval_residual(self) -> int:
        """One (batched) trial objective per iteration plus the
        linearizations' residuals."""
        return int(self.iterations) + self.neval_jac


def _host_scalar(dtype: torch.dtype) -> Callable:
    """A value (a Python float or a numpy scalar) as the host holds it in
    working dtype ``dtype``: a numpy scalar of that dtype, or for a 2-byte
    one a numpy float32 rounded to it (through float32, as the JAX
    package's numpy conversion rounds)."""
    ft = host_dtype(dtype).type
    if dtype not in HALF_DTYPES:
        return ft

    def rnd(x):
        return ft(torch.tensor(float(ft(x)), dtype=torch.float32)
                  .to(dtype).item())
    return rnd


def _ipow(x, y: int):
    """x ** y by binary exponentiation, the order XLA's integer_pow uses."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc




def solve_step(problem: BAProblem, blocks: GNBlocks, lam, rtol,
               solver: str, max_iters: int, x0=None,
               stagnation_window: int = 0):
    """One damped step ``(dc, dp, ||J d||^2, its CG steps)`` at ``lam``
    by ``solver`` (:data:`SOLVERS`), ``rtol`` the inner tolerance and
    ``max_iters`` its step bound (power terms, CGLS steps), as the JAX
    drivers' branches compute it:

    - ``pcg``: ``reduce_and_diag``, block-Jacobi of S's exact diagonal,
      PCG from ``x0`` (None: zero) with ``stagnation_window``;
    - ``power``: ``reduce_system``, block-Jacobi of ``Hcc_l``, the power
      series (one Schur matvec a term);
    - ``dense``: ``reduce_system`` and the dense Cholesky of S;
    - these three then ``back_substitute_quad`` for ``dp`` and the
      quadratic form;
    - ``cgls``: CGLS on the blocks' ``JR_t``, ``||J d||^2`` from
      ``j_matvec`` (its row sum all-reduced on a mesh shard).

    Spans (`utils/profiling.py`): ``ba.reduce`` (the reduction and the
    preconditioner), ``ba.pcg`` (the step solver), ``ba.backsub``.
    """
    lam = float(lam)
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; one of {SOLVERS}")
    if solver == "cgls":
        with span("ba.pcg"):
            res = cgls_solve(problem, blocks, lam, rtol, max_iters=max_iters)
        with span("ba.backsub"):
            Jd = j_matvec(problem, blocks, res.dc, res.dp)
            Jd2 = spmdctx.psum(torch.sum(Jd * Jd))
        return res.dc, res.dp, Jd2, res.iters
    with span("ba.reduce"):
        if solver == "pcg":
            sys, Sd = reduce_and_diag(problem, blocks, lam)
            M_inv = block_jacobi_inverse(Sd)
        else:
            sys = reduce_system(problem, blocks, lam)
            if solver == "power":
                M_inv = block_jacobi_inverse(sys.Hcc_l)
    with span("ba.pcg"):
        if solver == "pcg":
            res = pcg(lambda v: schur_matvec(sys, v), sys.b,
                      lambda v: block_jacobi_apply(M_inv, v),
                      rtol=float(rtol), max_iters=max_iters, x0=x0,
                      stagnation_window=stagnation_window)
            dc, iters = res.x, res.iters
        elif solver == "power":
            res = power_series(
                lambda v: schur_matvec(sys, v), sys.b,
                lambda v: torch.einsum("cab,cb->ca", sys.Hcc_l, v),
                lambda v: block_jacobi_apply(M_inv, v), rtol=float(rtol),
                max_terms=max_iters)
            dc, iters = res.x, res.iters
        else:
            dc, iters = solve_dense(sys), 0
    with span("ba.backsub"):
        dp, Jd2 = back_substitute_quad(problem, blocks, sys, dc)
    return dc, dp, Jd2, iters


@dataclasses.dataclass
class _Setup:
    """What a solve fixes at entry: the problem, its route and stage table,
    the step solver, W's storage and the resolved options (host scalars of
    the working dtype, made by ``rnd``: :func:`_host_scalar`)."""
    problem: BAProblem
    route: str
    stages: object
    solver: str
    facto_dtype: Optional[torch.dtype]
    w_dtype: Optional[torch.dtype]
    narrow: bool
    ft: type
    rnd: Callable
    tol: dict
    lam0: Optional[float]
    lam0_mode: str
    nielsen: bool
    pcg_rtol: Optional[float]
    pcg_max_iters: int
    pcg_warm: bool
    cg_floor: Optional[float]
    stagnation: int
    scales_np: np.ndarray
    scales: torch.Tensor
    n_halvings: int
    max_iters: int


@dataclasses.dataclass
class _State:
    """The solver state carried between iterations (and chunks)."""
    cams: torch.Tensor
    points: torch.Tensor
    blocks: GNBlocks
    obj: np.floating
    gnorm: np.floating
    lam: np.floating
    nu: np.floating
    gtol: np.floating
    dc_carry: torch.Tensor
    hist_obj: np.ndarray
    hist_gnorm: np.ndarray
    hist_lam: np.ndarray
    hist_cg: np.ndarray
    naccepts: int = 0
    it: int = 0
    status: int = RUNNING


def _whole(problem: BAProblem):
    """The global problem's sizes: a mesh shard's :class:`SpmdProblem`,
    else the problem itself."""
    return problem.spmd if isinstance(problem, MeshShard) else problem


def _ranks(problem: BAProblem):
    """The context of a solve of ``problem``: its rank group's hooks
    (`spmdctx.using`, with its layout) for a mesh shard, else none."""
    if isinstance(problem, MeshShard):
        return spmdctx.using(problem.group,
                             camera_groups=problem.layout == "cameras")
    return contextlib.nullcontext()


def _local_points(problem: BAProblem, points: torch.Tensor) -> torch.Tensor:
    """A mesh shard's rows of the global (npnts, 3) ``points``; ``points``
    itself for a problem."""
    if isinstance(problem, MeshShard):
        return problem.spmd.split_points(points, problem.rank)
    return points


def _global_points(problem: BAProblem, points: torch.Tensor) -> torch.Tensor:
    """The global (npnts, 3) points from a mesh shard's (an all-gather:
    every rank calls it); ``points`` itself for a problem."""
    if isinstance(problem, MeshShard):
        return problem.spmd.global_points(points, problem.group)
    return points


def _rank0(problem: BAProblem) -> bool:
    """Whether this is rank 0 of a mesh shard's group, which writes the
    checkpoints and logs (true off a mesh)."""
    return not isinstance(problem, MeshShard) or problem.rank == 0


def _any_rank(flag: bool, device) -> bool:
    """``flag`` or'ed over the ranks of a solve on a mesh shard (a host
    decision every rank must take alike); ``flag`` itself off a mesh."""
    if spmdctx.GROUP is None:
        return flag
    return bool(host_read(spmdctx.pmax(torch.tensor(float(flag),
                                                    device=device))))


def _check_lockstep(problem: BAProblem, route: str, solver: str) -> None:
    """On a mesh shard, raise on every rank unless every rank took the same
    route, stage table (kernels or plain twins), working dtype, step
    solver, camera count and layout: a rank that differed would make other
    collectives than the rest and hang them. Nothing off a mesh."""
    if spmdctx.GROUP is None:
        return
    dt = problem.cams.dtype
    code = torch.tensor(
        [ROUTES.index(route), not normal.plain_route(dt, problem),
         list(DTYPES.values()).index(dt), SOLVERS.index(solver),
         problem.ncams, spmdctx.CAMERA_GROUPS],
        dtype=torch.float64, device=problem.cams.device)
    hi, lo = spmdctx.pmax(code), -spmdctx.pmax(-code)
    if not torch.equal(host_read(hi), lo):
        raise RuntimeError(
            f"the ranks' solves differ (route, kernels, dtype, solver, "
            f"cameras, layout): between {lo.tolist()} and {hi.tolist()}")


def _setup(problem: BAProblem, cams, points, *, max_iters, lam0,
           lam0_mode, atol, rtol, restol, satol, srtol, oatol, ortol, nu_d,
           nu_m, accept_ratio, good_ratio, lam_min, lam_strategy, pcg_rtol,
           pcg_max_iters, use_dense, use_cgls, use_power, linesearch,
           ls_max, facto_dtype, pcg_warm) -> _Setup:
    """Check the options and resolve them (``None`` tolerances to the
    reference defaults in the working dtype); pick the route
    (`kernel_route` of the global problem) and the stage table
    (`solve_stages` of the problem: plain for a partitioned one) once. On
    a mesh shard it runs inside the rank group's hooks (:func:`_ranks`),
    so the stage table carries the all-reduces; the dense step's memory
    check judges the rank's own shard."""
    if facto_dtype is not None and facto_dtype not in FACTO_DTYPES:
        raise TypeError(f"facto_dtype: one of {FACTO_DTYPES}, got "
                        f"{facto_dtype!r}")
    dt = cams.dtype
    # The JAX driver's branch order: CGLS, then power, then dense.
    solver = ("cgls" if use_cgls else "power" if use_power
              else "dense" if use_dense else "pcg")
    if solver == "dense":
        # A 2-byte W (stored narrow or in a 2-byte working dtype) is
        # factored in float32 (`ops/schur.py:_dense_dtype`); the estimate
        # is the route's that will assemble S (the kernel route's counts
        # the problem's camera pairs: one host read).
        check_dense_feasible(problem.ncams, problem.npnts, problem.nobs_pad,
                             4 if facto_dtype is not None
                             or dt in HALF_DTYPES else cams.element_size(),
                             dense_pair_count(problem, dt))
    # "Narrow" (the JAX solver's `facto_narrow`): W stored below 4 bytes,
    # or a working dtype below 4 bytes. Only then the CG floor (in eps of
    # the storage dtype, else of the working dtype), the CG stagnation stop
    # and the predicted-reduction stop; float32 storage keeps the
    # reference's stopping semantics.
    narrow = ((facto_dtype is not None and facto_dtype.itemsize < 4)
              or dt.itemsize < 4)
    ft = host_dtype(dt).type
    rnd = _host_scalar(dt)
    eps = ft(torch.finfo(dt).eps)
    cbrt, sqrt_eps = eps ** (1.0 / 3.0), np.sqrt(eps)

    def pick(v, d):
        return rnd(d if v is None else v)

    tol = dict(atol=pick(atol, sqrt_eps), rtol=pick(rtol, cbrt),
               restol=pick(restol, cbrt), satol=pick(satol, sqrt_eps),
               srtol=pick(srtol, sqrt_eps), oatol=pick(oatol, sqrt_eps),
               ortol=pick(ortol, cbrt), nu_d=rnd(nu_d), nu_m=rnd(nu_m),
               lam_min=rnd(lam_min), accept_ratio=rnd(accept_ratio),
               good_ratio=rnd(good_ratio))
    scales_np = np.asarray(
        [1.0] + ([0.5 ** j for j in range(1, ls_max + 1)]
                 if linesearch else []), dtype=ft)
    floor_dtype = facto_dtype if facto_dtype is not None else dt
    return _Setup(
        problem=problem, route=kernel_route(_whole(problem)),
        stages=solve_stages(dt, problem), solver=solver,
        facto_dtype=facto_dtype, w_dtype=w_assemble_dtype(facto_dtype),
        narrow=narrow, ft=ft, rnd=rnd, tol=tol, lam0=lam0,
        lam0_mode=lam0_mode,
        nielsen=lam_strategy == "nielsen", pcg_rtol=pcg_rtol,
        pcg_max_iters=pcg_max_iters, pcg_warm=pcg_warm,
        cg_floor=(rnd(CG_FLOOR_MULT * float(torch.finfo(floor_dtype).eps))
                  if narrow else None),
        stagnation=STAGNATION_WINDOW if narrow else 0, scales_np=scales_np,
        scales=torch.as_tensor(scales_np, device=cams.device).to(dt),
        n_halvings=ls_max if linesearch else 0, max_iters=max_iters)


def _linearize(cfg: _Setup, cams, points):
    """The blocks at (cams, points) with W in its storage dtype, and the
    objective and gradient norm on the device (no host read); span
    ``ba.linearize``."""
    with span("ba.linearize"):
        blocks = assemble_blocks(cfg.problem, cams, points, route=cfg.route,
                                 w_dtype=cfg.w_dtype, stages=cfg.stages,
                                 with_jr=cfg.solver == "cgls")
        return (maybe_cast_facto(blocks, cfg.facto_dtype), blocks.obj,
                gradient_norm(blocks))


def _lm_init(cfg: _Setup, cams, points) -> _State:
    """The initial linearization and solver state; one host read."""
    # Full-precision f32 products on the card (no TF32): the counterpart of
    # the JAX package's Precision.HIGHEST pins.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    ft, rnd = cfg.ft, cfg.rnd
    blocks, obj, gnorm = _linearize(cfg, cams, points)
    init = [obj, gnorm]
    if cfg.lam0_mode == "diag":
        init.append(torch.maximum(
            torch.max(blocks.Hcc_f.reshape(-1, 81)[:, ::10]),
            spmdctx.pmax_points(
                torch.max(blocks.Hpp_f.reshape(-1, 9)[:, ::4]))))
    init = host_read(torch.stack(init).to(torch_dtype(ft))).cpu().numpy()
    obj, gnorm = ft(init[0]), ft(init[1])
    with np.errstate(all="ignore"):
        if cfg.lam0_mode == "diag":
            lam = rnd(rnd(1e-3) * ft(init[2]))
        else:
            lam = rnd(np.maximum(ft(30.0), rnd(1e10)
                                 / np.maximum(gnorm, rnd(1e-300))))
    if cfg.lam0 is not None:
        lam = rnd(cfg.lam0)
    n = cfg.max_iters
    return _State(
        cams=cams, points=points, blocks=blocks, obj=obj, gnorm=gnorm,
        lam=lam, nu=ft(2.0),
        # fixed at entry
        gtol=rnd(cfg.tol["atol"] + cfg.tol["rtol"] * gnorm),
        dc_carry=torch.zeros_like(cams), hist_obj=np.zeros((n,), ft),
        hist_gnorm=np.zeros((n,), ft), hist_lam=np.zeros((n,), ft),
        hist_cg=np.zeros((n,), np.int32))


def _lm_run(cfg: _Setup, st: _State, it_max: int) -> None:
    """Run LM iterations on ``st`` until its status is not RUNNING or
    ``st.it == it_max``."""
    problem, ft, rnd, t = cfg.problem, cfg.ft, cfg.rnd, cfg.tol
    scales_np, scales = cfg.scales_np, cfg.scales
    while st.it < it_max and st.status == RUNNING:
        cams, points, blocks = st.cams, st.points, st.blocks
        obj, gnorm, lam, nu = st.obj, st.gnorm, st.lam, st.nu
        with np.errstate(all="ignore"):
            rtol_cg = (rnd(forcing_rtol(gnorm)) if cfg.pcg_rtol is None
                       else rnd(cfg.pcg_rtol))
            if cfg.cg_floor is not None:
                rtol_cg = np.maximum(rtol_cg, cfg.cg_floor)
        dc, dp, Jd2, cg_iters = solve_step(
            problem, blocks, lam, rtol_cg, cfg.solver, cfg.pcg_max_iters,
            x0=st.dc_carry if cfg.pcg_warm else None,
            stagnation_window=cfg.stagnation)

        with span("ba.trial"):
            # The point parts of g'd, ||d||^2 and ||x||^2 (one all-reduce
            # on point-aligned shards; the camera parts are replicated).
            pnt = spmdctx.psum_points(torch.stack([
                torch.sum(blocks.g_p * dp), torch.sum(dp * dp),
                torch.sum(points ** 2)]))
            gd = torch.sum(blocks.g_c * dc) + pnt[0]
            dnorm_t = torch.sqrt(torch.sum(dc * dc) + pnt[1])
            xnorm = torch.sqrt(torch.sum(cams ** 2) + pnt[2])
            objs_t = cfg.stages.objective_scatter(
                problem, cams[None] + scales[:, None, None] * dc[None],
                points[None] + scales[:, None, None] * dp[None])
            packed = torch.cat([objs_t,
                                torch.stack([gd, Jd2, dnorm_t, xnorm])])
            packed = host_read(packed.to(torch_dtype(ft))).cpu().numpy()
        objs = packed[:-4]
        gd, Jd2, dnorm, xnorm = (ft(v) for v in packed[-4:])

        with np.errstate(all="ignore"):
            # A NaN step (Cholesky of a near-indefinite system at small
            # lambda) is a rejection; only a NaN at lambda > 1e20 is fatal.
            # Constants round to the working dtype, as the JAX driver's
            # weakly typed ones do: in float16, 1e20 is inf and no NaN step
            # is fatal.
            nan_step = not np.isfinite(dnorm)
            fatal_nan = nan_step and lam > rnd(1e20)
            small_step = (not nan_step) and dnorm < t["satol"] \
                + t["srtol"] * xnorm

            preds = -scales_np * gd - ft(0.5) * scales_np * scales_np * Jd2
            areds = obj - objs
            ok = (preds > 0) & (areds >= t["accept_ratio"] * preds) \
                & np.isfinite(objs)
            first = int(np.argmax(ok))
            s_sel, pred, ared = scales_np[first], preds[first], areds[first]
            accept = bool(ok.any()) and not nan_step

            # lambda update: reference schedule or Nielsen's.
            rho = ared / pred if pred > 0 else ft(-np.inf)
            q = ft(2.0) * rho - ft(1.0)
            nl_acc = np.maximum(
                lam * np.maximum(rnd(1.0 / 3.0), ft(1.0) - q * (q * q)),
                t["lam_min"])
            nl_rej = lam * nu
            nu_d = t["nu_d"]
            ref_acc = np.maximum(
                lam / nu_d / (nu_d if ared >= t["good_ratio"] * pred
                              else ft(1.0)), t["lam_min"])
            dnorm_safe = dnorm if np.isfinite(dnorm) else ft(np.inf)
            ref_rej = (np.maximum(lam, ft(1.0) / np.maximum(
                dnorm_safe, rnd(1e-300)))
                       * _ipow(t["nu_m"], cfg.n_halvings + 1))
            if cfg.nielsen:
                lam_new = nl_acc if accept else nl_rej
                nu_new = ft(2.0) if accept else nu * ft(2.0)
            else:
                lam_new = ref_acc if accept else ref_rej
                nu_new = nu
            lam_new, nu_new = rnd(lam_new), rnd(nu_new)

        it = st.it
        st.hist_obj[it], st.hist_gnorm[it], st.hist_lam[it] = obj, gnorm, lam
        st.hist_cg[it] = cg_iters
        if accept:
            st.cams = cams + float(s_sel) * dc
            st.points = points + float(s_sel) * dp
            st.blocks, obj_t, gnorm_t = _linearize(cfg, st.cams, st.points)
            new = host_read(torch.stack([obj_t, gnorm_t])
                            .to(torch_dtype(ft))).cpu()
            obj_n, gnorm_n = (ft(v) for v in new.numpy())
            st.naccepts += 1
        else:
            obj_n, gnorm_n = obj, gnorm

        with np.errstate(all="ignore"):
            obj_tol = t["oatol"] + t["ortol"] * np.abs(obj)
            small_obj = accept and obj - obj_n < obj_tol
            if cfg.narrow:
                # Predicted-reduction stop: even the model's full decrease
                # is below the tolerance, while the gradient is within
                # three orders of gtol (not a lambda blow-up after
                # rejections).
                small_obj = small_obj or bool(
                    pred > 0 and pred < obj_tol
                    and gnorm < rnd(1e3) * st.gtol)
            rnorm_n = np.sqrt(ft(2.0) * obj_n)
        if fatal_nan:
            st.status = EXCEPTION
        elif small_step:
            st.status = SMALL_STEP
        elif gnorm_n < st.gtol:
            st.status = FIRST_ORDER
        elif rnorm_n < t["restol"]:
            st.status = SMALL_RESIDUAL
        elif small_obj:
            st.status = SMALL_OBJ_CHANGE
        # never carry a NaN step into the next warm start
        st.dc_carry = dc if math.isfinite(dnorm) else torch.zeros_like(dc)
        st.obj, st.gnorm, st.lam, st.nu = obj_n, gnorm_n, lam_new, nu_new
        st.it = it + 1


def _finalize(st: _State, final_status: Optional[int] = None,
              elapsed: float = math.nan) -> LMJitResult:
    status = st.status
    if status == RUNNING:
        status = MAX_ITER if final_status is None else final_status
    return LMJitResult(
        cams=st.cams, points=st.points, objective=float(st.obj),
        dual_feas=float(st.gnorm), iterations=st.it, status=status,
        hist_obj=st.hist_obj, hist_gnorm=st.hist_gnorm,
        hist_lam=st.hist_lam, hist_cg=st.hist_cg, naccepts=st.naccepts,
        elapsed_time=elapsed)


def levenberg_marquardt_jit(
    problem: BAProblem, cams=None, points=None, *,
    max_iters: int = 200,
    lam0=None, lam0_mode: str = "ref",
    atol=None, rtol=None, restol=None, satol=None, srtol=None,
    oatol=None, ortol=None,
    nu_d=3.0, nu_m=3.0, accept_ratio=1e-4, good_ratio=0.9, lam_min=1e-8,
    lam_strategy: str = "ref",
    pcg_rtol=None, pcg_max_iters: int = 100,
    use_dense: bool = False, use_cgls: bool = False,
    use_power: bool = False,
    linesearch: bool = False, ls_max: int = 4,
    facto_dtype=None, pcg_warm: bool = False,
) -> LMJitResult:
    """One-call LM solve with the JAX driver's keywords. ``None``
    tolerances resolve to the reference defaults in the working dtype.
    ``pcg_rtol=None`` uses the forcing sequence :func:`forcing_rtol` (the
    inner tolerance of every step solver); ``pcg_max_iters`` bounds PCG
    steps, power terms and CGLS steps; ``pcg_warm`` starts each PCG from
    the previous camera step. ``use_cgls``, ``use_power`` and
    ``use_dense`` pick the step solver (:func:`solve_step`), in that
    order. ``facto_dtype`` (one of :data:`FACTO_DTYPES`) stores W in that
    dtype (:func:`maybe_cast_facto`).

    ``problem`` may be a mesh shard (`parallel/mesh.py:shard_problem`):
    every rank of its group calls the driver alike and gets the same
    result, its ``points`` the global (npnts, 3) array; ``points``, when
    given, is the global array too."""
    cams = problem.cams if cams is None else cams
    points = (problem.points if points is None
              else _local_points(problem, points))
    with _ranks(problem), span("ba.solve"):
        cfg = _setup(
            problem, cams, points, max_iters=max_iters, lam0=lam0,
            lam0_mode=lam0_mode, atol=atol, rtol=rtol, restol=restol,
            satol=satol, srtol=srtol, oatol=oatol, ortol=ortol, nu_d=nu_d,
            nu_m=nu_m, accept_ratio=accept_ratio, good_ratio=good_ratio,
            lam_min=lam_min, lam_strategy=lam_strategy, pcg_rtol=pcg_rtol,
            pcg_max_iters=pcg_max_iters, use_dense=use_dense,
            use_cgls=use_cgls, use_power=use_power, linesearch=linesearch,
            ls_max=ls_max, facto_dtype=facto_dtype, pcg_warm=pcg_warm)
        _check_lockstep(problem, cfg.route, cfg.solver)
        st = _lm_init(cfg, cams, points)
        _lm_run(cfg, st, max_iters)
        res = _finalize(st)
        return res._replace(points=_global_points(problem, res.points))


# The keywords (and defaults) of levenberg_marquardt_jit that the chunked
# driver passes through.
_OPTIONS = {k: p.default for k, p in inspect.signature(
    levenberg_marquardt_jit).parameters.items()
    if p.kind is p.KEYWORD_ONLY and k != "max_iters"}


def levenberg_marquardt_jit_chunked(
    problem: BAProblem, cams=None, points=None, *,
    max_iters: int = 200,
    chunk_iters: int = 25,
    max_time: Optional[float] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,          # in chunks
    resume: bool = False,
    callback: Optional[Callable] = None,
    stop_after_chunks: Optional[int] = None,
    **options,
) -> LMJitResult:
    """The LM solve of :func:`levenberg_marquardt_jit` (whose keywords
    ``options`` takes; any other raises ``TypeError``) in chunks of
    ``chunk_iters`` iterations, with host control between chunks:

    - ``max_time``: a wall-clock bound in seconds, checked before each
      chunk (status ``max_time``);
    - ``checkpoint_dir``: a ``step-<n>.npz`` checkpoint
      (`utils/checkpoint.py`, the JAX package's format) after every
      ``checkpoint_every`` chunks, with the objective and the entry-fixed
      gradient threshold ``gtol`` in its meta;
    - ``resume=True``: restore the latest checkpoint of ``checkpoint_dir``
      first: cams, points, lambda, the iteration and ``gtol``, as the JAX
      driver does (Nielsen's ``nu`` and the PCG warm start restart);
    - ``callback(dict)`` after each chunk with ``iter``, ``obj``,
      ``gnorm``, ``lam``, ``status`` and ``elapsed``;
    - ``stop_after_chunks``: return after that many chunks.

    Without these the chunks make the one-shot solve's decisions, launches
    and host reads: the chunk boundary reads nothing from the device.
    ``elapsed_time`` holds the wall seconds from entry.

    On a mesh shard (as :func:`levenberg_marquardt_jit` takes it) a rank
    past ``max_time`` stops every rank (the flag is all-reduced), rank 0
    writes the checkpoints with the global points, every rank resumes from
    them and takes its own rows, and ``callback`` runs on every rank (its
    values are replicated)."""
    unknown = sorted(set(options) - set(_OPTIONS))
    if unknown:
        raise TypeError(f"unknown options: {unknown}")
    cams = problem.cams if cams is None else cams
    points = (problem.points if points is None
              else _local_points(problem, points))
    with _ranks(problem), span("ba.solve"):
        cfg = _setup(problem, cams, points, max_iters=max_iters,
                     **{**_OPTIONS, **options})
        _check_lockstep(problem, cfg.route, cfg.solver)
        rnd = cfg.rnd

        ckpt, restored = None, None
        if checkpoint_dir is not None:
            ckpt = CheckpointManager(checkpoint_dir, every=1)
            if resume:
                restored = ckpt.restore_latest()
                if restored is not None:
                    cams = torch.as_tensor(restored["cams"],
                                           dtype=cams.dtype,
                                           device=cams.device)
                    points = _local_points(problem, torch.as_tensor(
                        restored["points"], dtype=points.dtype,
                        device=points.device))

        t0 = time.perf_counter()
        st = _lm_init(cfg, cams, points)
        if restored is not None:
            st.lam, st.it = rnd(restored["lam"]), int(restored["iteration"])
            gtol = restored["meta"].get("gtol")
            if gtol is not None:
                st.gtol = rnd(gtol)

        final_status = None
        nchunk = 0
        while st.status == RUNNING and st.it < max_iters:
            if max_time is not None and _any_rank(
                    time.perf_counter() - t0 > max_time, cams.device):
                final_status = MAX_TIME
                break
            _lm_run(cfg, st, min(st.it + chunk_iters, max_iters))
            nchunk += 1
            if ckpt is not None and nchunk % max(1, checkpoint_every) == 0:
                pts = _global_points(problem, st.points)
                if _rank0(problem):
                    ckpt.maybe_save(st.it, st.cams, pts, lam=float(st.lam),
                                    meta={"objective": float(st.obj),
                                          "gtol": float(st.gtol),
                                          "problem": _whole(problem).name})
            if callback is not None:
                callback({"iter": st.it, "obj": float(st.obj),
                          "gnorm": float(st.gnorm), "lam": float(st.lam),
                          "status": STATUS_NAMES[st.status],
                          "elapsed": time.perf_counter() - t0})
            if stop_after_chunks is not None and nchunk >= stop_after_chunks:
                break
        res = _finalize(st, final_status, elapsed=time.perf_counter() - t0)
        return res._replace(points=_global_points(problem, res.points))
