"""Block form of the damped Gauss-Newton system (PyTorch port of the
parts of `bundleadjustment_jl_tpu/ops/normal.py` the kernel routes use).

    H = [[Hcc, Hcp], [Hcp', Hpp]],  Hcc: 9x9 camera blocks,
    Hpp: 3x3 point blocks, Hcp: one 9x3 block W_k per observation.

Damping is Levenberg's ``lambda I``.

A solve may run in a 2-byte working dtype (bfloat16 or float16, the low
stages of `benchmark/precision.py:precision_cascade`). The kernels take
float32 vectors, as the JAX package's Pallas kernels do: the solve's stage
table (:func:`solve_stages`) widens each stage's vector operands to float32
and rounds its results back to the working dtype, and W is written in the
working dtype (its ``out_dtype = w_dtype or dt``). Their plain twins get
the same operands, so on the card both make the same decisions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from bundleadjustment_jl_tpu_torch.models.problem import (
    HALF_DTYPES, BAProblem, torch_dtype)
from bundleadjustment_jl_tpu_torch.ops import dense_schur as ds
from bundleadjustment_jl_tpu_torch.ops import fused_assemble as fa
from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
from bundleadjustment_jl_tpu_torch.ops import linearize as lz
from bundleadjustment_jl_tpu_torch.ops import point_block as pb
from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
from bundleadjustment_jl_tpu_torch.ops import spmdctx
from bundleadjustment_jl_tpu_torch.ops.point_block import inv3x3_damped_flat

# The kernel routes (`kernel_route` below picks one per solve):
#   "fused"         A: K1 assembly; K2 + K3 read W through cam_perm.
#   "sorted"        C: K7, K6 over a camera-sorted copy of JR, W_cam_t a
#                   camera-sorted copy of W; K6 / K5 downstream.
#   "scatter_split" B1: K7, [Hcc | g_c] by K2's cam90 re-derived in camera
#                   order (K7's chain a camera); no camera-sorted copy
#                   (W_cam_t None); K2 / K5 downstream, W C W' | W t
#                   re-derived in camera order too.
#   "sorted_relin"  B2: B1's assembly plus W_cam_t re-linearized in the
#                   camera order (K8); K6 / K5 downstream, as on C.
ROUTES = ("fused", "sorted", "scatter_split", "sorted_relin")

# `kernel_route` reads the switch and the gates below once per call of
# `solver/lm_jit.py:levenberg_marquardt_jit` (one solve never mixes
# routes), as the JAX package's `_assemble_kminor` and `ops/schur.py` read
# theirs; `ops/schur.py` reads GATHER_TABLE_MAX_CAMS too. The trial
# objectives run on K4 on every route.
#
# CAM_SCATTER is the JAX package's `pallas_schur.CAM_SCATTER` and the CLI's
# `--cam-scatter`: camera sums over the point-sorted rows (routes A, B1)
# rather than over camera-sorted copies (C, B2). The JAX default is off
# (env BA_CAM_SCATTER); the fused route is the configuration bench.py
# measures, so the port's default is on.
CAM_SCATTER = True

# The JAX package's three size gates (`ops/pallas_schur.py`), with its
# values. Each value was chosen on a TPU (VMEM tables, tile padding);
# whether it picks the faster route on the H100 is recorded in PERF.md.
#
# GATHER_TABLE_MAX_CAMS: the largest camera count whose camera vector the
# TPU's fused kernels (K1, K3) hold as a VMEM table. Above it the camera
# scatter splits: K7 + K2 assembly and the two-pass matvec (route B1).
GATHER_TABLE_MAX_CAMS = 2048
# CAM_SCATTER_MAX_CAMS: the TPU camera scatter's one-hot work grows with the
# camera count; above this count camera scatter is off whatever CAM_SCATTER
# says.
CAM_SCATTER_MAX_CAMS = 16384
# GATHER_DIRECT_MAX_BYTES: the huge-n test, nobs_pad * 512 B (one row
# tile-padded to 128 f32 lanes on the TPU) above this many bytes. There,
# with camera scatter off, the JAX package builds no camera-sorted JR copy
# (K2 sums [Hcc | g_c]) and re-linearizes W in the camera order (K8) in
# place of permuting it (route B2).
GATHER_DIRECT_MAX_BYTES = 4 << 30


class Stages(NamedTuple):
    """The callables a solve's stages call, one field per kernel wrapper and
    named after it: :data:`KERNELS` (the wrappers) or :data:`PLAIN` (their
    plain twins, same signatures; for ``dense_schur`` the JAX package's
    two-target S, where the wrapper's own twin sums the pairs on the CPU).
    :func:`solve_stages` picks the table once per solve; `GNBlocks` and
    `ops/schur.py:SchurSystem` carry it."""
    assemble_scatter: Callable      # K1
    linearize_w_kminor: Callable    # K7
    jtj_pnt_reduce: Callable        # K6 pnt12
    jtj_cam_reduce: Callable        # K6 cam90
    cam_relin_cam90: Callable       # K2 cam90, re-derived in camera order
    linearize_w_only: Callable      # K8
    cam_reduce_wcw_rhs: Callable    # K2 W C W' | W t
    cam_relin_wcw_rhs: Callable     # the same, re-derived in camera order
    matvec_cam_scatter: Callable    # K3
    cam_reduce_w_op: Callable       # K2 W op
    cam_reduce_wcw: Callable        # K2 W C W'
    wcw_cam_reduce: Callable        # K6 wcw81
    wtv_point_reduce: Callable      # K5 point direction
    wt_cam_reduce: Callable         # K5 camera direction
    objective_scatter: Callable     # K4
    point_inv_rhs: Callable         # point blocks: Hpp_inv, Hpp_inv g_p
    point_quad: Callable            # point blocks: dp' Hpp dp
    dense_schur: Callable           # the dense step's S (pair kernel)


KERNELS = Stages(
    fa.assemble_scatter, lz.linearize_w_kminor, sr.jtj_pnt_reduce,
    sr.jtj_cam_reduce, fs.cam_relin_cam90, lz.linearize_w_only,
    fs.cam_reduce_wcw_rhs, fs.cam_relin_wcw_rhs, fs.matvec_cam_scatter,
    fs.cam_reduce_w_op, fs.cam_reduce_wcw, sr.wcw_cam_reduce,
    sr.wtv_point_reduce, sr.wt_cam_reduce, fa.objective_scatter,
    pb.point_inv_rhs, pb.point_quad, ds.dense_schur)
PLAIN = Stages(
    fa._assemble_plain, lz._linearize_plain, sr._jtj_pnt_plain,
    sr._jtj_cam_plain, fs._cam_relin_cam90_plain, lz._linearize_w_only_plain,
    fs._cam_reduce_wcw_rhs_plain, fs._cam_relin_wcw_rhs_plain,
    fs._matvec_cam_scatter_plain, fs._cam_reduce_w_op_plain,
    fs._cam_reduce_wcw_plain, sr._wcw_cam_plain, sr._wtv_point_plain,
    sr._wt_cam_plain, fa._objective_plain, pb._point_inv_rhs_plain,
    pb._point_quad_plain, ds._dense_schur_plain)

# PALLAS_MODE is the JAX package's `pallas_schur.PALLAS_MODE`: the kernels
# on (default here, as bench.py measures) or the plain route everywhere.
PALLAS_MODE = True

# The outputs (by position) that a 2-byte working dtype's table hands on
# unrounded: W in its storage dtype, K7's float32 JR, which the next
# stages read, and the dense step's float32 S, which `ops/schur.py` rounds
# to W's storage dtype.
_UNROUNDED = {"assemble_scatter": (0,), "linearize_w_kminor": (0, 1),
              "linearize_w_only": (0,), "dense_schur": (0,)}


def _widen(x):
    if isinstance(x, torch.Tensor) and x.dim() and x.dtype in HALF_DTYPES:
        return x.float()
    return x


def _half_stage(fn: Callable, dt: torch.dtype, keep: tuple) -> Callable:
    """``fn`` as a solve in the 2-byte working dtype ``dt`` calls it:
    every tensor operand but the first (W, JR, Hpp or none) and but a 0-d
    one (a float16 W's range scale, applied in its own dtype) widened to
    float32, and every result but those at the positions ``keep`` rounded
    to ``dt``, as the JAX package casts around its kernels."""
    def stage(first, *args, **kwargs):
        out = fn(first, *map(_widen, args),
                 **{k: _widen(v) for k, v in kwargs.items()})
        if isinstance(out, torch.Tensor):
            return out if keep else out.to(dt)
        return tuple(o if i in keep else o.to(dt) for i, o in enumerate(out))
    stage.__name__ = getattr(fn, "__name__", "stage")
    return stage


class _HalfStages(Stages):
    """A table whose stages :func:`_half_stage` wrapped."""
    __slots__ = ()


# The outputs (by position) of each stage that are sums over rows into
# camera space, or into a scalar: in a multi-process solve
# (`ops/spmdctx.py`) they are per-rank partials, which the spmd table
# all-reduces. The other outputs (W, JR, the point sums) stay local.
_ROW_SUMS = {"assemble_scatter": (2, 3), "jtj_cam_reduce": (0,),
             "cam_relin_cam90": (0,), "cam_reduce_wcw_rhs": (0,),
             "cam_relin_wcw_rhs": (0,),
             "matvec_cam_scatter": (0,), "cam_reduce_w_op": (0,),
             "cam_reduce_wcw": (0,), "wcw_cam_reduce": (0,),
             "wt_cam_reduce": (0,), "objective_scatter": (0,)}


def _spmd_stage(fn: Callable, sums: tuple) -> Callable:
    """``fn`` with the outputs at the positions ``sums`` (a lone tensor is
    position 0) all-reduced by `spmdctx.psum`; ``fn`` itself when ``sums``
    is empty."""
    if not sums:
        return fn

    def stage(*args, **kwargs):
        out = fn(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            return spmdctx.psum(out)
        return tuple(spmdctx.psum(o) if i in sums else o
                     for i, o in enumerate(out))
    stage.__name__ = getattr(fn, "__name__", "stage")
    return stage


class _SpmdStages(Stages):
    """A table whose stages :func:`_spmd_stage` wrapped."""
    __slots__ = ()


# Camera-group shards (`spmdctx.CAMERA_GROUPS`): a point's rows span ranks,
# so the point-space outputs are per-rank partials too, all-reduced like
# the camera sums.
_POINT_SUMS = {"assemble_scatter": (1,), "jtj_pnt_reduce": (0,)}


def _wtv_point_groups(W_t, v, problem, hpp_inv_f=None, add_f=None,
                      sign=1.0):
    """K5's point direction on camera groups: the per-point sums
    all-reduced before the add and the fold, which every rank then applies
    alike (its plain twin, otherwise)."""
    return sr.fold_point(spmdctx.psum(sr.wtv_point_sum(W_t, v, problem)),
                         hpp_inv_f, add_f, sign)


def _matvec_groups(W_t, v, problem, hpp_inv_f, gp_f=None, sign=1.0,
                   with_dp=False):
    """K3 on camera groups: the point pass all-reduced before the camera
    pass reads it (the camera sums are all-reduced by the table)."""
    t = _wtv_point_groups(W_t, v, problem, hpp_inv_f, gp_f, sign)
    out = fs._cam_reduce_w_op_plain(W_t, problem, t)
    return (out, t) if with_dp else out


# The plain twins as camera-group shards run them: the two point passes
# whose sums something reads before they leave the stage take the
# all-reduce inside.
GROUPS = PLAIN._replace(wtv_point_reduce=_wtv_point_groups,
                        matvec_cam_scatter=_matvec_groups)


class _HalfSpmdStages(_HalfStages, _SpmdStages):
    """A table of both wrappings: the all-reduce inside, on the float32
    outputs, and the 2-byte rounding outside."""
    __slots__ = ()


def stages_for(table: Stages, dtype) -> Stages:
    """``table`` as a solve in working dtype ``dtype`` calls it: in a
    multi-process solve (`spmdctx.GROUP` set) each stage that sums rows
    into camera space all-reduces its float32 outputs (:data:`_ROW_SUMS`,
    the hooks of the JAX package at the same stages); on camera-group
    shards (`spmdctx.CAMERA_GROUPS`, the plain route only) the point sums
    too (:data:`_POINT_SUMS`, and :data:`GROUPS` for the two point passes
    read inside their stage); then for a 2-byte dtype each stage through
    :func:`_half_stage`. Each wrapping is made once: a table that has it
    is taken as it is."""
    dt = torch_dtype(dtype)
    if spmdctx.GROUP is not None and not isinstance(table, _SpmdStages):
        if isinstance(table, _HalfStages):
            raise ValueError("a 2-byte stage table made outside the "
                             "multi-process solve: it has no all-reduce "
                             "on its float32 outputs")
        sums = _ROW_SUMS
        if spmdctx.CAMERA_GROUPS:
            if table is not PLAIN:
                raise ValueError("camera-group shards solve on the plain "
                                 "route (solve_stages): the kernels need "
                                 "point-sorted rows")
            table = GROUPS
            sums = {k: _ROW_SUMS.get(k, ()) + _POINT_SUMS.get(k, ())
                    for k in Stages._fields}
        table = _SpmdStages(*(_spmd_stage(f, sums.get(name, ()))
                              for name, f in zip(Stages._fields, table)))
    if dt not in HALF_DTYPES or isinstance(table, _HalfStages):
        return table
    cls = _HalfSpmdStages if isinstance(table, _SpmdStages) else _HalfStages
    return cls(*(_half_stage(f, dt, _UNROUNDED.get(name, ()))
                 for name, f in zip(Stages._fields, table)))


def plain_route(dtype, problem: BAProblem | None = None) -> bool:
    """Whether a solve in working dtype ``dtype`` of ``problem`` takes the
    plain route (:func:`solve_stages`): float64, :data:`PALLAS_MODE` off,
    or a problem whose rows are not point-sorted (``pnt_perm``)."""
    return (not PALLAS_MODE or torch_dtype(dtype) == torch.float64
            or (problem is not None and problem.pnt_perm is not None))


def solve_stages(dtype, problem: BAProblem | None = None) -> Stages:
    """The stage table of a solve of ``problem`` in working dtype
    ``dtype``, read once per solve by the drivers (`solver/lm_jit.py`,
    `solver/lm.py`): :data:`PLAIN` where :func:`plain_route` says so, else
    :data:`KERNELS`; for a 2-byte dtype or a multi-process solve through
    :func:`stages_for`.

    The kernels accumulate in float32 and have no float64 form; the JAX
    package keeps its XLA path for float64 (`pallas_schur.problem_ok`), and
    the plain route is that path, run on whatever device the tensors are on.
    No kernel wrapper is reached there, so a wrapper's refusal of CUDA
    float64 stands. The same holds for a problem with ``pnt_perm`` (the
    camera groups of `parallel/partition.py`), in every dtype: its rows are
    not point-sorted, which every kernel's plan needs (`ops/plans.py`
    refuses it), and the JAX package's `layout_ok` / `cam_scatter_ok`
    send it to XLA alike. Like float64, this is a route, not a fallback.
    `problem_ok`'s padding test does not carry over: the port's kernels
    take any padding (``nobs_pad % 128`` is a TPU lane rule), so a
    point-sorted float32 solve on the card runs the kernels or raises. The
    plain twins' segment sums are ``index_add_``, atomics on CUDA: an f64
    solve on the card makes the CPU f64 solve's decisions (status,
    iterations) with its objective within rel 1e-9, not bit for bit. In a
    multi-process solve the table carries the all-reduces of
    :func:`stages_for`."""
    return stages_for(PLAIN if plain_route(dtype, problem) else KERNELS,
                      dtype)


def kernel_route(problem: BAProblem) -> str:
    """The kernel route the JAX package takes for ``problem`` under the
    switch and gates above (`normal.py:_assemble_kminor`,
    `pallas_schur.cam_scatter_ok`)."""
    if CAM_SCATTER and problem.ncams <= CAM_SCATTER_MAX_CAMS:
        return ("fused" if problem.ncams <= GATHER_TABLE_MAX_CAMS
                else "scatter_split")
    huge = problem.nobs_pad * 128 * 4 > GATHER_DIRECT_MAX_BYTES
    return "sorted_relin" if huge else "sorted"


# Settings of the switch and gates above (attributes of this module) that
# make `kernel_route` pick each route at any problem size (the JAX package's
# `pallas_schur` takes the same attributes to the same route).
FORCE_ROUTE = {
    "fused": dict(CAM_SCATTER=True, GATHER_TABLE_MAX_CAMS=1 << 62,
                  CAM_SCATTER_MAX_CAMS=1 << 62),
    "scatter_split": dict(CAM_SCATTER=True, GATHER_TABLE_MAX_CAMS=0,
                          CAM_SCATTER_MAX_CAMS=1 << 62),
    "sorted": dict(CAM_SCATTER=False, GATHER_DIRECT_MAX_BYTES=1 << 62),
    "sorted_relin": dict(CAM_SCATTER=False, GATHER_DIRECT_MAX_BYTES=0),
}


class GNBlocks(NamedTuple):
    """The linearization's reduced blocks (flat storage, as in JAX)."""
    g_c_f: torch.Tensor   # (ncams*9,)   J_c' r
    g_p_f: torch.Tensor   # (npnts*3,)   J_p' r
    Hcc_f: torch.Tensor   # (ncams*81,)  camera diagonal blocks
    Hpp_f: torch.Tensor   # (npnts*9,)   point diagonal blocks
    obj: torch.Tensor     # ()           0.5 ||r||^2
    W_t: torch.Tensor     # (27, nobs_pad) per-observation W blocks
    # (27, nobs_pad) W_t[:, cam_perm] on routes C and B2; None on routes A
    # and B1, whose kernels read W_t through cam_perm.
    W_cam_t: torch.Tensor | None = None
    # The kernel route that assembled the blocks (one of ROUTES), on which
    # `ops/schur.py` dispatches.
    route: str = "fused"
    # Range scale of a float16-stored W (`facto_dtype`, the JAX package's
    # `GNBlocks.w_scale`): W_t and W_cam_t hold ``s * W`` with ``s`` a power
    # of two (a 0-d tensor on the device) that puts max|W| near 2^14;
    # `ops/schur.py` hats Hpp_inv by 1/s^2 and g_p by s and unscales dp.
    # None = 1 (float32 or bfloat16 storage).
    w_scale: torch.Tensor | None = None
    # The stage table of the solve (`solve_stages`), through which
    # `ops/schur.py` calls its kernels or their plain twins.
    stages: Stages = KERNELS
    # (26, nobs_pad) K7's Jc | Jp | r (`ops/linearize.py`), kept only when
    # assembled ``with_jr`` (the CGLS solver, `ops/cgls.py`); else None.
    JR_t: torch.Tensor | None = None
    # The state linearized, (ncams, 9) and (npnts, 3) in the working dtype
    # (set by `assemble_blocks`; the solve holds them anyway): route B1's
    # W C W' | W t re-derives W from them (`ops/schur.py:reduce_and_diag`).
    # None: the blocks were built otherwise, and that sum reads W_t.
    cams: torch.Tensor | None = None
    points: torch.Tensor | None = None

    @property
    def g_c(self):
        return self.g_c_f.reshape(-1, 9)

    @property
    def g_p(self):
        return self.g_p_f.reshape(-1, 3)

    @property
    def Hcc(self):
        return self.Hcc_f.reshape(-1, 9, 9)


def assemble_blocks(problem: BAProblem, cams=None, points=None, *,
                    route: str = "fused",
                    w_dtype: torch.dtype | None = None,
                    stages: Stages | None = None,
                    with_jr: bool = False) -> GNBlocks:
    """Linearize at (cams, points) and assemble the blocks on ``route``
    (one of :data:`ROUTES`), as `_assemble_kminor` of the JAX package does,
    W written in ``w_dtype`` (default: the working dtype; bfloat16 with
    ``facto_dtype=bfloat16``, as `_w_assemble_dtype` of the JAX solver
    gives it; float16 is never written raw, see
    `solver/lm_jit.py:maybe_cast_facto`), each step below called through
    ``stages`` (default :data:`KERNELS`; :func:`solve_stages`):

    - ``"fused"``: one K1 launch;
    - the others: K7 linearizes into ``JR_t`` and ``W_t`` and K6 sums
      ``[Hpp | g_p]`` over the point-sorted rows. ``"sorted"``: K6 sums
      ``[Hcc | g_c]`` over the camera-sorted copy of ``JR_t`` and the
      blocks carry ``W_cam_t = W_t[:, cam_perm]`` (taken in the storage
      dtype). ``"scatter_split"``: ``cam_relin_cam90`` sums ``[Hcc | g_c]``
      from the rows' inputs in camera order, before K7 (its plan is built
      while no JR or W is held), and there is no ``W_cam_t``.
      ``"sorted_relin"``: the same, plus ``W_cam_t`` from K8.

    ``with_jr`` keeps K7's ``JR_t`` in the blocks (the CGLS solver's J and
    r). K1 writes no JR, so on ``"fused"`` it assembles as
    ``"scatter_split"`` and the blocks carry that route.

    In a 2-byte working dtype W is written in the working dtype when
    ``w_dtype`` is None; the table (:func:`stages_for`) widens the stages'
    operands, and the sums, the objective and ``JR_t`` come back rounded
    to it.
    """
    if route not in ROUTES:
        raise ValueError(f"unknown kernel route {route!r}; one of {ROUTES}")
    if with_jr and route == "fused":
        route = "scatter_split"
    cams = problem.cams if cams is None else cams
    points = problem.points if points is None else points
    dt = cams.dtype
    st = stages_for(KERNELS if stages is None else stages, dt)
    if dt in HALF_DTYPES:
        w_dtype = w_dtype or dt
    if route == "fused":
        W_t, hp12, hc90, obj = st.assemble_scatter(problem, cams, points,
                                                   w_dtype)
        W_cam_t = None
    else:
        if route != "sorted":
            hc90 = st.cam_relin_cam90(problem, cams, points)
        JR_t, W_t = st.linearize_w_kminor(problem, cams, points, w_dtype)
        obj = spmdctx.psum(0.5 * torch.sum(JR_t[lz.R0:lz.R0 + 2] ** 2))
        if route == "sorted":
            perm = problem.cam_perm.long()
            hc90 = st.jtj_cam_reduce(JR_t[:, perm], problem)
            W_cam_t = W_t[:, perm]
        else:
            W_cam_t = (st.linearize_w_only(problem, cams, points, w_dtype)
                       if route == "sorted_relin" else None)
        hp12 = st.jtj_pnt_reduce(JR_t, problem)
    return GNBlocks(g_c_f=hc90[:, 81:90].reshape(-1),
                    g_p_f=hp12[:, 9:12].reshape(-1),
                    Hcc_f=hc90[:, :81].reshape(-1),
                    Hpp_f=hp12[:, :9].reshape(-1),
                    obj=obj.to(dt), W_t=W_t, W_cam_t=W_cam_t, route=route,
                    stages=st, JR_t=JR_t.to(dt) if with_jr else None,
                    cams=cams, points=points)


def gradient_norm(blocks: GNBlocks) -> torch.Tensor:
    """||J'r|| over the full variable vector; in a multi-process solve
    only the point part is summed over the ranks' points
    (`spmdctx.psum_points`)."""
    return torch.sqrt(torch.sum(blocks.g_c_f ** 2)
                      + spmdctx.psum_points(torch.sum(blocks.g_p_f ** 2)))


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Adjugate inverse of 3x3 blocks ``M`` (..., 3, 3), with the fallback
    of :func:`inv3x3_damped_flat` (undamped) where a block's determinant
    is not finite or not above ``8 tiny``."""
    return inv3x3_damped_flat(M.reshape(-1), 0.0).reshape(M.shape)


def damp(H: torch.Tensor, lam) -> torch.Tensor:
    """Add ``lam I`` to a batch of square blocks."""
    n = H.shape[-1]
    return H + lam * torch.eye(n, dtype=H.dtype, device=H.device)
