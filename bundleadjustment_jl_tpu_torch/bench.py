"""The card tools' shared pieces: the problems they build, the solve they
time, and the least time of each kernel form on an H100.

``chip_smoke.py``, ``mv_sweep.py``, ``tile_sweep.py``,
``kernel_profile.py``, ``route_profile.py``, ``capacity.py``,
``spmd_profile.py`` and the tests read them. The port's benchmark is
``perfbench/run.py``; nothing here is its yardstick.

The problems (:data:`PROBLEMS`, :func:`make_problem`, :func:`shape`) are
synthetic LadyBug-49, Dubrovnik-356 and Final-4585 in float32, padded to
512 rows; :data:`SOLVE_OPTS` (:func:`solve_cfg`) are root ``bench.py``'s
solver keywords, and :func:`timed_solve` times one solve by the host
clock between two ``torch.cuda.synchronize()`` calls. :func:`kernel_bytes` and
:func:`bound_ms` give, from shapes, the least bytes and the least time of
one launch of each kernel form. :func:`require_card` raises where no card
is; :func:`card` names the card and its power limit.
"""

from __future__ import annotations

import subprocess
import time
import types

import torch

MAX_ITERS = 100

# NVIDIA H100 SXM, data sheet: HBM3 rate and float32 (non-tensor) peak, at
# the full 700 W power limit.
PEAK_HBM_GBS = 3350.0
PEAK_F32_TFLOPS = 67.0

# root bench.py's problems (benchmark/problems.py:BAL_SIZES), synthetic;
# and Final-4585, where routes B1 and B2 run: the BAL Final problem
# problem-4585-1324582-9125125 (grail.cs.washington.edu, "Final") at its
# sizes, obs_per_pnt = round(9125125 / 1324582).
PROBLEMS = {
    "ladybug49": dict(ncams=49, npnts=7776, obs_per_pnt=4),
    "dubrovnik356": dict(ncams=356, npnts=226730, obs_per_pnt=6),
    "final4585": dict(ncams=4585, npnts=1324582, obs_per_pnt=7),
}

SOLVE_OPTS = dict(max_iters=MAX_ITERS, pcg_max_iters=100, lam0_mode="diag",
                  satol=0.0, srtol=0.0, atol=0.0, rtol=1e-5, oatol=0.0,
                  ortol=1e-4)

# Arithmetic of one row of each kernel form, from its source (an FMA
# counts 2): the linearization chain ~300 operations, the forward
# projection ~60, W = Jc' Jp 81, a 9x3 block times a vector 54, W C W' with
# its symmetric half 405, [Jc'Jc | Jc'r] 216, [Jp'Jp | Jp'r] 36. Jc and r
# alone, counted from csrc/chain.cuh's ba_linearize for the terms that
# depend on the row (the large-angle branch; R(r) and the camera-only
# factors once a camera): k x X and k.X 14, RX 16, d(RX)/dr 133, the
# divide 6, distortion and B 23, Jc 67, r 6.
_CHAIN, _PROJECT, _CHAIN_JC_R = 300, 60, 265
FLOPS_PER_ROW = {
    "assemble": 2 * _CHAIN + 81 + 36 + 216, "linearize": _CHAIN + 81,
    "linearize_w_only": _CHAIN + 81, "objective": _PROJECT,
    "cam_reduce": 405 + 54, "cam_reduce_w_op": 54, "cam_reduce_wcw81": 405,
    "cam_reduce_cam90": 216, "matvec": 2 * 54, "seg_prod_pnt12": 36,
    "seg_prod_cam90": 216, "seg_prod_wcw81": 405, "seg_block_point": 54,
    "seg_block_camera": 54, "cam_relin_cam90": _CHAIN_JC_R + 216,
    "cam_relin_wcw_rhs": _CHAIN + 81 + 405 + 54,
}
# The point-block forms' arithmetic a point: the damped adjugate inverse
# (3 damped diagonals, 18 products and 9 differences, the determinant's 5,
# 9 scalings) and a 3x3 block times a vector (15); dp' Hpp dp 15 + 6.
FLOPS_PER_POINT = {"point_inv": 44 + 15, "point_quad": 21}
# The dense step's pair kernel: Y = W Hpp_inv once a row (9x3 times 3x3),
# Y_i W_j' once a pair of rows of one point (9x3 times 3x9).
FLOPS_PER_PAIR_ROW, FLOPS_PER_PAIR = 162, 486


def pair_count(problem) -> int:
    """The pairs of rows ``(k, l)``, ``k <= l``, of one point that the
    dense step's S sums, with ``problem.nobs_pad`` rows spread as evenly
    over its points as they go (as `synthetic_bal` and the capacity
    recipe spread them)."""
    k, extra = divmod(problem.nobs_pad, problem.npnts)
    return ((problem.npnts - extra) * k * (k + 1) // 2
            + extra * (k + 1) * (k + 2) // 2)


def shape(name: str):
    """The sizes of problem ``name`` that the bounds read: ``nobs_pad``
    (its rows, padded to 512 as :func:`make_problem` pads them), ``ncams``,
    ``npnts``."""
    spec = PROBLEMS[name]
    rows = spec["npnts"] * min(spec["obs_per_pnt"], spec["ncams"])
    return types.SimpleNamespace(nobs_pad=-(-rows // 512) * 512,
                                 ncams=spec["ncams"], npnts=spec["npnts"])


def kernel_bytes(name: str, problem, w_itemsize: int = 4, *,
                 nsmall: int = 0, scales: int = 1) -> int:
    """The least bytes one launch of kernel form ``name`` (an
    ``ops/_cuda.py:LAUNCHES`` key) moves on ``problem``: each input it
    needs read once, each output written once, W at ``w_itemsize`` bytes a
    value; scratch and re-reads are not counted. ``stream_probe`` reads
    (32 + ``nsmall``) rows of ``problem.nobs_pad``; ``objective`` evaluates
    ``scales`` trial states (1: a solve without a line search; 1 +
    ``ls_max`` with one): the rows once, each state and output once."""
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    f = i = 4
    idx = i * n                                   # one (n,) index array
    W = 27 * n * w_itemsize
    rows = 3 * n * f + 2 * idx                    # pt2d, w, cam_idx, pnt_idx
    state = (9 * nc + 3 * npt) * f                # cams, points
    pnt_starts, cam_starts = (npt + 1) * i, (nc + 1) * i
    hpp_inv, vec_p, vec_c = 9 * npt * f, 3 * npt * f, 9 * nc * f
    table = {
        "assemble": state + rows + idx + pnt_starts + cam_starts + W
        + 12 * npt * f + 90 * nc * f + f,
        "linearize": state + rows + 26 * n * f + W,
        "linearize_w_only": state + rows + idx + W,
        "objective": scales * (state + f) + rows,
        "cam_reduce": W + 2 * idx + cam_starts + hpp_inv + vec_p
        + 90 * nc * f,
        "cam_reduce_w_op": W + 2 * idx + cam_starts + vec_p + vec_c,
        "cam_reduce_wcw81": W + 2 * idx + cam_starts + hpp_inv + 81 * nc * f,
        "cam_reduce_cam90": 20 * n * f + idx + cam_starts + 90 * nc * f,
        # the camera-order pt2d, w and point ids, the state once
        "cam_relin_cam90": state + 3 * n * f + idx + cam_starts
        + 90 * nc * f,
        # the same, with Hpp_inv and t once
        "cam_relin_wcw_rhs": state + 3 * n * f + idx + cam_starts + hpp_inv
        + vec_p + 90 * nc * f,
        "matvec": W + 3 * idx + pnt_starts + cam_starts + vec_c + hpp_inv
        + vec_c,
        "seg_prod_pnt12": 8 * n * f + pnt_starts + 12 * npt * f,
        "seg_prod_cam90": 20 * n * f + cam_starts + 90 * nc * f,
        "seg_prod_wcw81": W + 2 * idx + cam_starts + hpp_inv + 81 * nc * f,
        "seg_block_point": W + vec_c + idx + pnt_starts + hpp_inv + vec_p,
        "seg_block_camera": W + vec_p + 2 * idx + cam_starts + vec_c,
        "stream_probe": (32 + nsmall) * n * f + 32 * f,
        "point_inv": 2 * (hpp_inv + vec_p),
        "point_quad": hpp_inv + vec_p + f,
        # W, Hpp_inv, the plan (two row ids a pair, a 12-byte chunk a block
        # of S's lower triangle) and S written once
        "dense_pairs": W + hpp_inv + 8 * pair_count(problem)
        + 12 * (nc * (nc + 1) // 2) + f * (9 * nc) ** 2,
    }
    return table[name]


def kernel_flops(name: str, problem, *, nsmall: int = 0,
                 scales: int = 1) -> int:
    """Floating-point operations of one launch of ``name`` on ``problem``
    (:data:`FLOPS_PER_ROW` a row, a row and scale for ``objective``; one
    add a value for the probe; :data:`FLOPS_PER_POINT` a point)."""
    n = problem.nobs_pad
    if name == "stream_probe":
        return (32 + nsmall) * n
    if name in FLOPS_PER_POINT:
        return FLOPS_PER_POINT[name] * problem.npnts
    if name == "dense_pairs":
        return FLOPS_PER_PAIR_ROW * n + FLOPS_PER_PAIR * pair_count(problem)
    return FLOPS_PER_ROW[name] * n * (scales if name == "objective" else 1)


def bound_ms(name: str, problem, w_itemsize: int = 4, **kw):
    """``(ms, "bytes" | "operations")``: the least time one launch of
    ``name`` could take on an H100, the larger of its bytes over
    :data:`PEAK_HBM_GBS` and its operations over :data:`PEAK_F32_TFLOPS`."""
    t_bytes = kernel_bytes(name, problem, w_itemsize, **kw) / (
        PEAK_HBM_GBS * 1e9) * 1e3
    t_ops = kernel_flops(name, problem, **kw) / (PEAK_F32_TFLOPS * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs a CUDA card; "
                           "torch.cuda.is_available() is false")


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, _, limit = out.rpartition(", ")
    return {"name": name, "power_limit": limit, "nvidia_smi": out}


def make_problem(name: str, seed: int):
    """Synthetic problem ``name`` of :data:`PROBLEMS` on the card (f32,
    unit pixel noise, ``pad_obs_to=512``), made from ``seed``."""
    from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
    return synthetic_bal(**PROBLEMS[name], noise_px=1.0, perturb=2e-2,
                         seed=seed, dtype=torch.float32, pad_obs_to=512,
                         device="cuda")[0]


def solve_cfg(problem, facto_dtype=None):
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
        levenberg_marquardt_jit)
    return levenberg_marquardt_jit(problem, facto_dtype=facto_dtype,
                                   **SOLVE_OPTS)


def timed_solve(problem, facto_dtype=None):
    """``(s, result)`` of one :func:`solve_cfg` solve, timed by the host
    clock between two ``torch.cuda.synchronize()`` calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_cfg(problem, facto_dtype)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res
