"""The benchmark's yardstick: the card's peaks, the least bytes and
operations of each stage of a solve, counted from the problem's shapes,
and a solve's least device time from its decisions.

A frozen copy of the port's first counts (``bench.py``'s
``FLOPS_PER_ROW``, ``kernel_bytes`` and ``bound_ms``), kept here so that no
change to the program moves the yardstick. Each input a stage needs is
read once and each output written once, W at the configuration's storage
width; scratch and re-reads are not counted.
"""

from __future__ import annotations

import types

# NVIDIA H100 SXM, data sheet: HBM3 rate and float32 rate outside the
# tensor cores, at the full 700 W power limit.
PEAK_HBM_BYTES_S = 3.35e12
PEAK_F32_FLOPS_S = 67e12

# Arithmetic of one row of each stage (an FMA counts 2): the linearization
# chain ~300 operations, the forward projection ~60, W = Jc' Jp 81, a 9x3
# block times a vector 54, W C W' with its symmetric half 405,
# [Jc'Jc | Jc'r] 216, [Jp'Jp | Jp'r] 36.
_CHAIN, _PROJECT = 300, 60
FLOPS_PER_ROW = {
    "assemble": 2 * _CHAIN + 81 + 36 + 216, "linearize": _CHAIN + 81,
    "linearize_w_only": _CHAIN + 81, "objective": _PROJECT,
    "cam_reduce": 405 + 54, "cam_reduce_w_op": 54, "cam_reduce_wcw81": 405,
    "cam_reduce_cam90": 216, "matvec": 2 * 54, "seg_prod_pnt12": 36,
    "seg_prod_cam90": 216, "seg_prod_wcw81": 405, "seg_block_point": 54,
    "seg_block_camera": 54,
}


def shape(cfg: dict) -> types.SimpleNamespace:
    """The sizes the counts read, from a configuration: ``nobs_pad`` (its
    ``nobs`` rows padded to ``pad_obs_to``), ``ncams``, ``npnts``."""
    nc, npt, rows = int(cfg["ncams"]), int(cfg["npnts"]), int(cfg["nobs"])
    pad = int(cfg["pad_obs_to"])
    return types.SimpleNamespace(nobs_pad=-(-rows // pad) * pad, ncams=nc,
                                 npnts=npt)


def stage_bytes(name: str, shp, w_itemsize: int = 4, *,
                scales: int = 1) -> int:
    """The least bytes of one pass of stage ``name`` on sizes ``shp``;
    ``objective`` evaluates ``scales`` trial states."""
    n, nc, npt = shp.nobs_pad, shp.ncams, shp.npnts
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
        "matvec": W + 3 * idx + pnt_starts + cam_starts + vec_c + hpp_inv
        + vec_c,
        "seg_prod_pnt12": 8 * n * f + pnt_starts + 12 * npt * f,
        "seg_prod_cam90": 20 * n * f + cam_starts + 90 * nc * f,
        "seg_prod_wcw81": W + 2 * idx + cam_starts + hpp_inv + 81 * nc * f,
        "seg_block_point": W + vec_c + idx + pnt_starts + hpp_inv + vec_p,
        "seg_block_camera": W + vec_p + 2 * idx + cam_starts + vec_c,
    }
    return table[name]


def stage_flops(name: str, shp, *, scales: int = 1) -> int:
    """Floating-point operations of one pass of stage ``name``."""
    return FLOPS_PER_ROW[name] * shp.nobs_pad * (
        scales if name == "objective" else 1)


def least_s(name: str, shp, w_itemsize: int = 4, **kw) -> float:
    """The least seconds of one pass of ``name`` on an H100: the larger of
    its bytes over :data:`PEAK_HBM_BYTES_S` and its operations over
    :data:`PEAK_F32_FLOPS_S`."""
    return max(stage_bytes(name, shp, w_itemsize, **kw) / PEAK_HBM_BYTES_S,
               stage_flops(name, shp, **kw) / PEAK_F32_FLOPS_S)


def solve_passes(iterations: int, naccepts: int, cg_steps: int) -> dict:
    """How many times a Schur-PCG LM solve must do each stage, from its
    decisions: a linearization at the start and after each accepted step,
    one reduced camera system an iteration, one Schur matvec a CG step
    plus one back-substitution an iteration, one trial objective an
    iteration."""
    return {"assemble": naccepts + 1, "cam_reduce": iterations,
            "matvec": cg_steps + iterations, "objective": iterations}


def solve_least_s(shp, w_itemsize: int, iterations: int, naccepts: int,
                  cg_steps: int) -> float:
    """A solve's least device seconds on an H100, whatever implements it."""
    return sum(count * least_s(name, shp, w_itemsize) for name, count in
               solve_passes(iterations, naccepts, cg_steps).items())
