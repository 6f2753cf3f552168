"""The yardstick's least bytes and time, worked by hand at one tiny
shape."""

from __future__ import annotations

import types

import pytest

from perfbench import yardstick

# 2 cameras, 3 points, 2 observations a point: 6 rows, padded to 8.
SHP = types.SimpleNamespace(nobs_pad=8, ncams=2, npnts=3)


def test_shape_pads_rows():
    shp = yardstick.shape(dict(ncams=2, npnts=3, nobs=6, pad_obs_to=8))
    assert (shp.nobs_pad, shp.ncams, shp.npnts) == (8, 2, 3)
    assert yardstick.shape(dict(ncams=2, npnts=3, nobs=5,
                                pad_obs_to=4)).nobs_pad == 8


def test_least_bytes_by_hand():
    n, nc, npt = 8, 2, 3
    state = (9 * nc + 3 * npt) * 4                     # 108
    rows = 3 * n * 4 + 2 * 4 * n                       # pt2d, w; two ids
    W2 = 27 * n * 2                                    # bf16 W
    assert state == 108 and rows == 160 and W2 == 432
    # assemble: state, rows, cam_perm, both starts, W written,
    # [Hpp | g_p] (12 a point) and [Hcc | g_c] (90 a camera), the objective
    want = 108 + 160 + 32 + 16 + 12 + W2 + 144 + 720 + 4
    assert yardstick.stage_bytes("assemble", SHP, 2) == want
    # matvec: W, three ids, starts, x and Sx, Hpp^-1
    assert yardstick.stage_bytes("matvec", SHP, 2) == (
        W2 + 96 + 16 + 12 + 72 + 108 + 72)
    assert yardstick.stage_bytes("objective", SHP) == 108 + 4 + 160
    assert yardstick.stage_bytes("cam_reduce", SHP, 4) == (
        27 * n * 4 + 64 + 12 + 108 + 36 + 720)


def test_least_time_takes_the_larger_bound():
    t = yardstick.least_s("assemble", SHP, 2)
    b = yardstick.stage_bytes("assemble", SHP, 2) / yardstick.PEAK_HBM_BYTES_S
    f = yardstick.stage_flops("assemble", SHP) / yardstick.PEAK_F32_FLOPS_S
    assert t == max(b, f)


def test_solve_least_counts_decisions():
    passes = yardstick.solve_passes(iterations=9, naccepts=8, cg_steps=40)
    assert passes == {"assemble": 9, "cam_reduce": 9, "matvec": 49,
                      "objective": 9}
    total = yardstick.solve_least_s(SHP, 2, 9, 8, 40)
    assert total == pytest.approx(sum(
        k * yardstick.least_s(name, SHP, 2) for name, k in passes.items()))


def test_dense_factor_by_hand():
    """S of 2 cameras is 18 square: its lower triangle 171 entries."""
    from perfbench import factor_yardstick as fy
    cfg = dict(ncams=2)
    assert fy.order(cfg) == 18 and fy.triangle(cfg) == 171
    assert fy.factor_flops(cfg) == pytest.approx(1944.0)   # 18^3 / 3
    assert fy.factor_bytes(cfg) == 1368                    # 171 read, written
    assert fy.solve_flops(cfg) == 324
    assert fy.solve_bytes(cfg) == 4 * (171 + 36)           # L, b and x
    # bytes bind at this size
    assert fy.step_least_s(cfg) == pytest.approx(
        (1368 + 2 * 828) / yardstick.PEAK_HBM_BYTES_S)


def test_dense_factor_at_venice1778():
    """Venice-1778's S (16,002 square): 1.37 TFLOP a factorization, the
    operations bind it at 20.39 ms; each triangular solve reads 0.51 GB."""
    from perfbench import factor_yardstick as fy
    cfg = dict(ncams=1778)
    assert fy.factor_flops(cfg) == pytest.approx(1.3659e12, rel=1e-4)
    assert fy.solve_bytes(cfg) == pytest.approx(5.1229e8, rel=1e-4)
    assert fy.step_least_s(cfg) == pytest.approx(
        fy.factor_flops(cfg) / yardstick.PEAK_F32_FLOPS_S
        + 2 * fy.solve_bytes(cfg) / yardstick.PEAK_HBM_BYTES_S)
    assert fy.step_least_s(cfg) == pytest.approx(20.69e-3, rel=1e-3)
