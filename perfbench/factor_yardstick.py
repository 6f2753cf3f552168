"""The dense step's factorization yardstick: the least operations and bytes
of one Cholesky factorization of S and of the two triangular solves that
give the step from it, counted from a configuration's shapes, and their
least time on an H100 (the peaks of `perfbench/yardstick.py`).

S is the reduced camera system, ``n = 9 ncams`` square, factored once an
LM iteration. The factorization takes ``n^3 / 3`` operations (an FMA two),
reads S's lower triangle once and writes L's once. Each triangular solve
takes ``n^2`` operations and reads L's lower triangle once, its right side
once and writes its answer once. Each pass's least time is the larger of
its bytes over the HBM rate and its operations over the float32 rate
outside the tensor cores (the configuration factors in float32). Scratch,
re-reads and the copies a library makes are not counted.
"""

from __future__ import annotations

from perfbench.yardstick import PEAK_F32_FLOPS_S, PEAK_HBM_BYTES_S

F32 = 4
# The triangular solves of one step: L y = b, then L' x = y.
SOLVES = 2


def order(cfg: dict) -> int:
    """S's order: 9 parameters a camera."""
    return 9 * int(cfg["ncams"])


def triangle(cfg: dict) -> int:
    """The entries of S's lower triangle, its diagonal with them."""
    n = order(cfg)
    return n * (n + 1) // 2


def factor_flops(cfg: dict) -> float:
    return order(cfg) ** 3 / 3


def factor_bytes(cfg: dict) -> int:
    return 2 * F32 * triangle(cfg)


def solve_flops(cfg: dict) -> int:
    return order(cfg) ** 2


def solve_bytes(cfg: dict) -> int:
    return F32 * (triangle(cfg) + 2 * order(cfg))


def step_least_s(cfg: dict) -> float:
    """One iteration's least seconds on an H100: the factorization and
    the two triangular solves, each bound by the larger of its two
    rates."""
    def least(flops, nbytes):
        return max(flops / PEAK_F32_FLOPS_S, nbytes / PEAK_HBM_BYTES_S)
    return (least(factor_flops(cfg), factor_bytes(cfg))
            + SOLVES * least(solve_flops(cfg), solve_bytes(cfg)))
