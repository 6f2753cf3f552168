"""Step solver (the dense step's Cholesky, ``ops/schur.py:solve_dense``):
the traced solves' least factorization time on an H100 (one factorization
and two triangular solves an iteration, `perfbench/factor_yardstick.py`,
from the configuration's shapes) over the device time charged to the span
``ba.dense.factor`` (``cholesky_ex`` with its copies, ``cholesky_solve``),
%."""

from perfbench import factor_yardstick

SPAN = "ba.dense.factor"


def read(ctx):
    red = ctx.run.get("spans")
    sec = red["device"].get(SPAN, 0.0) if red else 0.0
    calls = sum(s["iterations"] for s in ctx.run["solves"])
    if sec <= 0 or calls <= 0:
        return None
    return 100.0 * calls * factor_yardstick.step_least_s(ctx.cfg) / sec
