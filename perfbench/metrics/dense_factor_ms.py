"""Step solver (the dense step's Cholesky, ``ops/schur.py:solve_dense``):
device ms a solve charged to the span ``ba.dense.factor``
(``cholesky_ex`` and ``cholesky_solve`` of the 9 ncams square S), from the
traced solves' spans (`perfbench/spans.py`, kept by the driver as the
run's ``spans``)."""

SPAN = "ba.dense.factor"


def read(ctx):
    red = ctx.run.get("spans")
    solves = ctx.run["solves"]
    if not red or not solves or SPAN not in red["device"]:
        return None
    return 1e3 * red["device"][SPAN] / len(solves)
