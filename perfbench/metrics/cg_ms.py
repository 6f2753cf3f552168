"""Step solver (stage 4, ``solve_step``: PCG's loop, or the dense step's
assembly and Cholesky): device ms a solve charged to the span ``ba.pcg``
and the spans the dense step opens inside it (``ba.dense.assemble``,
``ba.dense.factor``), from the traced solves' spans
(`perfbench/spans.py:STAGE_MS`, kept by `perfbench/drivers/closed_loop.py`
as the run's ``spans``)."""

from perfbench import spans


def read(ctx):
    return spans.read_stage(ctx, "cg_ms")
