"""Schur glue and torch ops (stages 2-3, ``solve_step``: the reduced camera
system, its camera reduce and the block-Jacobi preconditioner): device ms a
solve charged to the span ``ba.reduce``, from the traced solves' spans
(`perfbench/spans.py:STAGE_MS`, kept by `perfbench/drivers/closed_loop.py`
as the run's ``spans``)."""

from perfbench import spans


def read(ctx):
    return spans.read_stage(ctx, "reduce_ms")
