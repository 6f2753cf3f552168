"""Schur glue and torch ops (stage 5, ``solve_step``:
``back_substitute_quad``, the point step and the quadratic form): device ms
a solve charged to the span ``ba.backsub``, from the traced solves' spans
(`perfbench/spans.py:STAGE_MS`, kept by `perfbench/drivers/closed_loop.py`
as the run's ``spans``)."""

from perfbench import spans


def read(ctx):
    return spans.read_stage(ctx, "backsub_ms")
