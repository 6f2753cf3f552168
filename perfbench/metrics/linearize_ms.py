"""Kernels (stage 1, ``solver/lm_jit.py:_linearize``: K7 or K1, K2 cam90's
camera walk, K6 pnt12 and the torch work around them): device ms a solve
charged to the span ``ba.linearize``, from the traced solves' spans
(`perfbench/spans.py:STAGE_MS`, kept by `perfbench/drivers/closed_loop.py`
as the run's ``spans``)."""

from perfbench import spans


def read(ctx):
    return spans.read_stage(ctx, "linearize_ms")
