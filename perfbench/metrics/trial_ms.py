"""Kernels (stage 6, ``_lm_run``: g'd's point parts, K4's trial objectives,
the packed read): device ms a solve charged to the span ``ba.trial``, from
the traced solves' spans (`perfbench/spans.py:STAGE_MS`, kept by
`perfbench/drivers/closed_loop.py` as the run's ``spans``)."""

from perfbench import spans


def read(ctx):
    return spans.read_stage(ctx, "trial_ms")
