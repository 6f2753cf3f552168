"""LM driver (``solver/lm_jit.py``: the lambda schedule, the stop tests,
set-up and the host reads between stages): ms a solve in which the device
was idle while the host was inside ``ba.solve`` and outside every stage
span, each gap charged to the innermost span open at its midpoint, from the
traced solves' spans (`perfbench/spans.py:STAGE_MS`, kept by
`perfbench/drivers/closed_loop.py` as the run's ``spans``)."""

from perfbench import spans


def read(ctx):
    return spans.read_stage(ctx, "lm_idle_ms")
