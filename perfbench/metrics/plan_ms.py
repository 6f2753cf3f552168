"""Launch plans (``ops/plans.py``, built at each solve's first kernel
calls): host ms a solve in the outermost ``ba.plan.*`` spans, from the
traced solves' spans (`perfbench/spans.py:per_solve`, kept by
`perfbench/drivers/closed_loop.py` as the run's ``spans``)."""

from perfbench import spans


def read(ctx):
    return spans.read_stage(ctx, "plan_ms")
