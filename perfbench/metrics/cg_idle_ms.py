"""Step solver: ms a solve in which the device was idle while the host was
inside the step solver's spans (``ba.pcg`` and the dense step's), each gap
charged to the innermost span open at its midpoint, from the traced solves'
spans (`perfbench/spans.py:STAGE_MS`, kept by
`perfbench/drivers/closed_loop.py` as the run's ``spans``)."""

from perfbench import spans


def read(ctx):
    return spans.read_stage(ctx, "cg_idle_ms")
