"""Kernels (the dense step's S, ``ops/dense_schur.py`` and
``csrc/dense_pairs.cu``): device ms a solve charged to the span
``ba.dense.assemble`` (the pair kernel and the torch work around it; the
pair plan's build is ``ba.plan``), from the traced solves' spans
(`perfbench/spans.py`, kept by the driver as the run's ``spans``)."""

SPAN = "ba.dense.assemble"


def read(ctx):
    red = ctx.run.get("spans")
    solves = ctx.run["solves"]
    if not red or not solves or SPAN not in red["device"]:
        return None
    return 1e3 * red["device"][SPAN] / len(solves)
