"""Step solver (``ops/pcg.py``): CG steps a solve, the mean over the
traced solves of the sum of ``LMJitResult.hist_cg``. A decision."""


def read(ctx):
    solves = ctx.run["solves"]
    return sum(s["cg"] for s in solves) / len(solves) if solves else None
