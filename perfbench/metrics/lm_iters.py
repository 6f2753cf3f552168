"""LM driver (``solver/lm_jit.py``): iterations a solve, the mean over the
traced solves (``LMJitResult.iterations``). A decision, not a speed."""


def read(ctx):
    solves = ctx.run["solves"]
    return sum(s["iterations"] for s in solves) / len(solves) if solves \
        else None
