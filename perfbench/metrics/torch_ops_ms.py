"""Schur glue and step-solver torch ops (``ops/schur.py``,
``ops/normal.py``, ``ops/pcg.py``, ``ops/plans.py``): device ms a solve in
every device operation that is not a ``ba_`` kernel (cuBLAS, ATen
element-wise and reductions, sorts, copies and fills), from the trace of
the traced solves."""

from perfbench.trace import kernel_base


def read(ctx):
    red = ctx.run["trace"]
    if not red:
        return None
    sec = sum(v[0] for k, v in red["ops"].items()
              if not kernel_base(k).startswith("ba_"))
    return 1e3 * sec / len(ctx.run["solves"]) if sec > 0 else None
