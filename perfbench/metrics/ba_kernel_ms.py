"""Kernels (``csrc/*.cu``): device ms a solve in the kernels whose function
name starts with ``ba_`` (every kernel the port's ``csrc/`` defines), from
the trace of the traced solves."""

from perfbench.trace import kernel_base


def read(ctx):
    red = ctx.run["trace"]
    if not red:
        return None
    sec = sum(v[0] for k, v in red["ops"].items()
              if kernel_base(k).startswith("ba_"))
    return 1e3 * sec / len(ctx.run["solves"]) if sec > 0 else None
