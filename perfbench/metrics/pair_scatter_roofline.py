"""Kernels: the dense step's pair kernel, its traced assemblies' least
time on an H100 (`perfbench/pair_yardstick.py`, from the configuration's
shapes; one assembly an iteration of the traced solves) over the device
time of its kernels (those whose name starts ``ba_pair_``), %."""

from perfbench import pair_yardstick
from perfbench.trace import kernel_base


def read(ctx):
    red = ctx.run["trace"]
    if not red:
        return None
    sec = sum(v[0] for k, v in red["ops"].items()
              if kernel_base(k).startswith(pair_yardstick.PREFIX))
    calls = sum(s["iterations"] for s in ctx.run["solves"])
    if sec <= 0 or calls <= 0:
        return None
    least = calls * pair_yardstick.assembly_least_s(ctx.cfg, ctx.w_itemsize)
    return 100.0 * least / sec
