"""Kernels: the traced solves' least device time on an H100 (from their
decisions and the configuration's shapes, `perfbench/yardstick.py`) over
the device's busy time in the traced window, %. Every device operation
counts in the busy time, the port's kernels and torch's alike, so fusing,
splitting or renaming kernels leaves the yardstick as it is."""

from perfbench import yardstick


def read(ctx):
    red = ctx.run["trace"]
    if not red or red["busy_s"] <= 0:
        return None
    shp = yardstick.shape(ctx.cfg)
    least = sum(yardstick.solve_least_s(shp, ctx.w_itemsize,
                                        s["iterations"], s["naccepts"],
                                        s["cg"])
                for s in ctx.run["solves"])
    return 100.0 * least / red["busy_s"]
