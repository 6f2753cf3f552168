"""Seconds a solve: the window's length (its start to the end of its last
solve) over the solves it completed. Each solve builds its own launch
plans and runs to the configuration's stop."""


def read(ctx):
    solves = ctx.run["solves"]
    return ctx.run["window_s"] / len(solves) if solves else None
