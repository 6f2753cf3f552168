"""Seconds from the process's start to the window's: imports, the card,
the kernel build (from the checkout's cache after the first run), the
problem's generation and construction, and the warm-up solves."""


def read(ctx):
    return ctx.run["setup_s"]
