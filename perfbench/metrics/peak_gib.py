"""The device memory the window's solves held at their peak
(``torch.cuda.max_memory_allocated``, reset after set-up), GiB."""


def read(ctx):
    peak = ctx.run["peak_bytes"]
    return peak / 2**30 if peak else None
