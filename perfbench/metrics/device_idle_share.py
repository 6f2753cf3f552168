"""Device (H100): the share of the traced window in which no kernel, copy
or fill ran on the card, %: 1 - (union of the device intervals) / (the
window's wall time)."""


def read(ctx):
    red = ctx.run["trace"]
    if not red or red["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
