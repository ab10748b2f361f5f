"""The share of the traced window in which no operation ran on the device."""


def read(ctx):
    if ctx.timeline is None:
        return None
    return 100.0 * (1.0 - ctx.busy_s() / ctx.timeline.window_s)
