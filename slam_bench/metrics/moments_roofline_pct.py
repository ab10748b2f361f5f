"""K2's share of its roofline: the sampled calls' least time over their
device time, in percent."""


def read(ctx):
    return ctx.roofline_pct("moments")
