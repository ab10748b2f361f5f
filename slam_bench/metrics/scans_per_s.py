"""All scans whose call returned inside the window, over the window's seconds."""


def read(ctx):
    return len(ctx.window.step_s) / ctx.window.window_s
