"""Device operations (kernels, copies, fills) a scan in the traced window."""


def read(ctx):
    if ctx.timeline is None or not ctx.window.step_s:
        return None
    return len(ctx.timeline.device) / len(ctx.window.step_s)
