"""Mean ms a scan in motion compensation (``SlamWrapper._motion_compensate``)."""


def read(ctx):
    return ctx.layer_ms("deskew")
