"""Mean ms a scan in the Mapper (``add_range_measurement`` and ``flush``)."""


def read(ctx):
    return ctx.layer_ms("mapper")
