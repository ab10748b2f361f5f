"""Mean ms a scan in the loop-closure layer: features, closure candidates and
the pose-graph solve, and its feedback."""


def read(ctx):
    return ctx.layer_ms("loop_closure")
