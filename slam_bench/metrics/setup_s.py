"""Process start to the first timed scan: imports, the kernel build or
cache hit, the world and its sequence, the warm-up session."""


def read(ctx):
    return ctx.setup_s
