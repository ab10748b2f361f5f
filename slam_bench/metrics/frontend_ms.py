"""Mean ms a scan in the frontends (reading, decoding, the cloud on the card)."""


def read(ctx):
    return ctx.layer_ms("frontend")
