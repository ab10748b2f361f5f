"""The 90th percentile of the wall time of one ``use_pair_for_registration``
call, over every scan of the window."""
import statistics


def read(ctx):
    steps = sorted(1e3 * s for s in ctx.window.step_s)
    if len(steps) < 2:
        return None
    return statistics.quantiles(steps, n=10)[-1]
