"""The share of the device's idle time (between its busy intervals) that
falls inside the program's enqueuing spans, ``mapper/dispatch`` and
``odometry/register``: how much of the idle time the host's dispatch
explains."""
from slam_bench import stages


def read(ctx):
    rec = stages.records(ctx)
    if rec is None or ctx.timeline is None:
        return None
    return stages.idle_in_spans_pct(ctx.timeline, rec["spans"], stages.ENQUEUE)
