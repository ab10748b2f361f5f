"""Mean host ms a scan in which the stepping thread enqueues the Mapper's
blocks: the program's own ``mapper/dispatch`` spans."""
from slam_bench import stages


def read(ctx):
    return stages.span_ms_per_scan(ctx, "mapper/dispatch")
