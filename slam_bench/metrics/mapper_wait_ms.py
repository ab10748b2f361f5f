"""Mean ms a scan in which the stepping thread waits in ``Mapper.flush`` for
the reader thread's readback and bookkeeping: the program's own
``mapper/flush_wait`` spans."""
from slam_bench import stages


def read(ctx):
    return stages.span_ms_per_scan(ctx, "mapper/flush_wait")
