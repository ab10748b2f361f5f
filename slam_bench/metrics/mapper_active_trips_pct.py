"""The share of the Mapper's enqueued ICP trips that moved the pose: the
program's counters ``mapper/icp_trips_active`` over
``mapper/icp_trips_dispatched``, in percent."""
from slam_bench import stages


def read(ctx):
    return stages.active_trips_pct(ctx, "mapper")
