"""The share of the scan-to-scan odometry's enqueued ICP trips that moved
the pose: ``odometry/icp_trips_active`` over
``odometry/icp_trips_dispatched``, in percent."""
from slam_bench import stages


def read(ctx):
    return stages.active_trips_pct(ctx, "odometry")
