"""Mean ms a scan in the scan-to-scan odometry (``LidarOdometry.add_range_scan``)."""


def read(ctx):
    return ctx.layer_ms("odometry")
