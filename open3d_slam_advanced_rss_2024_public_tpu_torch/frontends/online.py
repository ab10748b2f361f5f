"""Online range-data processor: live ingestion with calibration lookup.

≙ reference OnlineRangeDataProcessorRos (open3d_slam_rsl/ros/
open3d_slam_ros/src/OnlineRangeDataProcessorRos.cpp):
  - readStaticTransformationIfNeeded (:32-102): poll the transform buffer
    until the odometry-tracked-frame -> cloud-frame calibration resolves,
    then install it on the SLAM wrapper; identical frames (or no odometry
    topic) short-circuit to identity.
  - cloudCallback / poseStampedCallback (:105-210): stamp-ordered feeds
    into the wrapper's worker queues, adopting the sensor frame from the
    first cloud.

Transport-agnostic: frames arrive via plain method calls (wire them to any
bus — the rosbag reader, a socket, shared memory); the TF tree is the
framework's StaticTransformBuffer.  Counterpart of the JAX package's
``frontends/online.py``: the scans go to the wrapper's device, where its
workers run.
"""
from __future__ import annotations

import sys
import time as _time
from typing import Optional

import numpy as np

from ..models.slam import SlamWrapper
from ..utils.frames import StaticTransformBuffer
from ..utils.pointcloud import PointCloud


class OnlineRangeDataProcessor:
    def __init__(self, slam: SlamWrapper, tf_buffer: Optional[StaticTransformBuffer] = None,
                 odometry_frame: str = "odom_sensor",
                 range_sensor_frame: str = "default",
                 use_odometry_topic: bool = True):
        self.slam = slam
        self.tf = tf_buffer if tf_buffer is not None else StaticTransformBuffer()
        self.odometry_frame = odometry_frame
        self.range_sensor_frame = range_sensor_frame
        self.use_odometry_topic = use_odometry_topic
        self.calibration_set = False
        self._warned_at = 0.0

    # -- calibration (≙ readStaticTransformationIfNeeded) --------------------

    def read_static_transformation_if_needed(self) -> bool:
        """Try once to resolve the odometry-frame -> cloud-frame calibration;
        False = not available yet, caller keeps polling (the reference
        throttled-warns and retries every cloud until the TF resolves)."""
        if self.calibration_set:
            return True
        if self.range_sensor_frame == "default":
            self._warn_throttled(
                "range sensor frame not set yet (no cloud arrived); delaying "
                "calibration lookup")
            return False
        if (self.range_sensor_frame == self.odometry_frame
                or not self.use_odometry_topic):
            self.slam.set_external_odometry_frame_to_cloud_frame_calibration(
                np.eye(4, dtype=np.float32))
            self.calibration_set = True
            return True
        T = self.tf.lookup(self.range_sensor_frame, self.odometry_frame)
        if T is None:
            self._warn_throttled(
                f"transform not available yet: [{self.range_sensor_frame}] "
                f"to [{self.odometry_frame}]")
            return False
        self.slam.set_external_odometry_frame_to_cloud_frame_calibration(T)
        self.calibration_set = True
        return True

    def _warn_throttled(self, msg: str, period: float = 2.0) -> None:
        now = _time.monotonic()
        if now - self._warned_at >= period:
            print(f"[online] {msg}", file=sys.stderr)
            self._warned_at = now

    # -- feeds (≙ cloudCallback / poseStampedCallback) -----------------------

    def cloud_callback(self, scan: PointCloud, stamp: float,
                       frame_id: str = None) -> bool:
        if frame_id and self.range_sensor_frame == "default":
            # Adopt the sensor frame from the first cloud (:113-118).
            self.range_sensor_frame = frame_id
        self.read_static_transformation_if_needed()
        return self.slam.add_range_scan(scan.to(self.slam.device), stamp)

    def odometry_callback(self, pose: np.ndarray, stamp: float) -> bool:
        self.read_static_transformation_if_needed()
        return self.slam.add_odometry_pose(stamp, pose)

    def start_processing(self) -> None:
        self.slam.start_workers()

    def stop_processing(self) -> None:
        self.slam.stop_workers()
