"""SLAM runtime: module ownership, pipeline scheduling, loop-closure loop.

Counterpart of the JAX package's ``models/slam.py`` (reference
SlamWrapper.cpp:31-1142):
  - owns odometry / mapper / submaps / place recognition / optimization,
  - worker pipeline decoupled by bounded buffers: odometry -> mapping ->
    (dense map, features, loop closure) (startWorkers :527-538),
  - feature computation for finished submaps (:1039-1047), loop-closure
    attempts (:1049-1059),
  - applying the optimized pose graph back onto submaps + trajectory
    (updateSubmapsAndTrajectory :1105-1140),
  - offline deterministic single-stepping for replay (usePairForRegistration
    :517, offline workers :588-905),
  - map/submap saving (:545-582) and end-of-mission autosave (:80-93).

Every stage enqueues its kernels on the current CUDA stream; the host
threads only sequence work.  The feature and loop-closure workers read
their results through pinned copies and events (``utils/device.HostCopy``),
so the map worker never waits behind them on the host.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import sys
import threading
import time as _time
import traceback
from typing import List, Optional, Tuple

import numpy as np

from ..ops import normals as normals_ops
from ..utils import io as io_utils
from ..utils import timing
from ..utils.config import SlamParameters
from ..utils.device import resolve_device, to_device
from ..utils.pointcloud import PointCloud
from . import motion_compensation
from .mapper import Mapper
from .odometry import LidarOdometry
from .place_recognition import PlaceRecognition, compute_odometry_constraints
from .pose_graph import OptimizationProblem


@dataclasses.dataclass
class TimestampedScan:
    scan: PointCloud
    time: float
    scan_id: Optional[int] = None  # the tracer's scan id


class SlamWrapper:
    """``device`` defaults to ``cuda`` and the constructor raises where no
    CUDA device exists; tests pass ``device="cpu"``, where every kernel
    wrapper takes its plain twin."""

    def __init__(self, params: Optional[SlamParameters] = None, device=None):
        self.device = resolve_device(device)
        self.params = params if params is not None else SlamParameters()
        self.odometry = LidarOdometry(self.params, device=self.device)
        self.mapper = Mapper(self.params, device=self.device)
        self.place_recognition = PlaceRecognition(self.params.mapper)
        self.optimization = OptimizationProblem(
            max_nodes=self.params.mapper.submaps.max_submaps,
            max_edges=self.params.mapper.submaps.max_submaps * 8, device=self.device)
        # External odometry feed (≙ addOdometryPoseToBuffer).
        self.use_external_odometry = False
        # Bounded hand-off queues (≙ CircularBuffer size 1 defaults).
        self.odometry_queue: "queue.Queue[TimestampedScan]" = queue.Queue(maxsize=2)
        self.mapping_queue: "queue.Queue[TimestampedScan]" = queue.Queue(maxsize=2)
        self.dense_queue: "queue.Queue[Tuple[PointCloud, np.ndarray]]" = queue.Queue(maxsize=2)
        self._workers: List[threading.Thread] = []
        self._stop = threading.Event()
        self._lc_lock = threading.Lock()
        self._feature_lock = threading.Lock()  # serialize feature passes
        self._traj_lock = threading.Lock()  # atomic drain+append ordering
        self.loop_closure_count = 0
        self.optimized_graph_available = False
        self._pending_increments = None
        self.trajectory_times: List[float] = []
        self.trajectory_poses: List[np.ndarray] = []
        # Online bookkeeping so finish_processing can drain exactly.
        self._scans_accepted = 0
        # Every scan taken gets the next number: the tracer's scan id.
        self.scans_taken = 0
        # Which threads ran feature computation (the online smoke run checks
        # that the map worker never does).
        self._feature_compute_threads: List[str] = []

    # ------------------------------------------------------------------ feeds

    def add_odometry_pose(self, time: float, pose: np.ndarray) -> bool:
        """≙ SlamWrapper::addOdometryPoseToBuffer (SlamWrapper.cpp:150-210)."""
        self.use_external_odometry = True
        return self.mapper.odom_buffer.push(time, pose)

    def add_range_scan(self, scan: PointCloud, time: float) -> bool:
        """Online entry: enqueue for the odometry worker
        (≙ addRangeScan, SlamWrapper.cpp:217-251)."""
        self.scans_taken += 1
        try:
            self.odometry_queue.put_nowait(TimestampedScan(scan, time, self.scans_taken))
            self._scans_accepted += 1
            return True
        except queue.Full:
            return False  # ≙ bounded CircularBuffer drop

    def set_initial_transform(self, T: np.ndarray) -> None:
        self.mapper.set_map_to_range_sensor(T)
        self.odometry.set_initial_transform(T)

    def set_external_odometry_frame_to_cloud_frame_calibration(self, T: np.ndarray) -> None:
        """External odometry poses track a body frame; the mapper's
        initial-guess math de-rotates them into the cloud frame through
        this transform."""
        self.mapper.calibration = np.asarray(T, dtype=np.float32).reshape(4, 4)

    def set_initial_map(self, map_cloud: PointCloud, time: float = 0.0) -> None:
        """Localization bootstrap (≙ setInitialMap, SlamWrapper.cpp:460-472):
        install a prebuilt map as the first submap."""
        prepared = normals_ops.estimate_normals(
            map_cloud.to(self.device), radius=1.0, k=16,
            sensor_origin=self.mapper.map_to_range_sensor[:3, 3])
        self.mapper.submaps.insert_scan(prepared, self.mapper.map_to_range_sensor, time)
        self.mapper.is_use_initial_map = True
        self.mapper.submaps.is_localization_mode = True

    # ------------------------------------------------------- offline stepping

    def use_pair_for_registration(self, scan: PointCloud, odom_pose: Optional[np.ndarray],
                                  time: float) -> bool:
        """Deterministic single-step: one scan (+ paired odometry pose)
        through odometry -> mapping -> features -> loop closure.
        ≙ usePairForRegistration + offline workers (SlamWrapper.cpp:517-905)."""
        self.scans_taken += 1
        timing.set_scan(self.scans_taken)
        scan = scan.to(self.device)
        if odom_pose is not None:
            self.add_odometry_pose(time, odom_pose)
        else:
            self.odometry.add_range_scan(scan, time)
            self.mapper.odom_buffer.push(time, self.odometry.odom_to_range_sensor)
        scan = self._motion_compensate(scan)
        ok = self.mapper.add_range_measurement(scan, time)
        # Offline mode is the reference's synchronous single-stepper: flush
        # the lag block every scan so the pose and trajectory reflect THIS
        # scan deterministically.
        self.mapper.flush()
        self._consume_finalized(dense_inline=True)
        self.compute_features_if_ready()
        if self.params.mapper.mapper_localizer.is_attempt_loop_closures:
            self.attempt_loop_closures_if_ready()
        self.check_if_optimized_graph_available()
        return ok

    def _consume_finalized(self, dense_inline: bool = False) -> int:
        """Drain the mapper's flushed per-scan records into the trajectory
        log and the dense-map feed, preserving order."""
        build_dense = self.params.mapper.mapper_localizer.is_build_dense_map
        with self._traj_lock:
            recs = self.mapper.drain_finalized()
            for rec in recs:
                self.trajectory_times.append(rec.time)
                self.trajectory_poses.append(np.asarray(rec.pose, dtype=np.float32).copy())
                if build_dense and rec.raw is not None:
                    if dense_inline:
                        self._insert_dense(rec.raw, rec.pose)
                    else:
                        try:
                            # Registered scan + refined pose; the dense
                            # worker fuses off the critical path.
                            self.dense_queue.put_nowait((rec.raw, rec.pose.copy()))
                        except queue.Full:
                            pass  # bounded buffer: drop, like the reference
        return len(recs)

    def _insert_dense(self, raw: PointCloud, pose: np.ndarray) -> None:
        self.mapper.submaps.insert_dense(raw.transform(to_device(pose, self.device)))

    # ----------------------------------------------------- background stages

    def _motion_compensate(self, scan: PointCloud) -> PointCloud:
        mc = self.params.motion_compensation
        if not mc.is_undistort_scan:
            return scan
        with timing.span("deskew"):
            twist = motion_compensation.estimate_twist_from_buffer(
                self.mapper.odom_buffer, mc.scan_duration, mc.num_poses_vel_estimation,
                calibration=self.mapper.calibration)
            return motion_compensation.undistort(scan.to(self.device),
                                                 to_device(twist, self.device),
                                                 mc.is_spinning_clockwise)

    @timing.traced("loop_closure")
    def compute_features_if_ready(self) -> None:
        """≙ computeFeaturesIfReady (SlamWrapper.cpp:1039-1047).  Online
        this runs on its OWN worker thread, so descriptor work on finished
        submaps never stalls the map worker's scan latency; the offline
        stepper calls it inline."""
        sc = self.mapper.submaps
        with self._feature_lock:
            if not sc.finished_queue:
                return
            finished = [idx for idx, _ in sc.finished_queue]
            # Recorded before the pass: it empties the queue as it goes, and
            # a caller that waits for an empty queue reads this list next.
            self._feature_compute_threads.append(threading.current_thread().name)
            with timing.span("loop_closure/features"):
                sc.compute_features_for_finished()
            mp = self.params.mapper
            with timing.span("loop_closure/odometry_constraints"):
                odo = compute_odometry_constraints(
                    sc.submaps, finished,
                    map_voxel_size=mp.map_builder.map_voxel_size,
                    overlap_capacity=mp.place_recognition.overlap_point_capacity,
                    refine=mp.mapper_localizer.is_refine_odometry_constraints_between_submaps)
        with self._lc_lock:
            self.optimization.insert_odometry_constraints(odo)

    @timing.traced("loop_closure")
    def attempt_loop_closures_if_ready(self) -> None:
        """≙ attemptLoopClosuresIfReady + loopClosureWorker
        (SlamWrapper.cpp:1049-1103)."""
        sc = self.mapper.submaps
        candidates = sc.pop_loop_closure_candidates()
        if not candidates:
            return
        new_constraints = []
        with self._lc_lock:
            with timing.span("loop_closure/candidates"):
                for idx, _ in candidates:
                    new_constraints.extend(
                        self.place_recognition.build_loop_closure_constraints(
                            sc.submaps, sc.adjacency, idx, sc.active_idx,
                            sc.loop_closure_submaps))
            if not new_constraints:
                return
            self.optimization.insert_loop_closure_constraints(new_constraints)
            for c in new_constraints:
                sc.mark_loop_closure_submaps([c.source_id, c.target_id])
            self.loop_closure_count += len(new_constraints)
            # Dispatch the pose-graph solve; the applier resolves its
            # readback on the next tick.
            go = self.params.mapper.global_optimization
            with timing.span("loop_closure/solve"):
                handle = self.optimization.solve_async(
                    [s.pose for s in sc.submaps],
                    loop_closure_preference=go.loop_closure_preference,
                    edge_prune_threshold=go.edge_prune_threshold,
                    reference_node=go.reference_node,
                    max_iterations=go.max_iterations)
            self._pending_increments = handle
            self.optimized_graph_available = True

    @timing.traced("loop_closure")
    def check_if_optimized_graph_available(self) -> None:
        """≙ checkIfOptimizedGraphAvailable + updateSubmapsAndTrajectory
        (SlamWrapper.cpp:1000, 1105-1140)."""
        if not self.optimized_graph_available:
            return
        # GIL-atomic swap (no _lc_lock here: the LC thread holds it for
        # whole candidate builds and the map worker must not stall).
        handle, self._pending_increments = self._pending_increments, None
        self.optimized_graph_available = False
        if handle is None:
            return
        with timing.span("loop_closure/apply"):
            incs = self.optimization.resolve_async(handle)
            sc = self.mapper.submaps
            # Submap transforms mutate the active table: hand truth back from
            # the chained device state first.
            self.mapper.materialize()
            sc.apply_transforms(incs)
            # Correct the live pose by the active submap's increment.
            active_id = sc.active_submap.submap_id
            if active_id in incs:
                correction = incs[active_id]
                self.mapper.loop_closure_update(correction)
                self.trajectory_poses = [
                    (correction @ p).astype(np.float32) for p in self.trajectory_poses]
            # Applied loop closures become odometry-grade (certain) edges so the
            # next solve doesn't re-litigate them (≙ SlamWrapper.cpp:1128-1139).
            for c in self.optimization.loop_closure_constraints:
                c.is_odometry = True
            self.optimization.insert_odometry_constraints(
                self.optimization.loop_closure_constraints)
            self.optimization.clear_loop_closure_constraints()

    # ------------------------------------------------------------ online mode

    def _spawn(self, fn, name: str) -> None:
        t = threading.Thread(target=fn, name=f"slam-{name}", daemon=True)
        t.start()
        self._workers.append(t)

    def start_workers(self) -> None:
        """≙ startWorkers (SlamWrapper.cpp:527-538)."""
        self._stop.clear()

        def odom_worker():
            while not self._stop.is_set():
                try:
                    item = self.odometry_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                timing.set_scan(item.scan_id)
                if not self.use_external_odometry:
                    self.odometry.add_range_scan(item.scan, item.time)
                    self.mapper.odom_buffer.push(item.time,
                                                 self.odometry.odom_to_range_sensor)
                while not self._stop.is_set():
                    try:
                        self.mapping_queue.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue

        def map_worker():
            while not self._stop.is_set():
                try:
                    item = self.mapping_queue.get(timeout=0.05)
                except queue.Empty:
                    # Keep draining readbacks that land while the stream is
                    # quiet, so the pose stays fresh.
                    self.mapper.poll()
                    self._consume_finalized()
                    continue
                timing.set_scan(item.scan_id)
                scan = self._motion_compensate(item.scan)
                self.mapper.add_range_measurement(scan, item.time)
                # When the intake looks idle, poll (release the partial
                # block once the device pipeline is empty) instead of a
                # blocking flush.
                if self.mapping_queue.empty() and self.odometry_queue.empty():
                    self.mapper.poll()
                self._consume_finalized()
                # Features are computed on the feature worker; the map
                # worker only applies finished pose-graph results.
                self.check_if_optimized_graph_available()

        def dense_worker():
            # ≙ denseMapWorker (SlamWrapper.cpp:1014-1037).
            while not self._stop.is_set():
                try:
                    scan, pose = self.dense_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                self._insert_dense(scan, pose)

        def feature_worker():
            while not self._stop.is_set():
                if self.mapper.submaps.finished_queue:
                    self.compute_features_if_ready()
                _time.sleep(0.02)

        def lc_worker():
            while not self._stop.is_set():
                if self.params.mapper.mapper_localizer.is_attempt_loop_closures:
                    self.attempt_loop_closures_if_ready()
                _time.sleep(0.02)

        for fn, name in ((odom_worker, "odom"), (map_worker, "map"), (dense_worker, "dense"),
                         (feature_worker, "features"), (lc_worker, "lc")):
            self._spawn(fn, name)

    def start_visualization(self, out_dir: str, rate_hz: float = 1.0, publish_fn=None) -> None:
        """Live periodic visualization worker (≙ the reference's
        visualization worker publishing assembled map / submaps /
        submap-origin axes / tracked + best-guess paths at a fixed rate,
        SlamWrapperRos.cpp:247-330): ``frontends.viz.LiveVisualizationPublisher``
        ticks at ``rate_hz`` on this worker's thread, which alone waits for
        the tables' copies; ``publish_fn`` receives the written paths.  A
        failed tick never stops the pipeline."""
        from ..frontends.viz import LiveVisualizationPublisher

        pub = LiveVisualizationPublisher(out_dir, publish_fn=publish_fn)
        self.viz_publisher = pub

        def viz_worker():
            period = 1.0 / max(rate_hz, 1e-3)
            while not self._stop.is_set():
                try:
                    pub.tick(self)
                except Exception:  # the bundle must never stop the pipeline
                    traceback.print_exc(file=sys.stderr)
                _time.sleep(period)

        self._spawn(viz_worker, "viz")

    def start_pose_stream(self, callback, rate_hz: float = 200.0) -> None:
        """Fixed-rate map->sensor pose output stream (≙ the ROS wrapper's
        tfWorker, SlamWrapperRos.cpp:147-192): ``callback(time, pose4x4)``
        receives the latest pose independently of scan arrival."""

        def pose_worker():
            period = 1.0 / rate_hz
            while not self._stop.is_set():
                buf = self.mapper.map_to_range_sensor_buffer
                if len(buf) > 0:
                    t, T = buf.items()[-1]
                    callback(t, np.asarray(T))
                _time.sleep(period)

        self._spawn(pose_worker, "pose-stream")

    def stop_workers(self) -> None:
        self._stop.set()
        for t in self._workers:
            t.join(timeout=2.0)
        self._workers.clear()

    def finish_processing(self) -> None:
        """Drain queues, close the last submap, final LC + optimization
        (≙ finishProcessing / offlineFinishProcessing, SlamWrapper.cpp:300-380)."""
        deadline = _time.time() + 30.0
        # Every accepted scan must have produced a trajectory entry, and the
        # queues must be empty: queue.empty() alone races with the item a
        # worker already popped.
        while _time.time() < deadline:
            drained = (self.odometry_queue.empty() and self.mapping_queue.empty()
                       and self.dense_queue.empty())
            if drained:
                # Flush the trailing (partial) lag block and drain it.
                self.mapper.flush()
                self._consume_finalized(dense_inline=not self._workers)
            if drained and (not self._workers
                            or len(self.trajectory_poses) >= self._scans_accepted):
                break
            _time.sleep(0.01)
        self.mapper.materialize()
        sc = self.mapper.submaps
        if sc.submaps and sc.active_submap.n_scans > 0:
            # Force-finish the active submap so it gets features too.
            sc.finished_queue.append(
                (sc.active_idx, self.trajectory_times[-1] if self.trajectory_times else 0.0))
            self.compute_features_if_ready()
            if self.params.mapper.mapper_localizer.is_attempt_loop_closures:
                self.attempt_loop_closures_if_ready()
                self.check_if_optimized_graph_available()

    # ------------------------------------------------------------ persistence

    def save_map(self, path: str) -> str:
        """≙ saveMap service (SlamWrapper.cpp:545-560)."""
        io_utils.save_pcd(path, self.mapper.get_assembled_map())
        return f"Map saved to {path}"

    def save_submaps(self, directory: str, dense: bool = False) -> str:
        """≙ saveSubmaps service + SubmapCollection dump (:561-582)."""
        self.mapper.materialize()
        os.makedirs(directory, exist_ok=True)
        for i, sm in enumerate(self.mapper.submaps.submaps):
            io_utils.save_pcd(os.path.join(directory, f"submap_{i}.pcd"), sm.map.cloud)
            if dense and sm.dense_map is not None:
                io_utils.save_pcd(os.path.join(directory, f"denseSubmap_{i}.pcd"),
                                  sm.dense_map.cloud)
        return f"Saved {len(self.mapper.submaps.submaps)} submaps to {directory}"

    def save_trajectory(self, path: str) -> None:
        io_utils.save_tum_trajectory(path, self.trajectory_times, self.trajectory_poses)

    def save_pose_graph(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.optimization.to_dict(), f)

    def mission_end_autosave(self, directory: str) -> None:
        """≙ end-of-mission autosave (SlamWrapper.cpp:80-93)."""
        s = self.params.saving
        if not s.save_at_mission_end:
            return
        os.makedirs(directory, exist_ok=True)
        if s.save_map:
            self.save_map(os.path.join(directory, "map.pcd"))
        if s.save_submaps:
            self.save_submaps(directory, dense=s.save_dense_submaps)
        self.save_trajectory(os.path.join(directory, "slam_poses"))
