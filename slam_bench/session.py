"""Missions through the program's offline stepper, the layer spans around
its calls, and what the correctness check needs from each mission.

A mission is what ``frontends/replay.ReplayRunner.run`` does: a fresh
``SlamWrapper``, the frontend's iterator over the cell's sequence,
``set_initial_transform``, the ``start`` of each of the configuration's
extensions, ``use_pair_for_registration`` a frame at a time, then
``finish_processing``.  The spans wrap the calls into each layer
on the mission's own instances; in a traced run each span ends in
``torch.cuda.synchronize()``, so that it holds its layer's device work, and
is marked in the profiler's timeline.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import spec


def sync(device) -> None:
    if str(device) != "cpu":
        torch.cuda.synchronize()


# Layer name -> the calls on a mission's instances that make it up.
LAYERS = {
    "frontend": [],  # the frontend iterator's next(), wrapped in Spans.frames
    "deskew": [("slam", "_motion_compensate")],
    "odometry": [("odometry", "add_range_scan")],
    "mapper": [("mapper", "add_range_measurement"), ("mapper", "flush")],
    "loop_closure": [("slam", "compute_features_if_ready"),
                     ("slam", "attempt_loop_closures_if_ready"),
                     ("slam", "check_if_optimized_graph_available")],
}


class Spans:
    """Seconds spent in each layer, outermost span only: a layer's call
    made from inside another layer's span counts to the outer one.  A
    traced run also keeps each span as (start, end, layer) in wall-clock
    nanoseconds, the time base of the profiler's device events."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: Dict[str, float] = collections.defaultdict(float)
        self.calls: Dict[str, int] = collections.defaultdict(int)
        self.marks: List[tuple] = []
        self._open: Optional[str] = None

    def run(self, name: str, fn, *args, **kwargs):
        if self._open is not None:
            return fn(*args, **kwargs)
        self._open = name
        t0, w0 = time.perf_counter(), time.time_ns()
        try:
            out = fn(*args, **kwargs)
            if self.traced:
                torch.cuda.synchronize()
            return out
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            if self.traced:
                self.marks.append((w0, time.time_ns(), name))
            self._open = None

    def wrap(self, slam) -> None:
        owners = {"slam": slam, "odometry": slam.odometry, "mapper": slam.mapper}
        for layer, calls in LAYERS.items():
            for owner, attr in calls:
                obj = owners[owner]
                fn = getattr(obj, attr)
                setattr(obj, attr, lambda *a, _fn=fn, _l=layer, **k: self.run(_l, _fn, *a, **k))

    def frames(self, iterator):
        it = iter(iterator)
        while True:
            try:
                frame = self.run("frontend", next, it)
            except StopIteration:
                return
            yield frame


@dataclasses.dataclass
class ScanSample:
    """One sampled scan: the program's inputs, state and answers around its
    ``use_pair_for_registration`` call."""

    mission: int
    index: int
    cloud: object             # the frontend's decoded PointCloud
    prev_pose: np.ndarray     # mapper.map_to_range_sensor before the call
    pose: np.ndarray          # the trajectory entry the call appended
    map_before: object        # the active submap's table before the call
    map_after: object
    odo_before: np.ndarray    # the scan-to-scan odometry's pose before / after
    odo_after: np.ndarray
    eligible: bool            # no rollover, closure feedback or fitness gate in the call
    why_not: str = ""


@dataclasses.dataclass
class Solve:
    node_poses: List[np.ndarray]
    constraints: List[tuple]  # (source, target, T f64[4,4], information f64[6,6], uncertain)
    preference: float
    reference_node: int
    increments: Optional[Dict[int, np.ndarray]] = None


class Capture:
    """What the correctness check reads after the window: the sampled
    scans of the window's first mission, every pose-graph solve, and the
    configuration's extensions (``spec.extensions``), whose hooks the
    missions and the check call."""

    def __init__(self, sample_indices, extensions=None):
        self.sample_indices = set(int(i) for i in sample_indices)
        self.extensions = dict(extensions or {})
        self.scans: List[ScanSample] = []
        self.solves: List[Solve] = []
        self.missions: List[dict] = []

    def watch_solves(self, slam) -> None:
        opt = slam.optimization
        solve_async, resolve_async = opt.solve_async, opt.resolve_async
        pending = {}

        def solve(node_poses, loop_closure_preference=2.0, edge_prune_threshold=0.2,
                  reference_node=0, max_iterations=30):
            cs = [(c.source_id, c.target_id, np.array(c.T_source_target, np.float64),
                   np.array(c.information, np.float64), not c.is_odometry)
                  for c in opt.odometry_constraints + opt.loop_closure_constraints]
            handle = solve_async(node_poses, loop_closure_preference=loop_closure_preference,
                                 edge_prune_threshold=edge_prune_threshold,
                                 reference_node=reference_node, max_iterations=max_iterations)
            pending[id(handle)] = Solve([np.array(p, np.float64) for p in node_poses], cs,
                                        float(loop_closure_preference), int(reference_node))
            return handle

        def resolve(handle):
            incs = resolve_async(handle)
            rec = pending.pop(id(handle), None)
            if rec is not None:
                rec.increments = {k: np.array(v, np.float64) for k, v in incs.items()}
                self.solves.append(rec)
            return incs

        opt.solve_async, opt.resolve_async = solve, resolve


def make_slam(params, device):
    from open3d_slam_advanced_rss_2024_public_tpu_torch.models.slam import SlamWrapper

    return SlamWrapper(params, device=device)


def open_frames(seq, sensor: dict, device):
    """The program's frontend over the cell's sequence."""
    if seq.kind == "rosbag":
        from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends.rosbag import \
            rosbag_sequence

        return rosbag_sequence(seq.root, sensor["topic"], odometry_topic=sensor["odometry_topic"],
                               capacity=sensor["capacity"], device=device)
    from open3d_slam_advanced_rss_2024_public_tpu_torch.frontends.kitti import kitti_sequence

    return kitti_sequence(seq.root, "00", capacity=sensor["capacity"],
                          rate_hz=sensor["rate_hz"], device=device)


def start_session(slam, frame, seq, config: dict, device, extensions) -> None:
    """A fresh session's start at its first frame: the initial transform,
    then each extension's ``start``."""
    slam.set_initial_transform(frame.odom_pose if frame.odom_pose is not None
                               else np.eye(4, dtype=np.float32))
    spec.call(extensions, "start", slam, seq, config, device)


def warm_up(params, seq, config: dict, device, n_scans: int, extensions: dict) -> None:
    """One short session of the cell's own shapes."""
    slam = make_slam(params, device)
    for i, frame in enumerate(open_frames(seq, config["sensor"], device)):
        if i == n_scans:
            break
        if i == 0:
            start_session(slam, frame, seq, config, device, extensions)
        slam.use_pair_for_registration(frame.scan, frame.odom_pose, frame.time)
    slam.finish_processing()
    sync(device)


def _state(slam):
    sc = slam.mapper.submaps
    return (len(sc.submaps), sc.active_submap if sc.submaps else None,
            slam.mapper.stats.scans_rejected_low_fitness)


def _table(slam):
    """The active submap's table, handed back by the Mapper's documented
    protocol for an outside read (``materialize``)."""
    slam.mapper.materialize()
    sc = slam.mapper.submaps
    return sc.active_submap.map if sc.submaps else None


@dataclasses.dataclass
class Window:
    step_s: List[float]
    window_s: float
    attempted: int
    failed: int
    missions: int


def run_window(params, seq, config: dict, device, seconds: float, spans: Optional[Spans],
               capture: Capture, on_start=None) -> Window:
    """Missions back to back for ``seconds``; a scan counts if its call
    returned inside the window."""
    step_s: List[float] = []
    attempted = failed = mission = 0
    sync(device)
    if on_start is not None:
        on_start()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while time.perf_counter() < deadline:
        slam = make_slam(params, device)
        capture.watch_solves(slam)
        if spans is not None:
            spans.wrap(slam)
        frames = open_frames(seq, config["sensor"], device)
        frames = spans.frames(frames) if spans is not None else frames
        n_fed, done = 0, True
        for i, frame in enumerate(frames):
            if time.perf_counter() >= deadline:
                done = False
                break
            if i == 0:
                start_session(slam, frame, seq, config, device, capture.extensions)
            sample = mission == 0 and i in capture.sample_indices
            if sample:
                before = _state(slam)
                map_before, prev_pose = _table(slam), slam.mapper.map_to_range_sensor.copy()
                odo_before = slam.odometry.odom_to_range_sensor.copy()
                n_traj, n_solves = len(slam.trajectory_poses), len(capture.solves)
            t0 = time.perf_counter()
            ok = slam.use_pair_for_registration(frame.scan, frame.odom_pose, frame.time)
            t1 = time.perf_counter()
            n_fed += 1
            if t1 > deadline:
                done = False
                break
            step_s.append(t1 - t0)
            attempted += 1
            failed += 0 if ok else 1
            if sample:
                after = _state(slam)
                why = ("no trajectory entry" if len(slam.trajectory_poses) != n_traj + 1 else
                       "rollover" if after[:2] != before[:2] else
                       "closure feedback" if len(capture.solves) != n_solves else
                       "fitness gate" if after[2] != before[2] else "")
                capture.scans.append(ScanSample(
                    mission=mission, index=i, cloud=frame.scan, prev_pose=prev_pose,
                    pose=np.array(slam.trajectory_poses[-1]) if slam.trajectory_poses
                    else prev_pose,
                    map_before=map_before, map_after=_table(slam), odo_before=odo_before,
                    odo_after=slam.odometry.odom_to_range_sensor.copy(), eligible=not why,
                    why_not=why))
        if done and n_fed == len(seq.truth):
            slam.finish_processing()
            capture.missions.append({
                "mission": mission, "complete": True,
                "trajectory": np.stack(slam.trajectory_poses).astype(np.float64),
                "closures": int(slam.loop_closure_count),
                "submaps": len(slam.mapper.submaps.submaps),
                "odometry_rejected": slam.odometry.rejected_jumps + slam.odometry.low_fitness,
                "voxels_dropped": slam.mapper.stats.map_voxels_dropped})
        else:
            capture.missions.append({"mission": mission, "complete": False, "fed": n_fed,
                                     "voxels_dropped": slam.mapper.stats.map_voxels_dropped})
        mission += 1
    sync(device)
    return Window(step_s=step_s, window_s=seconds, attempted=attempted, failed=failed,
                  missions=mission)
